"""YOLOv8n object detection as PyTorch modules — port of the reference
package's ``models/yolov8.py``.

The network is the reference's YOLOv8n with BatchNorm folded into each
convolution (``convert.yolo_state_dict`` carries its weights across): a CSP
backbone of C2f blocks and SPPF, the PAN-FPN neck, and the decoupled
anchor-free head with DFL box regression; channels 16/32/64/128/256, C2f
depths 1 and 2, three scales (strides 8, 16, 32), 80 classes, 16 DFL bins.

Layout is NCHW with OIHW weights (the reference runs NHWC/HWIO); every
channel concat keeps the reference's order, and ``decode`` permutes to
NHWC before it splits the box channels side-major into (4, REG_MAX).

``init_params`` builds the reference's random initialisation as numpy
(drawn from a ``torch.Generator``, so not ``jax.random``'s bits).  A model
in training mode (``model.train()``, with ``requires_grad_()``) holds
float32 masters and rounds each convolution's weights to bf16 where it uses
them, as the reference's ``_conv`` under ``semantic/train.py``; in eval
mode the weights are used as they are, already bf16 values.

Rounding follows the reference's program as XLA compiles it: convolution
inputs and weights rounded to bf16, the convolution summed in float32 and
left there (XLA keeps the bf16 convolution's output in float32 — excess
precision, its default — so the output is not rounded to bf16), plus the
bias taken as float32, SiLU in float32 and the result rounded to bf16; the
head's last 1x1 convolutions stay float32 after their bias, with no
activation; DFL softmax, decode and NMS run in float32.  The convolutions
are ``F.conv2d`` in float32 (TF32 is off package-wide; cuDNN on the card):
in the reference they are XLA convolutions, not Pallas kernels.

``detect`` is static-shaped like the reference's: ``prefilter`` candidates
by best class score, then ``max_out`` rounds of class-aware select-max and
suppress, with no host read.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from slamref.core.containers import topk_stable

REG_MAX = 16          # DFL bins
NUM_CLASSES = 80
STRIDES = (8, 16, 32)
# YOLOv8n (depth 0.33, width 0.25): backbone channels and C2f depths
CHANNELS = (16, 32, 64, 128, 256)
DEPTHS = (1, 2)

BF16 = torch.bfloat16
# The activations' storage type; the benchmark's control sets it to a float8
# type, a precision below the configuration's bf16 (``round_act``).
ACT_DTYPE = torch.bfloat16


def round_act(x: torch.Tensor) -> torch.Tensor:
    """x rounded to ``ACT_DTYPE`` and held as bf16."""
    return x.to(ACT_DTYPE).to(BF16)


class Conv(nn.Module):
    """Convolution + bias with the reference's rounding points; SiLU and a
    bf16 result unless ``act`` is False (the head's last 1x1 convolutions,
    which return float32).  Weights and bias are float32 tensors: bf16
    values for inference (``convert.yolo_state_dict`` rounds them), float32
    masters in training mode, whose weights are rounded to bf16 at use (the
    bias is not, as in the reference)."""

    def __init__(self, cin: int, cout: int, k: int = 1, stride: int = 1,
                 act: bool = True):
        super().__init__()
        self.w = nn.Parameter(torch.zeros((cout, cin, k, k)),
                              requires_grad=False)
        self.b = nn.Parameter(torch.zeros(cout), requires_grad=False)
        self.stride = stride
        self.pad = (k - 1) // 2
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.w.to(BF16).to(torch.float32) if self.training else self.w
        y = F.conv2d(round_act(x).to(torch.float32), w,
                     stride=self.stride, padding=self.pad)
        y = y + self.b[:, None, None]
        if not self.act:
            return y
        return round_act(y * torch.sigmoid(y))


def yolov8n_spec() -> Dict[str, Any]:
    """Channel/depth layout for the 'n' scale."""
    return dict(channels=list(CHANNELS), n1=DEPTHS[0], n2=DEPTHS[1])


def init_params(generator: torch.Generator, num_classes: int = NUM_CLASSES
                ) -> Dict[str, Any]:
    """Random parameter tree in the reference's layout (BN folded, HWIO
    ``w``), as numpy float32 holding bf16 values: each weight normal times
    sqrt(2 / fan_in), rounded to bf16; zero biases; ``num_classes``.  The
    draws come from ``generator`` in the reference's order of layers."""
    c = CHANNELS
    n1, n2 = DEPTHS

    def conv(cin, cout, k=1):
        w = torch.randn((k, k, cin, cout), generator=generator)
        w = w * (2.0 / (cin * k * k)) ** 0.5
        return dict(w=w.to(BF16).to(torch.float32).numpy(),
                    b=np.zeros(cout, np.float32))

    def c2f(cin, cout, n):
        h = cout // 2
        return dict(
            cv1=conv(cin, cout, 1),
            cv2=conv(cout + n * h, cout, 1),
            m=[dict(cv1=conv(h, h, 3), cv2=conv(h, h, 3)) for _ in range(n)])

    params: Dict[str, Any] = dict(
        stem=conv(3, c[0], 3),
        down1=conv(c[0], c[1], 3), c2f1=c2f(c[1], c[1], n1),
        down2=conv(c[1], c[2], 3), c2f2=c2f(c[2], c[2], n2),
        down3=conv(c[2], c[3], 3), c2f3=c2f(c[3], c[3], n2),
        down4=conv(c[3], c[4], 3), c2f4=c2f(c[4], c[4], n1),
        sppf=dict(cv1=conv(c[4], c[4] // 2, 1),
                  cv2=conv(c[4] * 2, c[4], 1)),
        up_c2f1=c2f(c[4] + c[3], c[3], n1),
        up_c2f2=c2f(c[3] + c[2], c[2], n1),
        down_conv1=conv(c[2], c[2], 3),
        down_c2f1=c2f(c[2] + c[3], c[3], n1),
        down_conv2=conv(c[3], c[3], 3),
        down_c2f2=c2f(c[3] + c[4], c[4], n1),
    )
    ch_box = max(16, c[2] // 4, REG_MAX * 4)
    ch_cls = max(c[2], min(num_classes, 100))
    params["heads"] = [dict(
        box1=conv(ci, ch_box, 3), box2=conv(ch_box, ch_box, 3),
        box3=conv(ch_box, 4 * REG_MAX, 1),
        cls1=conv(ci, ch_cls, 3), cls2=conv(ch_cls, ch_cls, 3),
        cls3=conv(ch_cls, num_classes, 1)) for ci in (c[2], c[3], c[4])]
    params["num_classes"] = num_classes
    return params


class Bottleneck(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.cv1 = Conv(c, c, 3)
        self.cv2 = Conv(c, c, 3)


class C2f(nn.Module):
    """ultralytics C2f: cv2's input is [y0, y1, m1..mn] in that order; the
    bottleneck residual applies only with ``shortcut`` (backbone blocks)."""

    def __init__(self, cin: int, cout: int, n: int, shortcut: bool):
        super().__init__()
        h = cout // 2
        self.cv1 = Conv(cin, cout)
        self.cv2 = Conv(cout + n * h, cout)
        self.m = nn.ModuleList(Bottleneck(h) for _ in range(n))
        self.shortcut = shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        h = y.shape[1] // 2
        parts = [y[:, :h], y[:, h:]]
        for m in self.m:
            z = m.cv2(m.cv1(parts[-1]))
            parts.append(parts[-1] + z if self.shortcut else z)
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.cv1 = Conv(c, c // 2)
        self.cv2 = Conv(c * 2, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pools = [self.cv1(x)]
        for _ in range(3):
            # 5x5 stride-1 max with -inf padding (the reference's "SAME"
            # reduce_window)
            pools.append(F.max_pool2d(pools[-1], 5, stride=1, padding=2))
        return self.cv2(torch.cat(pools, dim=1))


class Head(nn.Module):
    def __init__(self, cin: int, ch_box: int, ch_cls: int, num_classes: int):
        super().__init__()
        self.box1 = Conv(cin, ch_box, 3)
        self.box2 = Conv(ch_box, ch_box, 3)
        self.box3 = Conv(ch_box, 4 * REG_MAX, act=False)
        self.cls1 = Conv(cin, ch_cls, 3)
        self.cls2 = Conv(ch_cls, ch_cls, 3)
        self.cls3 = Conv(ch_cls, num_classes, act=False)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        box = self.box3(self.box2(self.box1(x)))
        cls = self.cls3(self.cls2(self.cls1(x)))
        return box, cls


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class YOLOv8(nn.Module):
    """YOLOv8n; parameter names follow the reference's parameter tree
    (``stem.w``, ``c2f1.m.0.cv1.b``, ``heads.2.cls3.w``, ...)."""

    def __init__(self, num_classes: int = NUM_CLASSES):
        super().__init__()
        c = CHANNELS
        n1, n2 = DEPTHS
        self.num_classes = num_classes
        self.stem = Conv(3, c[0], 3, 2)
        self.down1 = Conv(c[0], c[1], 3, 2)
        self.c2f1 = C2f(c[1], c[1], n1, True)
        self.down2 = Conv(c[1], c[2], 3, 2)
        self.c2f2 = C2f(c[2], c[2], n2, True)
        self.down3 = Conv(c[2], c[3], 3, 2)
        self.c2f3 = C2f(c[3], c[3], n2, True)
        self.down4 = Conv(c[3], c[4], 3, 2)
        self.c2f4 = C2f(c[4], c[4], n1, True)
        self.sppf = SPPF(c[4])
        self.up_c2f1 = C2f(c[4] + c[3], c[3], n1, False)
        self.up_c2f2 = C2f(c[3] + c[2], c[2], n1, False)
        self.down_conv1 = Conv(c[2], c[2], 3, 2)
        self.down_c2f1 = C2f(c[2] + c[3], c[3], n1, False)
        self.down_conv2 = Conv(c[3], c[3], 3, 2)
        self.down_c2f2 = C2f(c[3] + c[4], c[4], n1, False)
        ch_box = max(16, c[2] // 4, REG_MAX * 4)
        ch_cls = max(c[2], min(num_classes, 100))
        self.heads = nn.ModuleList(Head(ci, ch_box, ch_cls, num_classes)
                                   for ci in (c[2], c[3], c[4]))

    def forward(self, img: torch.Tensor
                ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """img: (N, 3, H, W) float32 in [0, 1] → per scale (box logits
        (N, 64, h, w), class logits (N, C, h, w)), both float32."""
        x = self.down1(self.stem(img))
        x = self.c2f1(x)
        p3 = self.c2f2(self.down2(x))                       # stride 8
        p4 = self.c2f3(self.down3(p3))                      # stride 16
        p5 = self.sppf(self.c2f4(self.down4(p4)))           # stride 32
        u4 = self.up_c2f1(torch.cat([_upsample2(p5), p4], dim=1))
        u3 = self.up_c2f2(torch.cat([_upsample2(u4), p3], dim=1))
        d4 = self.down_c2f1(torch.cat([self.down_conv1(u3), u4], dim=1))
        d5 = self.down_c2f2(torch.cat([self.down_conv2(d4), p5], dim=1))
        return [head(x) for head, x in zip(self.heads, (u3, d4, d5))]


class RawDetections(NamedTuple):
    boxes: torch.Tensor     # (D, 4) xyxy in input pixels
    scores: torch.Tensor    # (D,)
    classes: torch.Tensor   # (D,) int64
    valid: torch.Tensor     # (D,) bool


def decode_batch(outputs) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-scale head outputs (NCHW) → (boxes (N, A, 4) xyxy, class scores
    (N, A, C)), anchors in the reference's order (scale, row, column)."""
    boxes_all, cls_all = [], []
    for (box, cls), stride in zip(outputs, STRIDES):
        box = box.permute(0, 2, 3, 1)                       # NHWC
        cls = cls.permute(0, 2, 3, 1)
        n, h, w, _ = box.shape
        dev = box.device
        dfl = box.reshape(n, h, w, 4, REG_MAX)
        bins = torch.arange(REG_MAX, dtype=torch.float32, device=dev)
        dist = torch.sum(torch.softmax(dfl, dim=-1) * bins, dim=-1)
        cy, cx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=dev) + 0.5,
            torch.arange(w, dtype=torch.float32, device=dev) + 0.5,
            indexing="ij")
        x1 = (cx - dist[..., 0]) * stride
        y1 = (cy - dist[..., 1]) * stride
        x2 = (cx + dist[..., 2]) * stride
        y2 = (cy + dist[..., 3]) * stride
        boxes_all.append(torch.stack([x1, y1, x2, y2], -1).reshape(n, -1, 4))
        cls_all.append(torch.sigmoid(cls).reshape(n, -1, cls.shape[-1]))
    return torch.cat(boxes_all, dim=1), torch.cat(cls_all, dim=1)


def decode(outputs) -> Tuple[torch.Tensor, torch.Tensor]:
    """``decode_batch`` of the first image: (boxes (A, 4), scores (A, C))."""
    boxes, cls = decode_batch(outputs)
    return boxes[0], cls[0]


def _iou(box: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """box (1, 4) against boxes (P, 4) → (P,)."""
    x1 = torch.maximum(box[:, 0], boxes[:, 0])
    y1 = torch.maximum(box[:, 1], boxes[:, 1])
    x2 = torch.minimum(box[:, 2], boxes[:, 2])
    y2 = torch.minimum(box[:, 3], boxes[:, 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    a1 = torch.clamp(box[:, 2] - box[:, 0], min=0) * \
        torch.clamp(box[:, 3] - box[:, 1], min=0)
    a2 = torch.clamp(boxes[:, 2] - boxes[:, 0], min=0) * \
        torch.clamp(boxes[:, 3] - boxes[:, 1], min=0)
    return inter / torch.clamp(a1 + a2 - inter, min=1e-9)


def nms(boxes: torch.Tensor, cls_scores: torch.Tensor, max_out: int,
        score_thr: float = 0.25, iou_thr: float = 0.45,
        prefilter: int = 256) -> RawDetections:
    """Class-aware NMS with static shapes: the top ``prefilter`` candidates
    by best class score (ties to the lower index, as ``lax.top_k``), then
    ``max_out`` rounds of select-max (first index among equals) and
    suppress.  A round with nothing alive emits an invalid row."""
    best_cls = torch.argmax(cls_scores, dim=1)
    best_score = torch.amax(cls_scores, dim=1)
    prefilter = min(prefilter, best_score.shape[0])
    top_score, top_idx = topk_stable(best_score, prefilter)
    cand_boxes = boxes[top_idx]
    cand_cls = best_cls[top_idx]
    alive = top_score >= score_thr
    ar = torch.arange(prefilter, device=boxes.device)
    neg = torch.full_like(top_score, -1.0)
    sel, ok = [], []
    for _ in range(max_out):
        s = torch.where(alive, top_score, neg)
        i = torch.argmax(s).reshape(1)
        sel.append(i)
        ok.append(s[i] > 0)
        sup = (_iou(cand_boxes[i], cand_boxes) > iou_thr) & \
            (cand_cls == cand_cls[i])
        alive = alive & ~sup & (ar != i)
    idx = torch.cat(sel)
    return RawDetections(boxes=cand_boxes[idx], scores=top_score[idx],
                         classes=cand_cls[idx], valid=torch.cat(ok))


@torch.no_grad()
def detect(model: YOLOv8, img: torch.Tensor, max_out: int = 32,
           score_thr: float = 0.25, iou_thr: float = 0.45) -> RawDetections:
    """img: (S, S, 3) float32 in [0, 1] on the model's device (S the input
    size) → detections in input pixels."""
    outs = model(img.permute(2, 0, 1)[None])
    boxes, cls_scores = decode(outs)
    return nms(boxes, cls_scores, max_out, score_thr, iou_thr)


@torch.no_grad()
def detect_batch(model: YOLOv8, imgs: torch.Tensor, max_out: int = 32,
                 score_thr: float = 0.25, iou_thr: float = 0.45
                 ) -> RawDetections:
    """imgs: (N, S, S, 3) float32 in [0, 1] → detections with a leading
    dim N: one forward for all N images, then ``nms`` on each, vmapped."""
    boxes, cls_scores = decode_batch(model(imgs.permute(0, 3, 1, 2)))
    return torch.func.vmap(lambda b, c: nms(b, c, max_out, score_thr,
                                            iou_thr))(boxes, cls_scores)
