"""Train the YOLOv8n detector on the synthetic dynamic world — port of the
reference package's ``semantic/train.py``.

The synthetic renderer (``io/synthetic.py``) gives unlimited labelled
dynamic scenes with exact walker boxes, and the same ``models/yolov8.py``
network the pipeline runs for inference is trained on them, so no
pretrained weights are needed.

Formulation (the reference's, anchor-free as YOLOv8's head):
- FCOS-style assignment: an anchor point is positive for a ground-truth box
  when it lies inside it, within 2.5 strides of its centre, and the box is
  representable at that scale (largest side distance below REG_MAX - 1
  strides); an anchor that several boxes claim takes the smallest.
- Class loss: sigmoid BCE over every anchor and class, target 1 for the
  person class (COCO 0) at positives, so trained weights drop into the
  pipeline unchanged.
- Box loss on positives: Distribution Focal Loss on each side's bins plus
  1 - IoU of the decoded boxes (the inference decode).
- Total: 0.5 · class + 1.5 · DFL + 5 · IoU.

The port's heads are NCHW; ``_flatten_outputs`` permutes them to NHWC
before flattening, so anchors come in the reference's order (scale, row,
column).  ``train`` runs ``torch.optim.AdamW`` with optax's defaults and
semantics (``OptaxAdamW``): the gradients clipped to global norm 10 as
``optax.clip_by_global_norm`` does (``g / norm * 10`` when the norm is 10
or more), decoupled weight decay 1e-5 on every parameter, biases included,
scaled by the learning rate, and the rate from
``optax.cosine_decay_schedule(lr, steps, alpha=0.05)`` at the step count
before the update.  The model trains in training mode: float32 masters,
each convolution's weights rounded to bf16 where they are used, and a step
runs cuDNN's deterministic algorithms, so training from the same images and
initialisation gives the same weights bit for bit (cuDNN's default weight
gradients sum in an order that changes between calls); ``train``
returns the reference's parameter tree with every value rounded to bf16,
loadable by ``YoloDetector(params=...)`` and, through
``models/convert_ultralytics.save_params``, by both packages.  The pool of
training images lives on the device and batches are gathered by index.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import math
import multiprocessing
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dynamic_visual_slam_tpu_torch import convert
from dynamic_visual_slam_tpu_torch.config import CameraConfig, SLAMConfig
from dynamic_visual_slam_tpu_torch.io import synthetic, trajectory
from dynamic_visual_slam_tpu_torch.models import yolov8
from dynamic_visual_slam_tpu_torch.models.convert_ultralytics import (
    round_bf16)
from dynamic_visual_slam_tpu_torch.models.yolov8 import REG_MAX, STRIDES
from dynamic_visual_slam_tpu_torch.pipeline.slam import (SLAMSystem,
                                                         resolve_device)
from dynamic_visual_slam_tpu_torch.semantic.detector import (
    YoloDetector, boxes_to_detections, build_model, letterbox)

PERSON_CLASS = 0           # COCO id of "person" (semantic/classes.py)
MAX_GT = 8                 # padded ground-truth boxes an image
CLIP_NORM = 10.0           # the optimizer: global-norm clip,
WEIGHT_DECAY = 1e-5        # decoupled weight decay,
LR_ALPHA = 0.05            # and the cosine schedule's final fraction
# time horizon render_pool samples scene times from: long enough for
# vz/stop_go walkers to traverse their scale and position range, short
# enough that x/y velocities keep walkers near the view for most samples
_POOL_TS_MAX = 8.0
# the pool's camera (the reference's)
POOL_CAMERA = CameraConfig(width=320, height=240, fx=260.0, fy=260.0,
                           cx=159.5, cy=119.5)
# a pool of more scenes than this renders in worker processes: a spawned
# worker takes seconds to start, a scene (three images) about one to render
_SERIAL_SCENES = 8


# ---------------------------------------------------------------------------
# Data: rendered dynamic frames → letterboxed training examples
# ---------------------------------------------------------------------------

def letterbox_np(gray: np.ndarray, size: int
                 ) -> Tuple[np.ndarray, float, Tuple[int, int]]:
    """(H, W) gray → ((S, S, 3) float32 in [0, 1], scale, (pad_x, pad_y)):
    the runtime detector's letterbox (``semantic/detector.letterbox``, on
    the CPU), so training images are what the detector sees."""
    canvas, scale, pad = letterbox(np.asarray(gray)[..., None], size, "cpu")
    return canvas.numpy(), scale, pad


def _scale_boxes(boxes: np.ndarray, scale: float, pad: Tuple[int, int]
                 ) -> np.ndarray:
    if len(boxes) == 0:
        return boxes.reshape(0, 4)
    b = boxes * scale
    b[:, [0, 2]] += pad[0]
    b[:, [1, 3]] += pad[1]
    return b


def _random_walkers(rng: np.random.Generator, n: int
                    ) -> Tuple[synthetic.MovingObject, ...]:
    """Randomised walkers (the reference's family): depth z in (0.6, 2.6)
    m; half of them approach or recede (vz clamped so they stay within
    (0.5, 2.9) m over the sampled time horizon); about a third walk
    stop-and-go; varied start, speed, size and texture."""
    objs = []
    for _ in range(n):
        z = float(rng.uniform(0.6, 2.6))
        vz = 0.0
        if rng.uniform() < 0.5:
            vz_lo = max(-0.14, (0.5 - z) / _POOL_TS_MAX)
            vz_hi = min(0.07, (2.9 - z) / _POOL_TS_MAX)
            vz = float(rng.uniform(vz_lo, vz_hi))
        stop_go = None
        if rng.uniform() < 0.35:
            stop_go = (float(rng.uniform(0.8, 2.4)),
                       float(rng.uniform(0.3, 0.8)))
        objs.append(synthetic.MovingObject(
            z=z,
            center0=(float(rng.uniform(-0.8, 0.8)),
                     float(rng.uniform(-0.3, 0.3))),
            velocity=(float(rng.uniform(-0.3, 0.3)),
                      float(rng.uniform(-0.05, 0.05))),
            half_size=(float(rng.uniform(0.10, 0.32)),
                       float(rng.uniform(0.20, 0.48))),
            tex_id=int(rng.integers(5, 60)),
            vz=vz, stop_go=stop_go))
    return tuple(objs)


def pool_plan(n_images: int, seed: int) -> List[tuple]:
    """The pool's random draws, in the reference's order: a list of scenes
    (scene seed, walkers, trajectory seed, [(pose index, time, flip), ...]),
    three spread-out frames a scene."""
    rng = np.random.default_rng(seed)
    scenes = []
    i = 0
    while i < n_images:
        n_obj = int(rng.integers(0, 5))      # up to 4: occlusion pressure
        scene_seed = int(rng.integers(0, 10_000))
        objs = _random_walkers(rng, n_obj)
        pose_seed = int(rng.integers(0, 10_000))
        shots = []
        for j in range(0, 24, 8):
            if i >= n_images:
                break
            ts = float(rng.uniform(0.0, _POOL_TS_MAX))
            shots.append((j, ts, bool(rng.uniform() < 0.5)))
            i += 1
        scenes.append((scene_seed, objs, pose_seed, shots))
    return scenes


def _render_serial(cam: CameraConfig, input_size: int, scenes: Sequence
                   ) -> List[Tuple[np.ndarray, np.ndarray]]:
    out = []
    for scene_seed, objs, pose_seed, shots in scenes:
        scene = synthetic.SyntheticScene(cam, seed=scene_seed, objects=objs)
        poses = synthetic.orbit_trajectory(24, seed=pose_seed)
        for j, ts, flip in shots:
            r, t = poses[j]
            gray, _ = scene.render(r, t, t_s=ts)
            bb = scene.object_bboxes(r, t, ts)
            img, sc, pad = letterbox_np(gray, input_size)
            bb = _scale_boxes(bb, sc, pad)
            if flip:                         # horizontal flip augmentation
                img = img[:, ::-1].copy()
                if len(bb):
                    x1 = input_size - 1.0 - bb[:, 2].copy()
                    x2 = input_size - 1.0 - bb[:, 0].copy()
                    bb[:, 0], bb[:, 2] = x1, x2
            out.append((img, bb))
    return out


def render_scenes(cam: CameraConfig, input_size: int, scenes: Sequence,
                  workers: int = 0) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The images of ``scenes`` (``pool_plan``'s list): (letterboxed (S,
    S, 3) float32, boxes (K, 4) in input pixels) each.  With ``workers`` >
    0 the scenes render in that many spawned processes; the images are the
    serial render's (``workers`` 0)."""
    if workers > 0 and len(scenes) > 1:
        k = min(workers, len(scenes))
        cuts = [len(scenes) * j // k for j in range(k + 1)]
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(k, mp_context=ctx) as ex:
            parts = list(ex.map(_render_serial, [cam] * k, [input_size] * k,
                                [scenes[a:b] for a, b in zip(cuts, cuts[1:])]))
        return [x for part in parts for x in part]
    return _render_serial(cam, input_size, scenes)


def render_pool(n_images: int, input_size: int = 256, seed: int = 0,
                camera: Optional[CameraConfig] = None
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side dataset: (imgs (N, S, S, 3) float32, boxes (N, MAX_GT, 4)
    in input pixels, mask (N, MAX_GT) bool).  Each image is a random
    viewpoint of a random-seeded scene with 0 to 4 random walkers,
    letterboxed as the runtime detector letterboxes camera frames.  The
    draws are made first, in the reference's order; a pool of more than
    ``_SERIAL_SCENES`` scenes renders in min(8, CPU count) spawned
    processes (``render_scenes``)."""
    scenes = pool_plan(n_images, seed)
    workers = 0 if len(scenes) <= _SERIAL_SCENES \
        else min(8, os.cpu_count() or 1)
    rendered = render_scenes(camera or POOL_CAMERA, input_size, scenes,
                             workers)
    imgs = np.zeros((n_images, input_size, input_size, 3), np.float32)
    boxes = np.zeros((n_images, MAX_GT, 4), np.float32)
    mask = np.zeros((n_images, MAX_GT), bool)
    for i, (img, bb) in enumerate(rendered):
        k = min(len(bb), MAX_GT)
        imgs[i] = img
        boxes[i, :k] = bb[:k]
        mask[i, :k] = True
    return imgs, boxes, mask


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _anchor_grid(input_size: int, device: Any = "cpu"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every anchor point's centre across the three scales → ((A, 2)
    float32 (x, y) in input pixels, (A,) float32 stride of each)."""
    dev = torch.device(device)
    pts, strides = [], []
    for s in STRIDES:
        h = w = input_size // s
        cy, cx = torch.meshgrid(
            (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) * s,
            (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) * s,
            indexing="ij")
        pts.append(torch.stack([cx, cy], -1).reshape(-1, 2))
        strides.append(torch.full((h * w,), float(s), device=dev))
    return torch.cat(pts), torch.cat(strides)


def _flatten_outputs(outs) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-scale head outputs (NCHW) → (N, A, 4·REG_MAX) box logits and
    (N, A, C) class logits, anchors in the reference's NHWC order."""
    bs, cs = [], []
    for box, cls in outs:
        n = box.shape[0]
        bs.append(box.permute(0, 2, 3, 1).reshape(n, -1, 4 * REG_MAX))
        cs.append(cls.permute(0, 2, 3, 1).reshape(n, -1, cls.shape[1]))
    return torch.cat(bs, 1), torch.cat(cs, 1)


def _assign(points: torch.Tensor, strides: torch.Tensor, gt: torch.Tensor,
            gt_mask: torch.Tensor, center_radius: float = 2.5
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FCOS-style assignment: ground truth (..., K, 4) and its mask
    (..., K) → ((..., A) int64 index of the matched box, the smallest
    among the candidates; (..., A) bool positive mask)."""
    x, y = points[:, 0:1], points[:, 1:2]                        # (A, 1)
    g = gt[..., None, :, :]                                  # (..., 1, K, 4)
    l = x - g[..., 0]                                            # (..., A, K)
    t = y - g[..., 1]
    r = g[..., 2] - x
    b = g[..., 3] - y
    inside = torch.minimum(torch.minimum(l, t), torch.minimum(r, b)) > 0
    dmax = torch.maximum(torch.maximum(l, t), torch.maximum(r, b))
    fits = dmax < (REG_MAX - 1) * strides[:, None]
    cxk = (g[..., 0] + g[..., 2]) * 0.5
    cyk = (g[..., 1] + g[..., 3]) * 0.5
    near = ((x - cxk).abs() < center_radius * strides[:, None]) \
        & ((y - cyk).abs() < center_radius * strides[:, None])
    cand = inside & fits & near & gt_mask[..., None, :]
    area = (gt[..., 2] - gt[..., 0]) * (gt[..., 3] - gt[..., 1])
    cost = torch.where(cand, area[..., None, :], torch.inf)
    return torch.argmin(cost, dim=-1), cand.any(-1)


def _dfl_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Distribution Focal Loss of one side-distance set: logits (...,
    REG_MAX), continuous target in [0, REG_MAX - 1] → cross-entropy against
    the two adjacent integer bins, weighted by proximity."""
    tl = torch.clamp(torch.floor(target), 0, REG_MAX - 2)
    wr = target - tl
    logp = torch.log_softmax(logits, dim=-1)
    il = tl.to(torch.int64)[..., None]
    pl = torch.gather(logp, -1, il)[..., 0]
    pr = torch.gather(logp, -1, il + 1)[..., 0]
    return -(pl * (1.0 - wr) + pr * wr)


def sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid binary cross-entropy."""
    return torch.maximum(logits, torch.zeros_like(logits)) \
        - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def detection_loss(model: yolov8.YOLOv8, imgs: torch.Tensor,
                   gt_boxes: torch.Tensor, gt_mask: torch.Tensor,
                   input_size: int) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Total detection loss of a batch, imgs (N, S, S, 3) float32 in [0, 1];
    the aux dict holds the components (``cls``, ``dfl``, ``iou``,
    ``n_pos``)."""
    outs = model(imgs.permute(0, 3, 1, 2))
    box_logits, cls_logits = _flatten_outputs(outs)      # (N,A,64), (N,A,C)
    points, strides = _anchor_grid(input_size, imgs.device)
    gt_idx, pos = _assign(points, strides, gt_boxes, gt_mask)   # (N, A)
    posf = pos.to(torch.float32)
    n_pos = torch.clamp(posf.sum(), min=1.0)

    # class BCE: target 1 at (positive anchor, person), else 0
    cls_tgt = torch.zeros_like(cls_logits)
    cls_tgt[..., PERSON_CLASS] = posf
    cls_loss = sigmoid_bce(cls_logits, cls_tgt).sum() / n_pos

    # box losses on positives
    g = torch.gather(gt_boxes, 1, gt_idx[..., None].expand(-1, -1, 4))
    px, py = points[None, :, 0], points[None, :, 1]
    l = (px - g[..., 0]) / strides[None]
    t = (py - g[..., 1]) / strides[None]
    r = (g[..., 2] - px) / strides[None]
    b = (g[..., 3] - py) / strides[None]
    tgt = torch.clamp(torch.stack([l, t, r, b], -1), 0.0,
                      REG_MAX - 1 - 1e-3)
    bins_logits = box_logits.reshape(*box_logits.shape[:-1], 4, REG_MAX)
    dfl = _dfl_loss(bins_logits, tgt)                     # (N, A, 4)
    zero = torch.zeros((), device=imgs.device)
    dfl_loss = torch.where(pos[..., None], dfl, zero).sum() / (4.0 * n_pos)

    # IoU of the decoded boxes (the inference decode: expected bin value)
    bins = torch.arange(REG_MAX, dtype=torch.float32, device=imgs.device)
    dist = (torch.softmax(bins_logits, -1) * bins).sum(-1) \
        * strides[None, :, None]                          # (N, A, 4) px
    px1 = px - dist[..., 0]
    py1 = py - dist[..., 1]
    px2 = px + dist[..., 2]
    py2 = py + dist[..., 3]
    ix1 = torch.maximum(px1, g[..., 0])
    iy1 = torch.maximum(py1, g[..., 1])
    ix2 = torch.minimum(px2, g[..., 2])
    iy2 = torch.minimum(py2, g[..., 3])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    a_p = torch.clamp(px2 - px1, min=0) * torch.clamp(py2 - py1, min=0)
    a_g = (g[..., 2] - g[..., 0]) * (g[..., 3] - g[..., 1])
    iou = inter / torch.clamp(a_p + a_g - inter, min=1e-9)
    iou_loss = torch.where(pos, 1.0 - iou, zero).sum() / n_pos

    total = 0.5 * cls_loss + 1.5 * dfl_loss + 5.0 * iou_loss
    return total, dict(cls=cls_loss, dfl=dfl_loss, iou=iou_loss,
                       n_pos=n_pos)


# ---------------------------------------------------------------------------
# Optimizer: optax's chain on torch.optim.AdamW
# ---------------------------------------------------------------------------

def cosine_decay(lr: float, steps: int, alpha: float, count: int) -> float:
    """``optax.cosine_decay_schedule(lr, steps, alpha)`` at ``count``."""
    c = min(count, steps)
    return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / steps))
                 + alpha)


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float
                         ) -> torch.Tensor:
    """``optax.clip_by_global_norm``, in place: gradients unchanged when
    their global norm is below ``max_norm``, else ``g / norm * max_norm``
    (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm).  No host
    read.  → the norm."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    below = norm < max_norm
    one = torch.ones((), device=norm.device)
    torch._foreach_div_(grads, torch.where(below, one, norm))
    torch._foreach_mul_(grads, torch.where(below, one, one * max_norm))
    return norm


class OptaxAdamW:
    """The reference's optimizer, ``optax.chain(clip_by_global_norm(10),
    adamw(cosine_decay_schedule(lr, steps, alpha=0.05),
    weight_decay=1e-5))`` with optax's defaults (b1 0.9, b2 0.999, eps
    1e-8), on ``torch.optim.AdamW``: its decoupled decay
    ``p · (1 - lr · wd)`` is optax's ``- lr · wd · p`` on every parameter,
    and the schedule is read at the update count before the update."""

    def __init__(self, params, lr: float, steps: int):
        self.params = list(params)
        self.opt = torch.optim.AdamW(self.params, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=WEIGHT_DECAY)
        self.lr, self.steps = lr, steps
        self.count = 0

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        clip_by_global_norm_([p.grad for p in self.params], CLIP_NORM)
        for group in self.opt.param_groups:
            group["lr"] = cosine_decay(self.lr, self.steps, LR_ALPHA,
                                       self.count)
        self.opt.step()
        self.count += 1


# ---------------------------------------------------------------------------
# Training loop
# ---------------------------------------------------------------------------

def trainable_model(params: Dict[str, Any], device) -> yolov8.YOLOv8:
    """YOLOv8 in training mode on ``device`` with float32 masters from the
    reference's parameter tree (numpy), every parameter requiring grad."""
    model = yolov8.YOLOv8(int(params["heads"][0]["cls3"]["b"].shape[0]))
    model.load_state_dict(convert.yolo_state_dict(params, torch.float32))
    return model.to(device).train().requires_grad_(True)


def deterministic_convolutions():
    """A context in which cuDNN runs only deterministic algorithms (TF32
    stays off, as package-wide): the forward and backward of a training
    step then repeat bit for bit on the card."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


def train_step(model: yolov8.YOLOv8, opt: OptaxAdamW, imgs: torch.Tensor,
               boxes: torch.Tensor, mask: torch.Tensor, input_size: int
               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One update on a batch, its convolutions deterministic; → (loss,
    aux), on the device (no host read)."""
    opt.zero_grad()
    with deterministic_convolutions():
        loss, aux = detection_loss(model, imgs, boxes, mask, input_size)
        loss.backward()
    opt.step()
    return loss.detach(), {k: v.detach() for k, v in aux.items()}


def train(steps: int = 1500, batch: int = 16, input_size: int = 256,
          pool_images: int = 384, lr: float = 1e-3, seed: int = 0,
          params: Optional[Dict[str, Any]] = None,
          log_every: int = 100, verbose: bool = True, device: Any = "cuda"
          ) -> Tuple[Dict[str, Any], List[float]]:
    """Train YOLOv8n on the synthetic dynamic world on ``device`` (from
    ``params``, else ``yolov8.init_params`` of ``seed``); → (inference
    parameter tree, numpy with bf16 values and ``num_classes``; the loss
    every ``log_every`` steps and at the last)."""
    dev = resolve_device(device)
    if verbose:
        print(f"rendering {pool_images} training images "
              f"(S={input_size}) ...", flush=True)
    imgs, boxes, mask = render_pool(pool_images, input_size, seed=seed)
    if params is None:
        params = yolov8.init_params(torch.Generator().manual_seed(seed))
    model = trainable_model(params, dev)
    opt = OptaxAdamW(model.parameters(), lr, steps)
    imgs_d = torch.from_numpy(imgs).to(dev)
    boxes_d = torch.from_numpy(boxes).to(dev)
    mask_d = torch.from_numpy(mask).to(dev)

    rng = np.random.default_rng(seed + 1)
    history: List[float] = []
    for it in range(steps):
        idx = torch.from_numpy(rng.integers(0, pool_images, batch)).to(dev)
        loss, aux = train_step(model, opt, imgs_d[idx], boxes_d[idx],
                               mask_d[idx], input_size)
        if it % log_every == 0 or it == steps - 1:
            history.append(float(loss))
            if verbose:
                print(f"step {it:5d}  loss {history[-1]:7.4f}  "
                      f"cls {float(aux['cls']):6.4f} "
                      f"dfl {float(aux['dfl']):6.4f} "
                      f"iou {float(aux['iou']):6.4f} "
                      f"pos {float(aux['n_pos']) / batch:5.1f}", flush=True)
    return round_bf16(convert.yolo_params(model.state_dict())), history


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

def evaluate(params: Dict[str, Any], input_size: int = 256,
             n_images: int = 48, seed: int = 99, score_thr: float = 0.25,
             iou_match: float = 0.5, device: Any = "cuda"
             ) -> Dict[str, float]:
    """Held-out detection quality on ``device``: mean best IoU a
    ground-truth box, recall and precision at IoU ``iou_match`` (person
    class only), 16 detections an image."""
    imgs, boxes, mask = render_pool(n_images, input_size, seed=seed)
    return evaluate_pool(params, imgs, boxes, mask, score_thr, iou_match,
                         device)


def evaluate_pool(params: Dict[str, Any], imgs: np.ndarray,
                  boxes: np.ndarray, mask: np.ndarray, score_thr: float = 0.25,
                  iou_match: float = 0.5, device: Any = "cuda"
                  ) -> Dict[str, float]:
    """``evaluate`` on a rendered pool (``render_pool``'s three arrays)."""
    dev = resolve_device(device)
    n_images = len(imgs)
    model = build_model(params, dev)
    raws = []
    for a in range(0, n_images, 16):
        raw = yolov8.detect_batch(model, torch.from_numpy(
            imgs[a:a + 16]).to(dev), 16, score_thr)
        raws.append([t.cpu().numpy() for t in raw])
    db_all, _, cls_all, valid_all = (np.concatenate(x) for x in zip(*raws))
    best_ious, n_gt, n_hit, n_det, n_tp = [], 0, 0, 0, 0
    for i in range(n_images):
        db = db_all[i]
        dv = valid_all[i] & (cls_all[i] == PERSON_CLASS)
        gb = boxes[i][mask[i]]
        n_gt += len(gb)
        n_det += int(dv.sum())
        matched_det = np.zeros(len(db), bool)
        for g in gb:
            ious = _iou_np(g, db)
            ious[~dv] = 0.0
            j = int(np.argmax(ious))
            best_ious.append(float(ious[j]))
            if ious[j] >= iou_match:
                n_hit += 1
                if not matched_det[j]:
                    n_tp += 1
                    matched_det[j] = True
    return dict(
        mean_best_iou=float(np.mean(best_ious)) if best_ious else 0.0,
        recall=n_hit / max(n_gt, 1),
        precision=n_tp / max(n_det, 1),
        n_gt=n_gt, n_detections=n_det)


def in_loop_eval(params: Dict[str, Any], n_frames: int = 180, seed: int = 0,
                 width: int = 320, height: int = 240,
                 conditions: Tuple[str, ...] = ("off", "gt", "learned"),
                 semantic_overrides: Optional[Dict[str, Any]] = None,
                 objects=None, verbose: bool = True, device: Any = "cuda"
                 ) -> Dict[str, Dict[str, Any]]:
    """Detector-in-the-loop efficacy: the same dynamic walker sequence
    through ``SLAMSystem.process`` with culling off, with ground-truth
    boxes and with the learned detector (``params``), each reporting ATE
    and the landmarks inside the walkers' swept volume (the map aligned
    onto the ground truth first, as ATE aligns it).  'learned' should land
    near 'gt', both below 'off'.

    Each condition reports the reference's figures (``ate_m``,
    ``walker_landmarks_confirmed`` (n_obs >= 2), ``walker_landmarks_any``,
    ``landmarks``, ``keyframes``; ``detections_total`` for 'learned') and
    the port's ``person_landmarks`` (landmarks of the person category,
    which culling must leave at 0).  ``objects``
    overrides the walkers (``synthetic.hard_walkers(n)`` for the
    out-of-distribution run)."""
    cam = CameraConfig(width=width, height=height,
                       fx=260.0 * width / 320.0, fy=260.0 * width / 320.0,
                       cx=(width - 1) / 2.0, cy=(height - 1) / 2.0)
    cfg = SLAMConfig().replace(camera=cam)
    if semantic_overrides:
        cfg = cfg.replace(semantic=dataclasses.replace(
            cfg.semantic, **semantic_overrides))
    objs = objects if objects is not None \
        else synthetic.default_walkers(n_frames)
    frames = list(synthetic.generate_dynamic_sequence(
        cam, n_frames, seed=seed, objects=objs, depth_noise=0.004))
    gt_t = np.stack([f[3] for f in frames])
    dur = n_frames / 30.0
    cap = cfg.semantic.max_detections

    detector = None
    if "learned" in conditions:
        detector = YoloDetector(cfg, params=dict(params), device=device)

    results: Dict[str, Dict[str, Any]] = {}
    for cond in conditions:
        slam = SLAMSystem(cfg, ba_async=False,
                          enable_place_recognition=False, device=device)
        n_det_boxes = 0
        for gray, depth, _, _, ts, boxes in frames:
            if cond == "gt":
                det = boxes_to_detections(boxes, cap, device=device)
            elif cond == "learned":
                det = detector(np.stack([gray] * 3, axis=-1))
                n_det_boxes += int(det.mask.sum())
            else:
                det = None
            slam.process(gray, depth, ts, detections=det)
        slam.finalize()
        _, _, est_t = slam.frontend_trajectory()
        lms = slam.landmarks_world()
        confirmed, anywhere = walker_landmarks(est_t, gt_t, lms["xyz"],
                                               lms["n_obs"], objs, dur)
        results[cond] = dict(
            ate_m=round(float(trajectory.ate_rmse(est_t, gt_t)), 5),
            walker_landmarks_confirmed=confirmed,
            walker_landmarks_any=anywhere,
            landmarks=int(len(lms["xyz"])),
            keyframes=slam.stats["keyframes"],
            person_landmarks=int(np.sum(lms["category"] == 1)))
        if cond == "learned":
            results[cond]["detections_total"] = n_det_boxes
        if verbose:
            print(f"in-loop [{cond:7s}] {results[cond]}", flush=True)
    return results


def walker_landmarks(est_t, gt_t, xyz, n_obs, objects, duration_s
                     ) -> Tuple[int, int]:
    """Landmarks inside a walker's swept volume → (confirmed ones, with
    n_obs >= 2; all).  The landmarks live in the estimated world frame and
    the volumes in the true one, so the map is first aligned onto the
    ground truth by the rigid alignment ATE uses (unaligned, a run with
    decimetre ATE counts misplaced static landmarks as walker hits)."""
    r, t = trajectory.umeyama_alignment(np.asarray(est_t, np.float64),
                                        np.asarray(gt_t, np.float64))
    hits = synthetic.walker_swept_hits(
        np.asarray(xyz, np.float64) @ r.T + t, objects, duration_s)
    return int(np.sum(hits & (np.asarray(n_obs) >= 2))), int(np.sum(hits))


def _iou_np(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    if len(boxes) == 0:
        return np.zeros(0, np.float32)
    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])
    inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    a1 = max(box[2] - box[0], 0) * max(box[3] - box[1], 0)
    a2 = np.maximum(boxes[:, 2] - boxes[:, 0], 0) \
        * np.maximum(boxes[:, 3] - boxes[:, 1], 0)
    return inter / np.maximum(a1 + a2 - inter, 1e-9)
