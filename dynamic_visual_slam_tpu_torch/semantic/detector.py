"""Pipeline-facing detector: YOLOv8 inference → mapping.Detections.

Port of the reference package's ``semantic/detector.py``: letterbox the RGB
frame to the network size, run the detector, undo the letterbox on the
boxes, shift class ids by +1 (id 0 is the 'unlabeled' category,
semantic/classes.py), then the host-side post-processing (box margin and
the velocity-extrapolated box tracks), copied from the reference.

The network runs on the detector's device (``"cuda"`` unless the caller
asks for the CPU; no quiet fallback) and the Detections come back on it;
each frame makes one host read, the detector's boxes for the
post-processing, as the reference's.
"""

from __future__ import annotations

import functools
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from dynamic_visual_slam_tpu_torch.backend.mapping import Detections
from dynamic_visual_slam_tpu_torch.config import SLAMConfig
from dynamic_visual_slam_tpu_torch.models import yolov8
from dynamic_visual_slam_tpu_torch.pipeline.slam import resolve_device
from dynamic_visual_slam_tpu_torch.semantic.classes import category_id
from dynamic_visual_slam_tpu_torch.utils.profiling import TRACER

LETTERBOX_FILL = 0.447


@functools.lru_cache(maxsize=16)
def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of ``jax.image.resize``'s bilinear
    resize with its default antialiasing along one axis
    (``compute_weight_mat``): a triangle kernel widened by the
    downsampling factor, each output's weights renormalised to sum to one,
    outputs whose sample falls outside the input zeroed."""
    f32 = np.float32
    scale = n_out / n_in
    inv_scale = f32(1.0 / scale)
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.sum(weights, axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                       weights / np.where(total != 0, total, f32(1.0)),
                       f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=16)
def resize_tensor(n_in: int, n_out: int, device: torch.device
                  ) -> torch.Tensor:
    """resize_weights on ``device``, uploaded once."""
    return torch.from_numpy(resize_weights(n_in, n_out)).to(device)


def letterbox_geometry(h: int, w: int, size: int) -> tuple:
    """(scale, (new_h, new_w), (pad_x, pad_y)) of an (h, w) frame centred
    in a size x size canvas."""
    scale = min(size / h, size / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    return scale, (nh, nw), ((size - nw) // 2, (size - nh) // 2)


def letterbox(rgb, size: int, device) -> tuple:
    """(..., H, W, 3) uint8 or float RGB → ((..., size, size, 3) float32 in
    [0, 1] on ``device``, scale, (pad_x, pad_y)): each frame resized as the
    reference's ``jax.image.resize(..., "bilinear")`` (two weight matrices,
    contracted in float32), centred on a 0.447 canvas."""
    dev = torch.device(device)
    img = torch.as_tensor(rgb).to(dev, torch.float32) / 255.0
    h, w = img.shape[-3:-1]
    scale, (nh, nw), (px, py) = letterbox_geometry(h, w, size)
    if nh != h:
        img = torch.einsum("...hwc,hy->...ywc", img,
                           resize_tensor(h, nh, dev))
    if nw != w:
        img = torch.einsum("...ywc,wx->...yxc", img,
                           resize_tensor(w, nw, dev))
    canvas = torch.full(img.shape[:-3] + (size, size, 3), LETTERBOX_FILL,
                        dtype=torch.float32, device=dev)
    canvas[..., py:py + nh, px:px + nw, :] = img
    return canvas, scale, (px, py)


def build_model(params: Dict[str, Any], device) -> yolov8.YOLOv8:
    """YOLOv8 in eval mode on ``device`` from the reference's parameter
    tree (numpy, e.g. ``convert.load_params``)."""
    from dynamic_visual_slam_tpu_torch.convert import yolo_state_dict
    model = yolov8.YOLOv8(int(params["heads"][0]["cls3"]["b"].shape[0]))
    model.load_state_dict(yolo_state_dict(params))
    return model.to(device).eval()


class YoloDetector:
    """YOLOv8n on ``device``: ``params`` (the reference's parameter tree as
    numpy, e.g. from ``convert.load_params``), else ``weights_path`` (the
    reference's npz, or an ultralytics ``.pt`` through
    ``models/convert_ultralytics.convert``), else, as the reference does
    when no weights are given, a random initialisation from ``seed``
    (``yolov8.init_params``): it drives the whole compute path, but its
    boxes are meaningless.  A ``weights_path`` that does not exist raises
    (the reference falls back to the random weights).  Weights that embed
    an ``input_size`` (those trained by ``semantic/train.py``, the shipped
    ``assets/yolov8n_synth.npz`` among them: 256) run at that size, as the
    reference's; otherwise at ``cfg.semantic.input_size``."""

    def __init__(self, cfg: SLAMConfig, weights_path: Optional[str] = None,
                 params: Optional[Dict[str, Any]] = None, seed: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.size = cfg.semantic.input_size
        if params is None and weights_path:
            if not os.path.exists(weights_path):
                raise FileNotFoundError(weights_path)
            from dynamic_visual_slam_tpu_torch.models import (
                convert_ultralytics as cu)
            params = cu.convert(weights_path) \
                if weights_path.endswith(".pt") \
                else cu.load_params(weights_path)
        elif params is None:
            params = yolov8.init_params(torch.Generator().manual_seed(seed))
        if "input_size" in params:
            self.size = int(np.asarray(params["input_size"], np.float32))
        self.model = build_model(params, self.device)
        self._recent = []   # (boxes, category, score) of recent frames

    def letterbox(self, rgb):
        return letterbox(rgb, self.size, self.device)

    def __call__(self, rgb) -> Detections:
        """Spans: ``detector``, and inside it ``detector.pre`` (the
        letterbox), ``detector.forward`` (network, decode, NMS) and
        ``detector.post`` (boxes back to the frame, the host read, box
        tracks)."""
        with TRACER.entry("detector", 0, self.device):
            with TRACER.span("detector.pre"):
                canvas, scale, (px, py) = self.letterbox(rgb)
            sc = self.cfg.semantic
            with TRACER.span("detector.forward"):
                raw = yolov8.detect(self.model, canvas, sc.max_detections,
                                    sc.score_threshold, sc.iou_threshold)
            with TRACER.span("detector.post"):
                h, w = rgb.shape[:2]
                dev = self.device
                pad = torch.tensor([px, py, px, py], dtype=torch.float32,
                                   device=dev)
                hi = torch.tensor([w - 1, h - 1, w - 1, h - 1],
                                  dtype=torch.float32, device=dev)
                boxes = torch.minimum(
                    torch.clamp((raw.boxes - pad) / scale, min=0.0), hi)
                # the frame's one host read: boxes, class id + 1, score,
                # valid
                host = torch.cat([boxes,
                                  (raw.classes + 1).to(torch.float32)[:, None],
                                  raw.scores[:, None],
                                  raw.valid.to(torch.float32)[:, None]], dim=1)
                host = host.cpu().numpy()
                return self._postprocess(
                    host[:, :4], host[:, 4].astype(np.int32), host[:, 5],
                    host[:, 6] > 0.5, (h, w))

    def _update_tracks(self, b: np.ndarray, c: np.ndarray, s: np.ndarray,
                       hw) -> tuple:
        """Velocity-extrapolated box tracking (SemanticConfig
        track_ttl_frames / track_inflate): greedy IoU matching to live
        tracks; missed tracks coast on their EMA velocity, inflate per
        stale frame, and expire after the TTL.  Serves the union of current
        detections and coasting tracks."""
        sc = self.cfg.semantic
        h, w = hw
        tracks = getattr(self, "_tracks", [])

        def iou(a, bb):
            x1 = np.maximum(a[0], bb[0]); y1 = np.maximum(a[1], bb[1])
            x2 = np.minimum(a[2], bb[2]); y2 = np.minimum(a[3], bb[3])
            inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
            ua = (a[2] - a[0]) * (a[3] - a[1]) \
                + (bb[2] - bb[0]) * (bb[3] - bb[1]) - inter
            return inter / max(ua, 1e-9)

        used = np.zeros(len(b), bool)
        for tr in tracks:
            best, bi = 0.30, -1          # match floor
            for i in range(len(b)):
                if used[i] or c[i] != tr["cat"]:
                    continue
                v = iou(tr["box"], b[i])
                if v > best:
                    best, bi = v, i
            if bi >= 0:
                used[bi] = True
                nc = np.asarray([(b[bi][0] + b[bi][2]) / 2,
                                 (b[bi][1] + b[bi][3]) / 2])
                oc = np.asarray([(tr["box"][0] + tr["box"][2]) / 2,
                                 (tr["box"][1] + tr["box"][3]) / 2])
                if tr["age"] == 0:
                    # seen last frame: (nc - oc) IS the per-frame motion
                    tr["vel"] = 0.6 * tr["vel"] + 0.4 * (nc - oc)
                else:
                    # re-acquired after coasting: the box already moved by
                    # vel each stale frame, so (nc - oc) is the residual —
                    # apply it as a per-frame velocity correction
                    tr["vel"] = tr["vel"] + 0.4 * (nc - oc) / (tr["age"] + 1)
                tr["box"] = b[bi].copy()
                tr["score"] = float(s[bi])
                tr["age"] = 0
            else:
                tr["age"] += 1
                vx, vy = tr["vel"]
                g = sc.track_inflate * 0.5 * (
                    (tr["box"][2] - tr["box"][0])
                    + (tr["box"][3] - tr["box"][1]))
                tr["box"] = tr["box"] + np.asarray(
                    [vx - g, vy - g, vx + g, vy + g], np.float32)
        tracks = [t for t in tracks if t["age"] <= sc.track_ttl_frames]
        for i in range(len(b)):
            if not used[i]:
                tracks.append(dict(box=b[i].copy(),
                                   vel=np.zeros(2, np.float64),
                                   cat=int(c[i]), score=float(s[i]), age=0))
        self._tracks = tracks
        if not tracks:
            return b, c, s
        tb = np.clip(np.stack([t["box"] for t in tracks]),
                     [0, 0, 0, 0], [w - 1, h - 1, w - 1, h - 1]
                     ).astype(np.float32)
        keep = (tb[:, 2] - tb[:, 0] > 1) & (tb[:, 3] - tb[:, 1] > 1)
        tb = tb[keep]
        tc = np.asarray([t["cat"] for t in tracks], np.int32)[keep]
        ts_ = np.asarray([t["score"] for t in tracks], np.float32)[keep]
        return tb, tc, ts_

    def _postprocess(self, boxes: np.ndarray, category: np.ndarray,
                     score: np.ndarray, valid: np.ndarray,
                     hw) -> Detections:
        """Culling-robustness post-processing (SemanticConfig.box_margin /
        persist_frames): dilate each box by margin × its size, then serve
        the box tracks (or the union of the last persist_frames frames'
        dilated boxes when tracking is off)."""
        sc = self.cfg.semantic
        h, w = hw
        k = int(np.sum(valid))
        order = np.argsort(~valid)          # valid rows first
        b = boxes[order][:k].astype(np.float32)
        c = category[order][:k].astype(np.int32)
        s = score[order][:k].astype(np.float32)
        if sc.box_margin > 0 and k:
            mw = (b[:, 2] - b[:, 0]) * sc.box_margin
            mh = (b[:, 3] - b[:, 1]) * sc.box_margin
            b = np.stack([np.maximum(b[:, 0] - mw, 0.0),
                          np.maximum(b[:, 1] - mh, 0.0),
                          np.minimum(b[:, 2] + mw, w - 1.0),
                          np.minimum(b[:, 3] + mh, h - 1.0)], axis=1)
        if getattr(sc, "track_ttl_frames", 0) > 0:
            b, c, s = self._update_tracks(b, c, s, (h, w))
        elif sc.persist_frames > 1:
            self._recent.append((b, c, s))
            if len(self._recent) > sc.persist_frames:
                self._recent.pop(0)
            b = np.concatenate([x[0] for x in self._recent])
            c = np.concatenate([x[1] for x in self._recent])
            s = np.concatenate([x[2] for x in self._recent])
        cap = sc.max_detections
        if len(b) > cap:                    # newest frames win the slots
            b, c, s = b[-cap:], c[-cap:], s[-cap:]
        out_b = np.zeros((cap, 4), np.float32)
        out_c = np.zeros(cap, np.int32)
        out_s = np.zeros(cap, np.float32)
        n = len(b)
        out_b[:n], out_c[:n], out_s[:n] = b, c, s
        return _detections(out_b, out_c, out_s, np.arange(cap) < n,
                           self.device)


def _detections(boxes, category, score, mask, device) -> Detections:
    dev = torch.device(device)
    return Detections(
        boxes=torch.from_numpy(np.asarray(boxes, np.float32)).to(dev),
        category=torch.from_numpy(np.asarray(category, np.int64)).to(dev),
        score=torch.from_numpy(np.asarray(score, np.float32)).to(dev),
        mask=torch.from_numpy(np.asarray(mask, bool)).to(dev))


def boxes_to_detections(boxes: np.ndarray, capacity: int,
                        category: str = "person", score: float = 1.0,
                        device="cuda") -> Detections:
    """(K,4) [x1,y1,x2,y2] pixel boxes → padded Detections on ``device``:
    the adapter between ground-truth bboxes (io/synthetic.object_bboxes)
    and the mapping stage."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    k = min(len(boxes), capacity)
    b = np.zeros((capacity, 4), np.float32)
    b[:k] = boxes[:k]
    cat = np.zeros(capacity, np.int64)
    cat[:k] = category_id(category)
    return _detections(b, cat, np.full(capacity, score, np.float32),
                       np.arange(capacity) < k, device)


class GTDetector:
    """Ground-truth 'detector': serves the exact bboxes recorded for each
    frame timestamp (filled by the frame source).  Same call surface as
    YoloDetector plus an optional stamp, so it drops into the threaded
    pipeline's detector thread."""

    def __init__(self, cfg: SLAMConfig, device="cuda"):
        self.capacity = cfg.semantic.max_detections
        self.device = resolve_device(device)
        self._by_stamp: Dict[float, np.ndarray] = {}

    def record(self, stamp: float, boxes: np.ndarray) -> None:
        self._by_stamp[round(float(stamp), 6)] = np.asarray(boxes, np.float32)

    def __call__(self, rgb, stamp: Optional[float] = None) -> Detections:
        boxes = self._by_stamp.get(round(float(stamp), 6),
                                   np.zeros((0, 4), np.float32)) \
            if stamp is not None else np.zeros((0, 4), np.float32)
        return boxes_to_detections(boxes, self.capacity, device=self.device)
