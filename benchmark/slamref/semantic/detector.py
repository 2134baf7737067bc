"""The detector's letterbox (frozen copy of the port's
``semantic/detector.py`` helpers) and the network's raw detections of one
frame, as the port's ``YoloDetector.__call__`` computes them before it
undoes the letterbox and runs its host-side box tracks."""

from __future__ import annotations

import functools

import numpy as np
import torch

from slamref.models import yolov8

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


def detect_frame(model: yolov8.YOLOv8, rgb, size: int, max_out: int,
                 score_thr: float, iou_thr: float):
    """(H, W, 3) RGB → (per-scale head outputs, RawDetections in the
    letterboxed canvas's pixels): letterbox, forward, decode, NMS."""
    canvas, _, _ = letterbox(rgb, size, next(model.parameters()).device)
    with torch.no_grad():
        outs = model(canvas.permute(2, 0, 1)[None])
        boxes, cls_scores = yolov8.decode(outs)
        return outs, yolov8.nms(boxes, cls_scores, max_out, score_thr,
                                iou_thr)
