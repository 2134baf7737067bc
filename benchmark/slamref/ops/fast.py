"""FAST-9/16 corner score, as the plain PyTorch version of the port's kernel
B1 computes it (the frozen copy has no kernel).

score(p) = the largest threshold t at which p is still a FAST-9 corner
(OpenCV's cornerScore), so "detected at threshold t ⇔ score > t" and one
score map serves the reference's FAST(20) → FAST(7) per-cell fallback.
Min, max and the integer differences are exact, so the port's kernel and
this agree bit for bit.
"""

from __future__ import annotations

import torch

from slamref.ops.image import reflect_pad

# Bresenham circle of radius 3, OpenCV pixel order (dy=row, dx=col), index 0
# at 12 o'clock going clockwise.
CIRCLE_DYDX = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC_LEN = 9  # FAST-9/16


def _windowed_min9(d: torch.Tensor) -> torch.Tensor:
    """Min over each of the 16 circular windows of length 9 along dim 0
    (log-step: len-2 → len-4 → len-8 partial mins, then the +8 element)."""
    m = torch.minimum(d, torch.roll(d, -1, dims=0))
    m = torch.minimum(m, torch.roll(m, -2, dims=0))
    m = torch.minimum(m, torch.roll(m, -4, dims=0))
    return torch.minimum(m, torch.roll(d, -8, dims=0))


def corner_score(img: torch.Tensor) -> torch.Tensor:
    """Dense FAST-9 corner score map (..., H, W), float32.

    score(p) = max(max_k min(v_i - p over arc k), max_k min(p - v_i over arc k)).
    The 3-px border is scored against REFLECT_101 pixels."""
    img = img.to(torch.float32)
    h, w = img.shape[-2:]
    padded = reflect_pad(img, 3)
    v = torch.stack([padded[..., 3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
                     for dy, dx in CIRCLE_DYDX])     # (16, ..., H, W)
    d = v - img[None]
    bright = torch.amax(_windowed_min9(d), dim=0)
    dark = torch.amax(_windowed_min9(-d), dim=0)
    return torch.maximum(bright, dark)

