"""ORB keypoints judged by an independent transcription of kernels B1 and
B2.

``slamref`` is a frozen copy of the port's plain path: it finds a change in
the port, not a fault that the port had from the start.  This module holds
what the two kernels compute to the published algorithm instead, written
here in float64 from its definition and sharing no code with the port or
with ``slamref``.  It reads the pyramid levels and their blurred versions
as the reference (``slamref``, float32, TF32 off) builds them from the
frame: plain image operations ahead of the kernels.

- FAST-9/16 (kernel B1): score(p) = the largest of min(v_i - p) and
  min(p - v_i) over the 16 arcs of 9 contiguous pixels of the radius-3
  Bresenham circle, border pixels by REFLECT_101.  A keypoint has to carry
  that score as its response, be a maximum of the score over its 3 x 3
  neighbourhood and score above the low FAST threshold.
- The intensity centroid and rotated BRIEF (kernel B2): the moments m10,
  m01 over the radius-15 disc of the raw level (ORB-SLAM's ``umax``), the
  256 pairs of the public ORB pattern rotated by c = m10 / |m|,
  s = m01 / |m| (row round(x s + y c), column round(x c - y s)) and read
  from the blurred level; bit i is 1 where the first sample is the smaller.

``mismatch(levels, smoothed, kps, orb_cfg)`` counts the keypoints of one
frame that break any of these: (keypoints, of which wrong).
"""

from __future__ import annotations

import functools
import math
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

F64 = torch.float64
# radius-3 Bresenham circle, clockwise from 12 o'clock, (row, column)
CIRCLE = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2),
          (3, 1), (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3),
          (-2, -2), (-3, -1))
ARC = 9
HALF_PATCH = 15
BRIEF_PAD = 19      # how far the extractor pads a level before sampling
PATTERN = Path(__file__).resolve().parent.parent / "slamref" / "frontend" \
    / "orb_pattern.npy"


def reflect101(i: torch.Tensor, n: int) -> torch.Tensor:
    """Index ``i`` folded into [0, n) as BORDER_REFLECT_101 folds it."""
    i = torch.where(i < 0, -i, i)
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def fast_score(img: torch.Tensor) -> torch.Tensor:
    """FAST-9/16 score of every pixel of a (H, W) float64 image."""
    h, w = img.shape
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    diff = torch.stack([img[reflect101(ys + dy, h), reflect101(xs + dx, w)]
                        for dy, dx in CIRCLE]) - img        # (16, H, W)
    best = torch.full_like(img, -math.inf)
    for start in range(16):
        arc = diff[[(start + j) % 16 for j in range(ARC)]]
        brighter = arc.min(0).values          # min(v_i - p) over the arc
        darker = -arc.max(0).values           # min(p - v_i) over the arc
        best = torch.maximum(best, torch.maximum(brighter, darker))
    return best


@functools.lru_cache(maxsize=None)
def disc() -> Tuple[np.ndarray, np.ndarray]:
    """(du, dv) of the radius-15 disc, |du| <= umax[|dv|], with ORB-SLAM's
    symmetric ``umax``."""
    umax = [0] * (HALF_PATCH + 2)
    vmax = int(math.floor(HALF_PATCH * math.sqrt(2.0) / 2 + 1))
    vmin = int(math.ceil(HALF_PATCH * math.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(math.sqrt(HALF_PATCH ** 2 - v * v)))
    v0 = 0
    for v in range(HALF_PATCH, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    pts = [(u, v) for v in range(-HALF_PATCH, HALF_PATCH + 1)
           for u in range(-umax[abs(v)], umax[abs(v)] + 1)]
    return (np.array([u for u, _ in pts]), np.array([v for _, v in pts]))


def _padded(y: torch.Tensor, n: int) -> torch.Tensor:
    """A sample's row (or column) as the extractor reads it: clamped to the
    level padded by ``BRIEF_PAD``, then folded back into the level."""
    return reflect101(torch.clamp(y, -BRIEF_PAD, n - 1 + BRIEF_PAD), n)


def describe(raw: torch.Tensor, smooth: torch.Tensor, ys: torch.Tensor,
             xs: torch.Tensor, pattern: torch.Tensor) -> torch.Tensor:
    """(K, 256) bits of keypoints (ys, xs) of one level."""
    h, w = raw.shape
    du, dv = (torch.from_numpy(a).to(raw.device) for a in disc())
    pix = raw[reflect101(ys[:, None] + dv, h), reflect101(xs[:, None] + du, w)]
    m10 = (pix * du.to(F64)).sum(-1)
    m01 = (pix * dv.to(F64)).sum(-1)
    n = torch.sqrt(m10 * m10 + m01 * m01)
    c = torch.where(n > 0, m10 / n, 1.0)[:, None]
    s = torch.where(n > 0, m01 / n, 0.0)[:, None]

    def sample(px, py):
        row = torch.round(px * s + py * c).long()
        col = torch.round(px * c - py * s).long()
        return smooth[_padded(ys[:, None] + row, h),
                      _padded(xs[:, None] + col, w)]
    a = sample(pattern[:, 0], pattern[:, 1])
    b = sample(pattern[:, 2], pattern[:, 3])
    return (a < b).to(torch.uint8)


def mismatch(levels, smoothed, kps, orb_cfg) -> Tuple[int, int]:
    """(keypoints, keypoints that break the algorithm) of one frame:
    ``levels`` and ``smoothed`` its (H_l, W_l) pyramid levels, raw and
    blurred, ``kps`` its keypoints (fields ``uv``, ``octave``,
    ``response``, ``desc_bits``, ``mask``)."""
    dev = levels[0].device
    pattern = torch.from_numpy(np.load(PATTERN).astype(np.float64)).to(dev)
    mask = kps.mask.bool()
    octave = kps.octave.long()
    total = bad = 0
    for lvl, (img, smooth) in enumerate(zip(levels, smoothed)):
        sel = mask & (octave == lvl)
        if not bool(sel.any()):
            continue
        img, smooth = img.to(F64), smooth.to(F64)
        h, w = img.shape
        sc = float(orb_cfg.scale_factor) ** lvl
        uv = kps.uv[sel].to(F64) / sc
        xs, ys = torch.round(uv[:, 0]).long(), torch.round(uv[:, 1]).long()
        inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        xs, ys = xs.clamp(0, w - 1), ys.clamp(0, h - 1)
        score = fast_score(img)
        here = score[ys, xs]
        peak = torch.ones_like(inside)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                yy, xx = ys + dy, xs + dx
                ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                nb = score[yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
                peak &= ~ok | (here >= nb)
        good = inside & peak & (here > float(orb_cfg.min_th_fast)) \
            & (kps.response[sel].to(F64) == here)
        bits = describe(img, smooth, ys, xs, pattern)
        good &= (bits == kps.desc_bits[sel].to(torch.uint8)).all(-1)
        total += int(sel.sum())
        bad += int((~good).sum())
    return total, bad
