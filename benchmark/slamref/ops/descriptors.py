"""Per-keypoint intensity-centroid moments + rotated-BRIEF bits.

``descriptors_moments`` computes, with plain PyTorch on any device, what the
port's kernel B2 (``csrc/orb_desc_moments.cu`` there) computes: one call
covers every keypoint of a batch, whatever its level and frame.

Both take the per-level blurred and raw images reflect-padded by
``SAMPLE_PAD`` (19) as (B, H_l + 38, W_l + 38) float32 tensors, and K
keypoints as int32 (level, frame, y, x) in unpadded level coordinates.  They
return (bits (K, 256) uint8, m10 (K,) f32, m01 (K,) f32).

The orientation is taken from the moments directly, c = m10/√n², s = m01/√n²
(n² = m10² + m01², c=1 and s=0 when n² = 0), as the reference's TPU kernel
does; its CPU path instead evaluates cos/sin of atan2(m01, m10), which can
differ in the last bit and flip a rounded sample offset — the tests count
those flips.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch


SAMPLE_PAD = 19
HALF_PATCH = 15


@functools.lru_cache(maxsize=None)
def _pattern_xy() -> np.ndarray:
    """(2, 512) float32: the 512 sample offsets (px, py) of the 256 pairs,
    first points then second points."""
    from slamref.frontend.orb import brief_pattern
    pat = brief_pattern()
    return np.stack([np.concatenate([pat[:, 0], pat[:, 2]]),
                     np.concatenate([pat[:, 1], pat[:, 3]])]).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _pattern_tensor(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_pattern_xy().reshape(-1).copy()).to(device)


@functools.lru_cache(maxsize=None)
def _disc_offsets() -> Tuple[np.ndarray, np.ndarray]:
    """(du, dv) int offsets of the radius-15 IC disc |du| <= umax[|dv|]."""
    from slamref.frontend.orb import ic_umax
    umax = ic_umax()
    du, dv = [], []
    for v in range(-HALF_PATCH, HALF_PATCH + 1):
        u = int(umax[abs(v)])
        for x in range(-u, u + 1):
            du.append(x)
            dv.append(v)
    return np.asarray(du, np.int64), np.asarray(dv, np.int64)


@functools.lru_cache(maxsize=8)
def _disc_tensor(device: torch.device) -> torch.Tensor:
    """_disc_offsets as one (2, D) int64 tensor (du, dv) on ``device``."""
    return torch.from_numpy(np.stack(_disc_offsets())).to(device)


def _check(blur: Sequence[torch.Tensor], raw: Sequence[torch.Tensor],
           keypoint_arrays: Sequence[torch.Tensor]) -> None:
    if len(blur) != len(raw) or not blur:
        raise ValueError("descriptors_moments: need one blurred and one raw "
                         "image per level")
    dev = blur[0].device
    b = blur[0].shape[0]
    for bl, rw in zip(blur, raw):
        for t in (bl, rw):
            if t.device != dev or t.dtype != torch.float32 or t.ndim != 3 \
                    or t.shape[0] != b or not t.is_contiguous():
                raise ValueError(
                    "descriptors_moments: level images must be contiguous "
                    f"float32 (B, Hp, Wp) on one device; got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
        if bl.shape != rw.shape or min(bl.shape[1:]) < 2 * SAMPLE_PAD + 1:
            raise ValueError("descriptors_moments: blurred/raw level shapes "
                             f"{tuple(bl.shape)} vs {tuple(rw.shape)}")
    k = keypoint_arrays[0].shape
    for a in keypoint_arrays:
        if a.device != dev or a.dtype != torch.int32 or a.ndim != 1 \
                or a.shape != k or not a.is_contiguous():
            raise ValueError("descriptors_moments: keypoint arrays must be "
                             "contiguous int32 (K,) on the images' device")


def descriptors_moments(blur: Sequence[torch.Tensor],
                        raw: Sequence[torch.Tensor], level: torch.Tensor,
                        frame: torch.Tensor, ys: torch.Tensor,
                        xs: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version on any device (the frozen copy has no kernel)."""
    _check(blur, raw, (level, frame, ys, xs))
    return descriptors_moments_plain(blur, raw, level, frame, ys, xs)


def descriptors_moments_plain(blur: Sequence[torch.Tensor],
                              raw: Sequence[torch.Tensor], level: torch.Tensor,
                              frame: torch.Tensor, ys: torch.Tensor,
                              xs: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain PyTorch version of kernel B2 (gathers from a flat concatenation
    of all levels; same formulas and roundings as the kernel)."""
    dev = blur[0].device
    blur_flat = torch.cat([t.reshape(-1) for t in blur])
    raw_flat = torch.cat([t.reshape(-1) for t in raw])
    # each keypoint's level size and offset into the flat concatenation
    lvl = level.long()
    hp, wp, off = (torch.zeros_like(lvl) for _ in range(3))
    start = 0
    for i, t in enumerate(blur):
        at = lvl == i
        hp = torch.where(at, t.shape[1], hp)
        wp = torch.where(at, t.shape[2], wp)
        off = torch.where(at, start, off)
        start += t.numel()
    hp, wp = hp[:, None], wp[:, None]
    base = (off + frame.long() * hp[:, 0] * wp[:, 0])[:, None]
    cy = ys.long()[:, None] + SAMPLE_PAD
    cx = xs.long()[:, None] + SAMPLE_PAD

    du, dv = _disc_tensor(dev)
    disc = raw_flat[base + (cy + dv) * wp + (cx + du)]          # (K, D)
    m10 = (disc * du.to(torch.float32)).sum(-1)
    m01 = (disc * dv.to(torch.float32)).sum(-1)

    n2 = m10 * m10 + m01 * m01
    nrm = torch.sqrt(n2)
    pos = n2 > 0
    c = torch.where(pos, m10 / nrm, 1.0)[:, None]
    s = torch.where(pos, m01 / nrm, 0.0)[:, None]
    px, py = _pattern_tensor(dev).reshape(2, -1)
    col = torch.round(px * c - py * s).long()
    row = torch.round(px * s + py * c).long()
    r = torch.clamp(cy + row, torch.zeros_like(hp), hp - 1)
    cc = torch.clamp(cx + col, torch.zeros_like(wp), wp - 1)
    samples = blur_flat[base + r * wp + cc]                      # (K, 512)
    bits = (samples[:, :256] < samples[:, 256:]).to(torch.uint8)
    return bits, m10, m01
