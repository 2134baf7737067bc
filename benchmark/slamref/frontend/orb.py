"""ORB extractor: pyramid → FAST score → spread top-k → IC angle → rBRIEF,
fixed shapes, batched over frames.

Same algorithm as the reference package's ``frontend/orb.py`` (which follows
the ORB-SLAM extractor: 8-level x1.2 pyramid, per-35px-cell FAST th=20→7
fallback, spread top-k in place of the quadtree, intensity-centroid angle,
7x7 sigma=2 blur + 256-pair rotated BRIEF).  The two heavy stages are the
port's hand-written CUDA kernels: B1 (FAST scores of all levels of all
frames, ``ops/fields.fast_score_batch``) and B2 (moments + descriptor bits
of all keypoints, ``ops/descriptors.descriptors_moments``).

The 256-pair sampling pattern is the standard public ORB constant table,
stored as data in orb_pattern.npy (the package's own copy).
"""

from __future__ import annotations

import functools
import math
import os
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from slamref.config import ORBConfig
from slamref.core.containers import topk_stable
from slamref.ops import descriptors as desc_k
from slamref.ops import hamming
from slamref.ops import image as imops
from slamref.ops.fields import fast_score_batch

HALF_PATCH = 15
SAMPLE_PAD = 19   # covers the rotated-BRIEF reach (≤ |13|·√2)
CELL = 35         # FAST grid cell
PER_CELL_K = 8    # candidates kept per cell before the global top-k


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set; arrays have leading dims (..., K)."""

    uv: torch.Tensor          # (..., K, 2) float32 — (x, y) level-0 pixels
    response: torch.Tensor    # (..., K)  float32 — FAST corner score
    angle: torch.Tensor       # (..., K)  float32 — radians, IC orientation
    octave: torch.Tensor      # (..., K)  int32   — pyramid level
    desc_bits: torch.Tensor   # (..., K, 256) uint8 {0,1}
    desc_packed: torch.Tensor  # (..., K, 32) uint8 — OpenCV wire layout
    mask: torch.Tensor        # (..., K) bool

    @property
    def capacity(self) -> int:
        return self.uv.shape[-2]

    def count(self) -> torch.Tensor:
        return self.mask.sum(-1)


# --------------------------------------------------------------------------
# Constant tables (host-side, cached)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def brief_pattern() -> np.ndarray:
    """(256, 4) float32 — x1,y1,x2,y2 per comparison (public ORB constant)."""
    path = os.path.join(os.path.dirname(__file__), "orb_pattern.npy")
    pat = np.load(path)
    if pat.shape != (256, 4):
        raise ValueError(f"orb_pattern.npy has shape {pat.shape}")
    return pat.astype(np.float32)


@functools.lru_cache(maxsize=None)
def ic_umax() -> np.ndarray:
    """Per-row max column offset of the radius-15 disc, with the symmetry
    correction of the ORB-SLAM extractor."""
    umax = np.zeros(HALF_PATCH + 2, dtype=np.int32)
    vmax = int(math.floor(HALF_PATCH * math.sqrt(2.0) / 2 + 1))
    vmin = int(math.ceil(HALF_PATCH * math.sqrt(2.0) / 2))
    hp2 = HALF_PATCH * HALF_PATCH
    for v in range(vmax + 1):
        umax[v] = int(round(math.sqrt(hp2 - v * v)))
    v0 = 0
    for v in range(HALF_PATCH, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[:HALF_PATCH + 1]


def features_per_level(cfg: ORBConfig) -> List[int]:
    """Geometric per-level quotas, remainder to the coarsest level."""
    factor = 1.0 / cfg.scale_factor
    n_first = cfg.n_features * (1 - factor) / (1 - factor ** cfg.n_levels)
    quotas, acc = [], 0
    for _ in range(cfg.n_levels - 1):
        q = int(round(n_first))
        quotas.append(q)
        acc += q
        n_first *= factor
    quotas.append(max(cfg.n_features - acc, 0))
    return quotas


# --------------------------------------------------------------------------
# Per-level stages
# --------------------------------------------------------------------------

def _topk_per_cell(tiles: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., Hc, CELL, Wc, CELL) cell grid scores (> 0 valid) → top-k values
    and in-cell indices (row·CELL + col) per cell, (..., Hc, Wc, k):
    descending, ties → lower index, exhausted slots give -inf.

    (⌊score⌋+1)·2048 + (2047−idx) packs into one int32 (scores ≤ 255 + the
    1e6 spread boost), so each of the k rounds is one max-reduction and the
    tie order is the packed key's, not a sort's."""
    cell_w = tiles.shape[-1]
    ri = torch.arange(tiles.shape[-3], device=tiles.device)[:, None, None]
    ci = torch.arange(cell_w, device=tiles.device)
    pos = (ri * cell_w + ci).to(torch.int32)             # (CELL, 1, CELL)
    valid = tiles > 0.0
    enc = torch.where(valid, (torch.clamp(tiles, min=0.0).to(torch.int32) + 1)
                      * 2048 + (2047 - pos), 0)
    vals, idxs = [], []
    for _ in range(k):
        m = enc.amax(dim=(-3, -1))                        # (..., Hc, Wc)
        got = m > 0
        idx = torch.where(got, 2047 - (m & 2047), 0)
        vals.append(torch.where(got, ((m >> 11) - 1).to(tiles.dtype),
                                -float("inf")))
        idxs.append(idx)
        enc = torch.where(pos == idx[..., :, None, :, None], 0, enc)
    return torch.stack(vals, dim=-1), torch.stack(idxs, dim=-1)


def detect_level(score: torch.Tensor, quota: int, ini_th: float, min_th: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score maps (..., H, W) → (ys, xs, responses) of up to `quota` spread
    keypoints each, (..., quota); response <= 0 marks invalid slots.

    Mask algebra equivalent of per-cell FAST(20)→FAST(7) + DistributeOctTree."""
    h, w = score.shape[-2:]
    lead = score.shape[:-2]
    neg_inf = torch.full((), -float("inf"), device=score.device)
    is_peak = (score >= imops.maxpool_same(score, 3)) & (score > min_th)
    peak_score = torch.where(is_peak, score, neg_inf)

    cell_max = imops.cell_reduce_max(peak_score, CELL)
    cell_has_strong = imops.cell_broadcast(cell_max > ini_th, CELL, h, w)
    keep = is_peak & ((score > ini_th) | ~cell_has_strong)
    kept_score = torch.where(keep, score, neg_inf)

    cell_best = imops.cell_broadcast(imops.cell_reduce_max(kept_score, CELL),
                                     CELL, h, w)
    is_cell_best = keep & (kept_score >= cell_best)

    hc, wc = -(-h // CELL), -(-w // CELL)
    boosted = torch.where(keep, kept_score + 1e6 * is_cell_best.to(score.dtype),
                          neg_inf)
    padded = torch.nn.functional.pad(boosted, (0, wc * CELL - w, 0, hc * CELL - h),
                                     value=-float("inf"))
    tiles = padded.reshape(lead + (hc, CELL, wc, CELL))
    cand_val, cand_in_cell = _topk_per_cell(tiles, PER_CELL_K)  # (.., Hc,Wc,K)

    dev = score.device
    cy = torch.arange(hc, device=dev)[:, None, None] * CELL \
        + cand_in_cell // CELL
    cx = torch.arange(wc, device=dev)[None, :, None] * CELL \
        + cand_in_cell % CELL

    flat_val = cand_val.reshape(lead + (-1,))
    flat_y = cy.reshape(lead + (-1,))
    flat_x = cx.reshape(lead + (-1,))
    k_eff = min(quota, flat_val.shape[-1])
    top_val, top_idx = topk_stable(flat_val, k_eff)
    if k_eff < quota:
        top_val = torch.cat([top_val, torch.full(lead + (quota - k_eff,),
                                                 -float("inf"), device=dev)], -1)
        top_idx = torch.cat([top_idx, top_idx.new_zeros(lead + (quota - k_eff,))],
                            -1)
    ys = torch.gather(flat_y, -1, top_idx)
    xs = torch.gather(flat_x, -1, top_idx)
    resp = torch.where(top_val > 5e5, top_val - 1e6, top_val)
    resp = torch.where(torch.isfinite(top_val), resp, -1.0)
    return ys.to(torch.int32), xs.to(torch.int32), resp.to(torch.float32)


# --------------------------------------------------------------------------
# Batched extractor
# --------------------------------------------------------------------------

def extract(img: torch.Tensor, cfg: ORBConfig) -> Keypoints:
    """One (H, W) grayscale frame → Keypoints with capacity
    cfg.max_keypoints: ``extract_batch`` on a batch of one, which the
    reference states gives the same keypoints as its per-frame extractor.
    One B1 and one B2 launch a frame."""
    return Keypoints(*(a[0] for a in extract_batch(img[None], cfg)))


def extract_batch(imgs: torch.Tensor, cfg: ORBConfig) -> Keypoints:
    """(B, H, W) grayscale stack (uint8 or float32 in [0, 255]) → Keypoints
    with leading dim B and capacity cfg.max_keypoints.

    One B1 launch scores all B × n_levels pyramid levels, one B2 launch
    describes all B × max_keypoints keypoint slots; the rest is batched
    tensor code on the images' device."""
    levels = imops.build_pyramid(imgs.to(torch.float32), cfg.n_levels,
                                 cfg.scale_factor)
    return extract_levels(levels, cfg)


class DescriptorInputs(NamedTuple):
    """Everything kernel B2 takes for one batch: per-level blurred and raw
    images reflect-padded by SAMPLE_PAD, and the K = B·capacity keypoint
    slots as flat int32 (level, frame, y, x)."""

    blur: List[torch.Tensor]     # per level (B, H_l + 38, W_l + 38) f32
    raw: List[torch.Tensor]
    level: torch.Tensor          # (K,) int32
    frame: torch.Tensor          # (K,) int32
    ys: torch.Tensor             # (K,) int32
    xs: torch.Tensor             # (K,) int32


def detect_batch(levels, scores, cfg: ORBConfig):
    """Per-level detection + blur for a batch → (slots, DescriptorInputs):
    slots is a dict of (B, capacity, ...) tensors (uv, response, octave,
    mask); the descriptor inputs cover every slot, padding included."""
    b = levels[0].shape[0]
    dev = levels[0].device
    quotas = features_per_level(cfg)
    parts, blur_levels, raw_levels = [], [], []
    for lvl, (lv, score, quota) in enumerate(zip(levels, scores, quotas)):
        ys, xs, resp = detect_level(score, quota, float(cfg.ini_th_fast),
                                    float(cfg.min_th_fast))
        blurred = torch.clamp(torch.round(imops.gaussian_blur(lv, 7, 2.0)),
                              0.0, 255.0)
        blur_levels.append(imops.reflect_pad(blurred, SAMPLE_PAD).contiguous())
        raw_levels.append(imops.reflect_pad(lv, SAMPLE_PAD).contiguous())
        scale = cfg.scale_factor ** lvl
        uv = torch.stack([xs.to(torch.float32), ys.to(torch.float32)], -1) \
            * scale
        parts.append(dict(uv=uv, response=resp, ys=ys, xs=xs,
                          octave=torch.full_like(ys, lvl), mask=resp > 0))

    cat = {k: torch.cat([p[k] for p in parts], dim=1) for k in parts[0]}
    k_cap = cfg.max_keypoints
    n = cat["mask"].shape[1]
    if n < k_cap:
        pad = k_cap - n
        cat = {k: torch.cat([v, v.new_zeros((b, pad) + v.shape[2:])], dim=1)
               for k, v in cat.items()}
    elif n > k_cap:
        _, keep_idx = topk_stable(
            torch.where(cat["mask"], cat["response"], -1.0), k_cap)
        cat = {k: (torch.gather(v, 1, keep_idx) if v.ndim == 2 else
                   torch.gather(v, 1, keep_idx[..., None].expand(
                       -1, -1, v.shape[2])))
               for k, v in cat.items()}

    frame = torch.arange(b, dtype=torch.int32, device=dev)[:, None] \
        .expand(b, k_cap)
    flat = lambda t: t.reshape(-1).contiguous()  # noqa: E731
    inputs = DescriptorInputs(blur_levels, raw_levels, flat(cat["octave"]),
                              flat(frame), flat(cat["ys"]), flat(cat["xs"]))
    return cat, inputs


def extract_levels(levels, cfg: ORBConfig) -> Keypoints:
    """extract_batch from an already built pyramid: levels is the list of
    (B, H_l, W_l) float32 level stacks (level 0 = the frames)."""
    levels = [lv.contiguous() for lv in levels]
    b = levels[0].shape[0]
    k_cap = cfg.max_keypoints
    cat, inputs = detect_batch(levels, fast_score_batch(levels), cfg)
    bits, m10, m01 = desc_k.descriptors_moments(*inputs)
    bits = bits.reshape(b, k_cap, 256)
    return Keypoints(
        uv=cat["uv"], response=cat["response"],
        angle=torch.atan2(m01, m10).reshape(b, k_cap),
        octave=cat["octave"], desc_bits=bits,
        desc_packed=hamming.pack_bits(bits), mask=cat["mask"])
