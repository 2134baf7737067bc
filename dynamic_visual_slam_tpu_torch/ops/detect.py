"""Keypoint detection of every pyramid level of a batch: FAST score maps →
the batch's spread keypoint slots.

``detect_levels`` wraps kernel D1 (``csrc/orb_detect.cu``): two launches
detect all B frames × all levels.  For CPU tensors it computes the plain
version, ``detect_levels_plain`` (``detect_level`` a level, then the
levels' slots concatenated and zero-padded); for CUDA tensors it launches
the kernel or raises.  Both count the frames × levels they detected, under
the tracer's ``extract.detect.plain`` and ``extract.detect.kernel``.

Everything the kernel is given comes from the ORB config (``detect_spec``)
and the score maps' shapes.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from dynamic_visual_slam_tpu_torch import kernels
from dynamic_visual_slam_tpu_torch.config import ORBConfig
from dynamic_visual_slam_tpu_torch.core.containers import topk_stable
from dynamic_visual_slam_tpu_torch.ops import image as imops
from dynamic_visual_slam_tpu_torch.utils.profiling import TRACER

KERNEL = "orb_detect"
CELL = 35         # FAST grid cell
PER_CELL_K = 8    # candidates kept per cell before the global top-k
MAX_LEVELS = 16   # the kernel's table of levels
# the slots of a level's result, in the order the plain version builds them
SLOT_KEYS = ("uv", "response", "ys", "xs", "octave", "mask")


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


class DetectSpec(NamedTuple):
    """What detection takes from the ORB config."""

    quotas: Tuple[int, ...]     # keypoint slots a level
    scales: Tuple[float, ...]   # scale_factor ** level, level px → level-0 px
    ini_th: float               # FAST threshold
    min_th: float               # the per-cell fallback threshold
    n_out: int                  # slots a frame: max(sum(quotas), max_keypoints)


def detect_spec(cfg: ORBConfig) -> DetectSpec:
    quotas = tuple(features_per_level(cfg))
    return DetectSpec(quotas,
                      tuple(cfg.scale_factor ** lvl for lvl in range(len(quotas))),
                      float(cfg.ini_th_fast), float(cfg.min_th_fast),
                      max(sum(quotas), cfg.max_keypoints))


def cell_grid(h: int, w: int) -> Tuple[int, int]:
    """Cells of an (h, w) level: CELL-px tiles anchored at (0, 0), the
    ragged edge counted."""
    return -(-h // CELL), -(-w // CELL)


# --------------------------------------------------------------------------
# The plain version
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

    hc, wc = cell_grid(h, w)
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


def detect_levels_plain(scores: Sequence[torch.Tensor], spec: DetectSpec
                        ) -> Dict[str, torch.Tensor]:
    """``detect_levels``'s plain version: ``detect_level`` a level, each
    level's slots in level-0 pixels (uv), its octave and mask, then the
    levels concatenated and zero-padded to spec.n_out slots."""
    parts = []
    for lvl, (score, quota, scale) in enumerate(zip(scores, spec.quotas,
                                                    spec.scales)):
        ys, xs, resp = detect_level(score, quota, spec.ini_th, spec.min_th)
        uv = torch.stack([xs.to(torch.float32), ys.to(torch.float32)], -1) \
            * scale
        parts.append(dict(uv=uv, response=resp, ys=ys, xs=xs,
                          octave=torch.full_like(ys, lvl), mask=resp > 0))
    cat = {k: torch.cat([p[k] for p in parts], dim=1) for k in SLOT_KEYS}
    b, n = cat["mask"].shape
    if n < spec.n_out:
        pad = spec.n_out - n
        cat = {k: torch.cat([v, v.new_zeros((b, pad) + v.shape[2:])], dim=1)
               for k, v in cat.items()}
    return cat


# --------------------------------------------------------------------------
# The wrapper
# --------------------------------------------------------------------------

def detect_levels(scores: Sequence[torch.Tensor], spec: DetectSpec
                  ) -> Dict[str, torch.Tensor]:
    """Spread keypoints of B frames' full pyramids.

    scores: per pyramid level a (B, H_l, W_l) float32 contiguous score map
    (kernel B1's), all on one device, one level a quota of ``spec``.
    → dict of (B, spec.n_out) tensors: uv (…, 2) float32 in level-0
    pixels, response float32, ys and xs int32 level pixels, octave int32,
    mask bool; a frame's row holds level 0's quota of slots, then level
    1's, …, then zeros."""
    if not scores or len(scores) != len(spec.quotas):
        raise ValueError(f"detect_levels: {len(scores)} score maps for "
                         f"{len(spec.quotas)} quotas")
    dev = scores[0].device
    b = scores[0].shape[0] if scores[0].ndim == 3 else -1
    for s in scores:
        if s.device != dev or s.dtype != torch.float32 or s.ndim != 3 \
                or s.shape[0] != b or not s.is_contiguous():
            raise ValueError(
                "detect_levels: score maps must be contiguous float32 "
                f"(B, H, W) tensors on one device; got {s.dtype} "
                f"{tuple(s.shape)} on {s.device}")
    if dev.type == "cpu":
        TRACER.count("extract.detect.plain", b * len(scores))
        return detect_levels_plain(scores, spec)
    if dev.type != "cuda":
        raise ValueError(f"detect_levels: unsupported device {dev}")
    if len(scores) > MAX_LEVELS or b < 1 \
            or any(min(s.shape[1:]) < 1 for s in scores):
        raise ValueError(f"detect_levels: {len(scores)} levels of {b} frames "
                         "are outside the kernel's range")
    TRACER.count("extract.detect.kernel", b * len(scores))
    return _detect_kernel(scores, spec)


def _detect_kernel(scores, spec: DetectSpec) -> Dict[str, torch.Tensor]:
    """``detect_levels`` on the card: one call of kernel D1 (two launches),
    no host read."""
    dev = scores[0].device
    b = scores[0].shape[0]
    hs = [s.shape[1] for s in scores]
    ws = [s.shape[2] for s in scores]
    n_cand = b * PER_CELL_K * sum(hc * wc for hc, wc in map(cell_grid, hs, ws))
    i32 = dict(dtype=torch.int32, device=dev)
    cand = torch.empty(n_cand, **i32)
    out = dict(uv=torch.empty(b, spec.n_out, 2, dtype=torch.float32, device=dev),
               response=torch.empty(b, spec.n_out, dtype=torch.float32,
                                    device=dev),
               ys=torch.empty(b, spec.n_out, **i32),
               xs=torch.empty(b, spec.n_out, **i32),
               octave=torch.empty(b, spec.n_out, **i32),
               mask=torch.empty(b, spec.n_out, dtype=torch.bool, device=dev))
    fn = kernels.entry(KERNEL)
    ptrs = kernels.pointer_array([s.data_ptr() for s in scores])
    args = [ctypes.cast(a, ctypes.c_void_p) for a in (
        ptrs, kernels.int_array(hs), kernels.int_array(ws),
        kernels.int_array(spec.quotas), kernels.float_array(spec.scales))]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(*args, len(scores), b, spec.ini_th, spec.min_th,
                    spec.n_out, cand.data_ptr(),
                    *(out[k].data_ptr() for k in SLOT_KEYS), stream)
    kernels.check(KERNEL, status)
    kernels.count(KERNEL)
    return out
