"""Mapping backend: semantic labeling, data association, landmark arena,
multi-view triangulation, pruning.

Port of the reference package's ``backend/mapping.py``: a fixed-capacity
(L,) landmark slot arena with category ids, active mask and free-slot
allocation by prefix sums; an (L, M) ring of recent observations per
landmark; association as one (C, 2L) Hamming product + reprojection-gated
argmin.  Updates are functional (each returns a new state; the input state
is left intact).  A write the reference drops with ``mode="drop"`` goes here
to a guard row past the end that is cut off again, so no write needs a
host-side mask.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from slamref.config import SLAMConfig
from slamref.core import camera as cam
from slamref.core import containers, lie
from slamref.core.camera import Intrinsics
from slamref.frontend.tracker import (KeyframeBlock,
                                                             points_in_boxes)
from slamref.ops import hamming, linalg_small as ls

UNLABELED = 0  # category id for observations outside every detection bbox
INT32_MAX = 2 ** 31 - 1


class Detections(NamedTuple):
    """Fixed-capacity 2D detections."""

    boxes: torch.Tensor      # (D, 4) x1,y1,x2,y2 pixels
    category: torch.Tensor   # (D,) int64 — semantic class id (>0)
    score: torch.Tensor      # (D,)
    mask: torch.Tensor       # (D,) bool

    @classmethod
    def empty(cls, capacity: int, device="cuda") -> "Detections":
        dev = torch.device(device)
        return cls(torch.zeros((capacity, 4), dtype=torch.float32, device=dev),
                   torch.zeros(capacity, dtype=torch.int64, device=dev),
                   torch.zeros(capacity, dtype=torch.float32, device=dev),
                   torch.zeros(capacity, dtype=torch.bool, device=dev))


class KeyframeDB(NamedTuple):
    """Ring of recent keyframes (poses later refined by BA)."""

    q: torch.Tensor          # (F, 4) camera-to-world
    t: torch.Tensor          # (F, 3)
    stamp: torch.Tensor      # (F,)
    frame_idx: torch.Tensor  # (F,) int32
    active: torch.Tensor     # (F,) bool
    next_slot: torch.Tensor  # () int32 — monotone counter; slot = n % F
    count: torch.Tensor      # () int32 — total keyframes ever inserted


class LandmarkMap(NamedTuple):
    xyz: torch.Tensor         # (L, 3) world positions
    desc_bits: torch.Tensor   # (L, 256) newest matched descriptor
    desc_anchor: torch.Tensor  # (L, 256) creation-time descriptor
    category: torch.Tensor    # (L,) int32
    n_obs: torch.Tensor       # (L,) int32
    last_seen: torch.Tensor   # (L,) f32 seconds
    active: torch.Tensor      # (L,) bool
    obs_uv: torch.Tensor      # (L, M, 2) ring of observed pixels
    obs_kf: torch.Tensor      # (L, M) int32 MONOTONE keyframe sequence number
    obs_valid: torch.Tensor   # (L, M) bool
    obs_head: torch.Tensor    # (L,) int32 ring write position
    next_id: torch.Tensor     # () int32 global landmark id counter


class MapState(NamedTuple):
    landmarks: LandmarkMap
    keyframes: KeyframeDB


def init_map(cfg: SLAMConfig, device="cuda") -> MapState:
    dev = torch.device(device)
    l = cfg.map.max_landmarks
    m = cfg.map.max_obs_per_landmark
    f = cfg.map.max_keyframes
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    u8 = dict(dtype=torch.uint8, device=dev)
    bl = dict(dtype=torch.bool, device=dev)
    return MapState(
        LandmarkMap(
            xyz=torch.zeros((l, 3), **f32),
            desc_bits=torch.zeros((l, 256), **u8),
            desc_anchor=torch.zeros((l, 256), **u8),
            category=torch.zeros(l, **i32), n_obs=torch.zeros(l, **i32),
            last_seen=torch.zeros(l, **f32), active=torch.zeros(l, **bl),
            obs_uv=torch.zeros((l, m, 2), **f32),
            obs_kf=torch.zeros((l, m), **i32),
            obs_valid=torch.zeros((l, m), **bl),
            obs_head=torch.zeros(l, **i32),
            next_id=torch.zeros((), **i32)),
        KeyframeDB(
            q=lie.quat_identity(device=dev)[None].repeat(f, 1),
            t=torch.zeros((f, 3), **f32), stamp=torch.zeros(f, **f32),
            frame_idx=torch.zeros(f, **i32), active=torch.zeros(f, **bl),
            next_slot=torch.zeros((), **i32), count=torch.zeros((), **i32)))


def _set_drop(arr: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """Functional arr[idx] = vals along dim 0, where idx == len(arr) marks a
    dropped write (the guard row)."""
    n = arr.shape[0]
    ext = torch.cat([arr, arr[:1]], 0)
    ext[idx] = vals.to(arr.dtype).expand((idx.shape[0],) + arr.shape[1:])
    return ext[:n]


def _add_drop(arr: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor
              ) -> torch.Tensor:
    n = arr.shape[0]
    ext = torch.cat([arr, arr[:1]], 0)
    ext = ext.index_add(0, idx, vals.to(arr.dtype))
    return ext[:n]


def _set2_drop(arr: torch.Tensor, row: torch.Tensor, col, vals) -> torch.Tensor:
    """Functional arr[row, col] = vals for an (L, M, ...) ring; row == L
    drops the write."""
    l, m = arr.shape[:2]
    flat = arr.reshape((l * m,) + arr.shape[2:])
    idx = torch.where(row < l, row * m + col, l * m)
    return _set_drop(flat, idx, vals).reshape(arr.shape)


# ---------------------------------------------------------------------------
# Semantic categorization
# ---------------------------------------------------------------------------

def categorize(uv: torch.Tensor, det: Detections) -> torch.Tensor:
    """(C,2) pixels → (C,) category ids: first detection bbox containing the
    pixel wins; UNLABELED outside all boxes."""
    inside = points_in_boxes(uv, det.boxes, det.mask)          # (C, D)
    first = torch.argmax(inside.to(torch.uint8), dim=1)
    any_hit = inside.any(1)
    return torch.where(any_hit, det.category.long()[first], UNLABELED)


# ---------------------------------------------------------------------------
# Association
# ---------------------------------------------------------------------------

def associate(cfg: SLAMConfig, k: Intrinsics, lm: LandmarkMap,
              kf: KeyframeBlock, obs_cat: torch.Tensor,
              obs_keep: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (assoc_idx (C,), matched (C,)): best same-category landmark with
    Hamming < 50 and reprojection < 5 px, by lowest reprojection error;
    one observation per landmark (lowest cost, then lowest slot)."""
    d2 = hamming.hamming_matrix(
        kf.desc_bits, torch.cat([lm.desc_bits, lm.desc_anchor], 0))
    l_cap = lm.desc_bits.shape[0]
    d = torch.minimum(d2[:, :l_cap], d2[:, l_cap:])               # (C, L)
    uv_proj = cam.reproject_world(k, kf.q_wc, kf.t_wc, lm.xyz)     # (L, 2)
    xyz_c = cam.world_to_camera(kf.q_wc, kf.t_wc, lm.xyz)
    reproj = torch.linalg.vector_norm(kf.uv[:, None, :] - uv_proj[None], dim=-1)
    cand = (d < cfg.association.max_hamming) \
        & (reproj < cfg.association.max_reprojection_px) \
        & (xyz_c[None, :, 2] > 0.0) \
        & (obs_cat[:, None] == lm.category[None, :].long()) \
        & lm.active[None, :] & obs_keep[:, None]
    inf = torch.full((), float("inf"), device=reproj.device)
    cost = torch.where(cand, reproj, inf)
    idx = torch.argmin(cost, dim=1)
    min_cost = torch.amin(cost, dim=1)
    matched = torch.isfinite(min_cost)
    best = torch.full((l_cap,), float("inf"), device=cost.device).scatter_reduce(
        0, idx, torch.where(matched, min_cost, inf), reduce="amin")
    is_best = matched & (min_cost <= best[idx] + 1e-9)
    slots = torch.arange(idx.shape[0], device=idx.device)
    first = torch.full((l_cap,), INT32_MAX, dtype=torch.int64,
                       device=idx.device).scatter_reduce(
        0, idx, torch.where(is_best, slots, INT32_MAX), reduce="amin")
    matched = is_best & (slots == first[idx])
    return idx, matched


# ---------------------------------------------------------------------------
# Multi-view triangulation
# ---------------------------------------------------------------------------

def triangulate_rings(cfg: SLAMConfig, k: Intrinsics, obs_uv: torch.Tensor,
                      obs_kf: torch.Tensor, obs_valid: torch.Tensor,
                      active: torch.Tensor, kdb: KeyframeDB
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched N-view DLT over (N, M) observation rings → (xyz (N,3),
    accept (N,)).  Gates: max pairwise parallax >= 5°, mean reprojection
    <= 2 px, 0.1 < z_cam < 10 in the newest observing keyframe; projection
    P = K[Rᵀ|−Rᵀt]."""
    m = obs_kf.shape[1]
    f_cap = kdb.q.shape[0]
    slots = torch.remainder(obs_kf, f_cap).long()
    q_kf = kdb.q[slots]                      # (N, M, 4)
    t_kf = kdb.t[slots]                      # (N, M, 3)
    live = obs_kf >= (kdb.next_slot - f_cap)
    valid = obs_valid & live

    xn = (obs_uv[..., 0] - k.cx) / k.fx
    yn = (obs_uv[..., 1] - k.cy) / k.fy

    r_wc = lie.quat_to_mat(q_kf)
    r_cw = r_wc.transpose(-1, -2)
    t_cw = -torch.einsum("lmij,lmj->lmi", r_cw, t_kf)
    p = torch.cat([r_cw, t_cw[..., None]], -1)                   # (N, M, 3, 4)

    row_u = xn[..., None] * p[..., 2, :] - p[..., 0, :]
    row_v = yn[..., None] * p[..., 2, :] - p[..., 1, :]
    w = valid[..., None].to(torch.float32)
    a = torch.cat([row_u * w, row_v * w], 1)                     # (N, 2M, 4)
    ata = torch.einsum("lri,lrj->lij", a, a)
    h = ls.smallest_eigvec(ata)
    h3 = h[..., 3:]
    xyz = h[..., :3] / torch.where(torch.abs(h3) < 1e-12, 1e-12, h3)

    rays = xyz[:, None, :] - t_kf
    rays = rays / torch.clamp(torch.linalg.vector_norm(rays, dim=-1,
                                                       keepdim=True), min=1e-9)
    cosang = torch.einsum("lmi,lni->lmn", rays, rays)
    pair_ok = valid[:, :, None] & valid[:, None, :]
    min_cos = torch.where(pair_ok, cosang, 1.0).amin(dim=(1, 2))
    cos_min_parallax = torch.cos(torch.deg2rad(torch.full(
        (), cfg.triangulation.min_parallax_deg, dtype=torch.float32,
        device=min_cos.device)))
    parallax_ok = min_cos < cos_min_parallax

    xc = torch.einsum("lmij,lmj->lmi", r_cw,
                      xyz[:, None, :].expand(-1, m, -1)) + t_cw
    z = xc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    up = k.fx * xc[..., 0] / zs + k.cx
    vp = k.fy * xc[..., 1] / zs + k.cy
    err = torch.sqrt((up - obs_uv[..., 0]) ** 2 + (vp - obs_uv[..., 1]) ** 2)
    n_valid = valid.sum(1)
    nv = torch.clamp(n_valid, min=1)
    mean_err = torch.where(valid, err, 0.0).sum(1) / nv
    behind = (valid & (z <= 0.0)).any(1)

    newest = torch.argmax(torch.where(valid, obs_kf, -1), dim=1)
    z_new = torch.gather(z, 1, newest[:, None])[:, 0]
    depth_ok = (z_new > cfg.triangulation.min_depth) & \
        (z_new < cfg.triangulation.max_depth)

    accept = active & (n_valid >= 2) & parallax_ok \
        & (mean_err <= cfg.triangulation.max_reprojection_px) \
        & depth_ok & ~behind
    return xyz, accept


def triangulate_all(cfg: SLAMConfig, k: Intrinsics, lm: LandmarkMap,
                    kdb: KeyframeDB) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-map N-view DLT (every landmark's ring) — see triangulate_rings."""
    return triangulate_rings(cfg, k, lm.obs_uv, lm.obs_kf, lm.obs_valid,
                             lm.active, kdb)


# ---------------------------------------------------------------------------
# Pruning
# ---------------------------------------------------------------------------

def prune(cfg: SLAMConfig, lm: LandmarkMap, now: torch.Tensor) -> LandmarkMap:
    """Deactivate landmarks with < min_observations that haven't been seen
    for max_age_s; their slots become reallocatable."""
    stale = (lm.n_obs < cfg.prune.min_observations) & \
        ((now - lm.last_seen) > cfg.prune.max_age_s)
    keep = lm.active & ~stale
    return lm._replace(active=keep, obs_valid=lm.obs_valid & keep[:, None],
                       n_obs=torch.where(keep, lm.n_obs, 0),
                       obs_head=torch.where(keep, lm.obs_head, 0))


# ---------------------------------------------------------------------------
# Keyframe ingestion
# ---------------------------------------------------------------------------

def insert_keyframe(cfg: SLAMConfig, state: MapState, kf: KeyframeBlock,
                    det: Detections, filtered_mask: torch.Tensor
                    ) -> Tuple[MapState, dict]:
    """categorize → semantic-filter → associate → update/insert landmarks →
    append keyframe → triangulate the touched landmarks."""
    k = Intrinsics.from_config(cfg.camera)
    lm, kdb = state.landmarks, state.keyframes
    l_cap = lm.xyz.shape[0]
    m_ring = lm.obs_uv.shape[1]
    c_cap = kf.uv.shape[0]
    dev = kf.uv.device

    obs_cat = categorize(kf.uv, det)
    obs_keep = kf.mask & ~filtered_mask[obs_cat]

    f_cap = kdb.q.shape[0]
    kf_seq = kdb.next_slot
    slot = torch.remainder(kdb.next_slot, f_cap).long()

    assoc_idx, matched = associate(cfg, k, lm, kf, obs_cat, obs_keep)

    # --- update matched landmarks --------------------------------------
    upd_idx = torch.where(matched, assoc_idx, l_cap)
    one_if = matched.to(torch.int32)
    head = torch.remainder(lm.obs_head[assoc_idx], m_ring).long()
    stamp = kf.timestamp.expand(c_cap)
    lm = lm._replace(
        desc_bits=_set_drop(lm.desc_bits, upd_idx, kf.desc_bits),
        last_seen=_set_drop(lm.last_seen, upd_idx, stamp),
        n_obs=_add_drop(lm.n_obs, upd_idx, one_if),
        obs_uv=_set2_drop(lm.obs_uv, upd_idx, head, kf.uv),
        obs_kf=_set2_drop(lm.obs_kf, upd_idx, head, kf_seq.expand(c_cap)),
        obs_valid=_set2_drop(lm.obs_valid, upd_idx, head,
                             torch.ones(c_cap, dtype=torch.bool, device=dev)),
        obs_head=_add_drop(lm.obs_head, upd_idx, one_if))

    # --- insert unmatched as new landmarks (free slots by prefix sums) ---
    is_new = obs_keep & ~matched
    free = ~lm.active
    free_rank = torch.cumsum(free.long(), 0) - 1
    new_rank = torch.cumsum(is_new.long(), 0) - 1
    n_free = free.sum()
    free_slots = _set_drop(
        torch.full_like(free_rank, l_cap),
        torch.where(free, free_rank, l_cap),
        torch.arange(l_cap, device=dev))
    can_alloc = is_new & (new_rank < n_free)
    dest = torch.where(can_alloc,
                       free_slots[torch.clamp(new_rank, 0, l_cap - 1)], l_cap)
    zero_col = torch.zeros_like(dest)
    lm = lm._replace(
        xyz=_set_drop(lm.xyz, dest, kf.xyz_w),
        desc_bits=_set_drop(lm.desc_bits, dest, kf.desc_bits),
        desc_anchor=_set_drop(lm.desc_anchor, dest, kf.desc_bits),
        category=_set_drop(lm.category, dest, obs_cat),
        n_obs=_set_drop(lm.n_obs, dest, can_alloc.to(torch.int32)),
        last_seen=_set_drop(lm.last_seen, dest, stamp),
        active=_set_drop(lm.active, dest,
                         torch.ones(c_cap, dtype=torch.bool, device=dev)),
        obs_uv=_set2_drop(lm.obs_uv, dest, zero_col, kf.uv),
        obs_kf=_set2_drop(lm.obs_kf, dest, zero_col, kf_seq.expand(c_cap)),
        obs_valid=_set2_drop(lm.obs_valid, dest, zero_col, can_alloc),
        obs_head=_set_drop(lm.obs_head, dest,
                           torch.ones(c_cap, dtype=torch.int32, device=dev)),
        next_id=lm.next_id + can_alloc.sum().to(torch.int32))

    # --- append keyframe -------------------------------------------------
    sl = slot[None]
    kdb = kdb._replace(
        q=kdb.q.index_copy(0, sl, kf.q_wc[None]),
        t=kdb.t.index_copy(0, sl, kf.t_wc[None]),
        stamp=kdb.stamp.index_copy(0, sl, kf.timestamp.reshape(1)),
        frame_idx=kdb.frame_idx.index_copy(
            0, sl, kf.frame_idx.reshape(1).to(torch.int32)),
        active=kdb.active.index_copy(
            0, sl, torch.ones(1, dtype=torch.bool, device=dev)),
        next_slot=kdb.next_slot + 1, count=kdb.count + 1)

    # --- triangulation refinement of the touched landmarks ----------------
    touched = torch.where(matched, assoc_idx, torch.where(can_alloc, dest, l_cap))
    tg = torch.clamp(touched, 0, l_cap - 1)
    new_xyz, tri_ok = triangulate_rings(
        cfg, k, lm.obs_uv[tg], lm.obs_kf[tg], lm.obs_valid[tg],
        lm.active[tg] & (touched < l_cap), kdb)
    lm = lm._replace(xyz=_set_drop(lm.xyz, torch.where(tri_ok, touched, l_cap),
                                   new_xyz))

    stats = dict(
        n_obs_kept=obs_keep.sum(), n_matched=matched.sum(),
        n_new=can_alloc.sum(), n_triangulated=tri_ok.sum(),
        n_active=lm.active.sum(),
        dropped_no_capacity=(is_new & ~can_alloc).sum())
    return MapState(lm, kdb), stats


# ---------------------------------------------------------------------------
# Streams as a leading dimension (the fleet)
# ---------------------------------------------------------------------------

def insert_keyframe_streams(cfg: SLAMConfig, state: MapState,
                            kf: KeyframeBlock, det: Detections,
                            filtered_mask: torch.Tensor,
                            insert: torch.Tensor) -> MapState:
    """``insert_keyframe`` for S independent maps at once (every leaf with
    a leading stream dim S), kept only for the streams whose ``insert``
    (S,) flag is set: one vmapped program for all streams, selected on the
    device, as the reference's vmapped masked insert."""
    new = torch.func.vmap(lambda s, k, d: insert_keyframe(
        cfg, s, k, d, filtered_mask)[0])(state, kf, det)
    return containers.tree_map2(
        lambda a, b: torch.where(
            insert.reshape(insert.shape + (1,) * (a.ndim - 1)), b, a),
        state, new)


def prune_streams(cfg: SLAMConfig, lm: LandmarkMap, now: torch.Tensor
                  ) -> LandmarkMap:
    """``prune`` of S landmark maps (leading dim S) at one time ``now``."""
    return torch.func.vmap(lambda m: prune(cfg, m, now))(lm)
