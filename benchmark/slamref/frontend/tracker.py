"""RGB-D tracking: depth gate → match to the previous frame → F-RANSAC →
PnP → motion gate → pose chain → keyframe policy → keyframe payload.

Port of the reference package's ``frontend/tracker.py``.  ``track_step``
tracks one frame exactly as the reference's ``track_step`` (the anchored
PnP runs unconditionally, and the pose chain composes the INVERSE of the
frame-to-frame PnP transform); ``track_streams`` does the same for S
independent streams at once (the fleet's step: the reference vmaps its
``track_step``), and ``track_step`` is its one-stream case.  ``track_batch``:
every stage whose inputs do not depend on the previous frame's OUTPUT runs
batched over the B frames (depth gating, matching, F-RANSAC, frame-to-frame
PnP, the speculative keyframe-anchored PnP, payload selection), and a short
Python loop over the frames keeps only the state-dependent core.  The loop
never reads a device value on the host: the reference's ``lax.cond``
recompute (frames after a keyframe inserted earlier in the same batch)
is evaluated for every frame but the first and selected with
``torch.where``, which gives the same values.

Randomness: the reference splits a threefry key per frame into (F-RANSAC,
PnP, anchor) keys.  Here a ``sampler`` callable provides the RANSAC minimal
sets; the default draws them from the caller's ``torch.Generator``.  Tests
pass a sampler that returns the reference's own draws.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from slamref.config import SLAMConfig
from slamref.core import camera as cam
from slamref.core import containers, lie
from slamref.core.camera import Intrinsics
from slamref.frontend import ransac
from slamref.frontend.orb import Keypoints, extract
from slamref.ops import hamming

# sampler(stage, frame_ids, n_hyp, sample_size, count) → (F, n_hyp, size)
# int64 indices into the compacted valid set; stage ∈ {"fm", "pnp",
# "anchor"}, frame_ids (F,) int64 = global frame indices, count (F,).
Sampler = Callable[[str, torch.Tensor, int, int, torch.Tensor], torch.Tensor]


class KeyframeBlock(NamedTuple):
    """Fixed-capacity keyframe payload (leading dims (...) = frames)."""

    q_wc: torch.Tensor        # (..., 4) camera-to-world rotation (optical)
    t_wc: torch.Tensor        # (..., 3)
    uv: torch.Tensor          # (..., C, 2) pixel observations
    xyz_w: torch.Tensor       # (..., C, 3) backprojected world positions
    desc_bits: torch.Tensor   # (..., C, 256)
    desc_packed: torch.Tensor  # (..., C, 32)
    response: torch.Tensor    # (..., C)
    mask: torch.Tensor        # (..., C)
    frame_idx: torch.Tensor   # (...) int32
    timestamp: torch.Tensor   # (...) float32 seconds


class TrackerState(NamedTuple):
    """The reference's TrackerState without its ``rng`` key: randomness
    comes from the sampler / generator the caller owns."""

    q_wc: torch.Tensor            # (4,) accumulated camera-to-world pose
    t_wc: torch.Tensor            # (3,)
    prev: Keypoints               # previous frame's depth-valid keypoints
    prev_depth: torch.Tensor      # (K,) metric depth at prev keypoints
    has_prev: torch.Tensor        # () bool
    kf_desc_bits: torch.Tensor    # (C,256) last keyframe descriptors
    kf_mask: torch.Tensor         # (C,)
    kf_xyz_w: torch.Tensor        # (C,3) last keyframe world points
    has_kf: torch.Tensor          # () bool
    frames_since_kf: torch.Tensor  # () int32
    frame_idx: torch.Tensor       # () int32
    q_rel: torch.Tensor           # (4,) last accepted prev→curr transform
    t_rel: torch.Tensor           # (3,)


class TrackOutput(NamedTuple):
    q_wc: torch.Tensor
    t_wc: torch.Tensor
    tracking_ok: torch.Tensor     # pose was updated this frame
    n_features: torch.Tensor      # depth-valid keypoints
    n_matches: torch.Tensor       # hamming-gated matches
    n_inliers: torch.Tensor       # fundamental inliers
    n_pnp_inliers: torch.Tensor
    is_keyframe: torch.Tensor
    keyframe: KeyframeBlock       # built every frame; INSERT iff is_keyframe


def init_state(cfg: SLAMConfig, device="cuda") -> TrackerState:
    dev = torch.device(device)
    k = cfg.orb.max_keypoints
    c = cfg.map.max_obs_per_keyframe
    f32 = dict(dtype=torch.float32, device=dev)
    zkp = Keypoints(
        uv=torch.zeros((k, 2), **f32), response=torch.zeros(k, **f32),
        angle=torch.zeros(k, **f32),
        octave=torch.zeros(k, dtype=torch.int32, device=dev),
        desc_bits=torch.zeros((k, 256), dtype=torch.uint8, device=dev),
        desc_packed=torch.zeros((k, 32), dtype=torch.uint8, device=dev),
        mask=torch.zeros(k, dtype=torch.bool, device=dev))
    false = torch.zeros((), dtype=torch.bool, device=dev)
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    return TrackerState(
        q_wc=lie.quat_identity(device=dev), t_wc=torch.zeros(3, **f32),
        prev=zkp, prev_depth=torch.zeros(k, **f32), has_prev=false,
        kf_desc_bits=torch.zeros((c, 256), dtype=torch.uint8, device=dev),
        kf_mask=torch.zeros(c, dtype=torch.bool, device=dev),
        kf_xyz_w=torch.zeros((c, 3), **f32), has_kf=false.clone(),
        frames_since_kf=zero_i, frame_idx=zero_i.clone(),
        q_rel=lie.quat_identity(device=dev), t_rel=torch.zeros(3, **f32))


def generator_sampler(generator: torch.Generator) -> Sampler:
    """The default sampler: minimal sets drawn from ``generator``."""
    def sampler(stage, frame_ids, n_hyp, size, count):
        return ransac.sample_indices(generator, n_hyp, size, count)
    return sampler


def _depth_at(depth_m: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Nearest-pixel metric depth lookup; depth (B, H, W), uv (B, K, 2)."""
    h, w = depth_m.shape[-2:]
    x = torch.clamp(torch.round(uv[..., 0]).long(), 0, w - 1)
    y = torch.clamp(torch.round(uv[..., 1]).long(), 0, h - 1)
    flat = depth_m.reshape(depth_m.shape[:-2] + (h * w,))
    return torch.gather(flat, -1, y * w + x)


def _select_keyframe_features(cfg: SLAMConfig, kps: Keypoints,
                              fm_inlier_curr: torch.Tensor) -> torch.Tensor:
    """All fundamental inliers + the top cull_top_unmatched unmatched
    keypoints with response >= cull_min_response → (..., K) keep mask."""
    unmatched = kps.mask & ~fm_inlier_curr & \
        (kps.response >= cfg.keyframe.cull_min_response)
    top_mask = containers.topk_mask_int(kps.response, unmatched,
                                        cfg.keyframe.cull_top_unmatched)
    return (fm_inlier_curr & kps.mask) | top_mask


def points_in_boxes(uv: torch.Tensor, boxes: torch.Tensor,
                    box_mask: torch.Tensor) -> torch.Tensor:
    """(..., K, 2) pixels × (..., D, 4) xyxy boxes (+ (..., D) validity) →
    (..., K, D) containment, edge-inclusive on all four box edges."""
    u, v = uv[..., :, None, 0], uv[..., :, None, 1]
    b = boxes[..., None, :, :]
    return ((u >= b[..., 0]) & (u <= b[..., 2]) & (v >= b[..., 1])
            & (v <= b[..., 3]) & box_mask[..., None, :])


def _where(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.where with the condition broadcast from the left (a (...) flag
    selecting whole trailing rows)."""
    return torch.where(c.reshape(c.shape + (1,) * (a.ndim - c.ndim)), a, b)


def _shift(carry0: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Previous-frame chain: frame 0 ← carry, frame i ← a[i-1]."""
    return torch.cat([carry0[None].to(a.dtype), a[:-1]], 0)


def _pnp(cfg: SLAMConfig, k: Intrinsics, xyz, uv, mask, samples, prior_q,
         prior_t):
    return ransac.pnp_ransac(
        k, xyz, uv, mask, n_hyp=cfg.ransac.pnp_iterations,
        threshold=cfg.ransac.pnp_threshold_px,
        min_inliers=cfg.ransac.min_pnp_matches,
        refine_iters=cfg.ransac.refine_iterations, prior_q=prior_q,
        prior_t=prior_t, samples=samples)


def track_step(cfg: SLAMConfig, state: TrackerState, gray: torch.Tensor,
               depth_m: torch.Tensor, timestamp: torch.Tensor,
               sampler: Sampler, det=None, filtered=None,
               kps: Optional[Keypoints] = None
               ) -> Tuple[TrackerState, TrackOutput]:
    """One frame.  gray (H, W) uint8 or float32; depth_m (H, W) uint16
    millimetres or float32 metres; timestamp () float32 sequence-relative
    seconds.  det/filtered (optional) enable frontend semantic culling; kps
    (optional) replaces the in-step extraction.  The RANSAC draws come from
    ``sampler`` with this frame's index (stages "fm", "pnp", "anchor").
    ``track_streams`` on one stream."""
    if kps is None:
        kps = extract(gray, cfg.orb)
    one = lambda x: x[None]  # noqa: E731
    new_state, out = track_streams(
        cfg, containers.tree_map(one, state), containers.tree_map(one, kps),
        depth_m[None], timestamp.reshape(1), sampler,
        det=None if det is None else containers.tree_map(one, det),
        filtered=filtered)
    first = lambda x: x[0]  # noqa: E731
    return containers.tree_map(first, new_state), \
        containers.tree_map(first, out)


def track_streams(cfg: SLAMConfig, state: TrackerState, kps: Keypoints,
                  depth_m: torch.Tensor, timestamp: torch.Tensor,
                  sampler: Sampler, det=None, filtered=None
                  ) -> Tuple[TrackerState, TrackOutput]:
    """``track_step`` for S independent streams at once: every leaf of
    ``state``, ``kps``, ``det`` and the outputs has a leading stream dim S;
    depth_m (S, H, W), timestamp (S,).  Each stream's frame is tracked
    exactly as ``track_step`` tracks it, as S independent frame pairs
    through the batched stages of ``track_batch``; each stage draws every
    stream's minimal sets in one ``sampler`` call with the streams' frame
    indices (S,)."""
    if depth_m.dtype == torch.uint16:
        depth_m = depth_m.to(torch.float32) * 1e-3
    elif depth_m.dtype != torch.float32:
        depth_m = depth_m.to(torch.float32)
    k = Intrinsics.from_config(cfg.camera)
    ids = state.frame_idx.long()
    max_ham = float(cfg.match.max_hamming)

    def draws(stage, n_hyp, size, valid):
        return sampler(stage, ids, n_hyp, size, valid.sum(-1))

    # --- depth filter + semantic cull ---------------------------------------
    z = _depth_at(depth_m, kps.uv)
    mask = kps.mask & (z > cfg.depth.min_depth) & (z < cfg.depth.max_depth)
    if det is not None and filtered is not None \
            and cfg.semantic.cull_in_frontend:
        drop_box = det.mask & filtered[det.category]              # (S, D)
        mask = mask & ~points_in_boxes(kps.uv, det.boxes, drop_box).any(-1)
    kps = kps._replace(mask=mask)
    n_feat = mask.sum(-1)
    lost = n_feat == 0

    # --- match current → previous, F-RANSAC ----------------------------------
    m = hamming.match(kps.desc_bits, state.prev.desc_bits, kps.mask,
                      state.prev.mask & state.has_prev[:, None],
                      max_distance=max_ham)
    n_match = m.valid.sum(-1)
    uv_prev = containers.bgather(state.prev.uv, m.train_idx, 1)
    fm = ransac.fundamental_ransac(
        uv_prev, kps.uv, m.valid, threshold=cfg.ransac.fm_threshold_px,
        samples=draws("fm", cfg.ransac.fm_iterations, 8, m.valid))
    fm_inlier = fm.inliers & fm.valid[:, None]
    n_inlier = fm_inlier.sum(-1)

    # --- PnP: previous-frame 3D → current pixels, constant-velocity prior ----
    z_prev = torch.gather(state.prev_depth, 1, m.train_idx)
    pnp_ok = fm_inlier & (z_prev > cfg.depth.min_depth) & \
        (z_prev <= cfg.depth.max_depth)
    xyz_prev = cam.backproject(k, uv_prev, z_prev)
    pnp = _pnp(cfg, k, xyz_prev, kps.uv, pnp_ok,
               draws("pnp", cfg.ransac.pnp_iterations, 6, pnp_ok),
               state.q_rel, state.t_rel)
    q_inv, t_inv = lie.se3_inverse(pnp.q, pnp.t)
    motion_ok = (torch.linalg.vector_norm(t_inv, dim=-1)
                 <= cfg.motion.max_translation_m) & \
        (torch.linalg.vector_norm(lie.so3_log(q_inv), dim=-1)
         <= cfg.motion.max_rotation_rad)
    accept = pnp.valid & motion_ok & state.has_prev & ~lost
    # T_wc ← T_wc ∘ T_prev←curr
    q_new, t_new = lie.se3_compose(state.q_wc, state.t_wc, q_inv, t_inv)
    q_wc = _where(accept, q_new, state.q_wc)
    t_wc = _where(accept, t_new, state.t_wc)

    # --- keyframe policy match + anchored PnP (unconditional) ----------------
    kf_m = hamming.match(kps.desc_bits, state.kf_desc_bits, kps.mask,
                         state.kf_mask & state.has_kf[:, None],
                         max_distance=max_ham)
    n_kf_matches = kf_m.valid.sum(-1)
    tracked = accept
    q_rel_eff, t_rel_eff = pnp.q, pnp.t
    n_pnp_out = pnp.n_inliers
    if cfg.tracking.anchor_to_keyframe:
        q_pred_cw, t_pred_cw = lie.se3_inverse(q_wc, t_wc)
        anc_ok = kf_m.valid & state.has_kf[:, None]
        kfa = _pnp(cfg, k, containers.bgather(state.kf_xyz_w, kf_m.train_idx,
                                              1),
                   kps.uv, anc_ok,
                   draws("anchor", cfg.ransac.pnp_iterations, 6, anc_ok),
                   q_pred_cw, t_pred_cw)
        q_abs, t_abs = lie.se3_inverse(kfa.q, kfa.t)
        dphi = lie.so3_log(lie.quat_mul(q_abs, lie.quat_conj(q_wc)))
        use_anchor = state.has_kf & kfa.valid & ~lost \
            & (kfa.n_inliers >= cfg.tracking.anchor_min_inliers) \
            & (torch.linalg.vector_norm(t_abs - t_wc, dim=-1)
               <= cfg.tracking.anchor_max_jump_m) \
            & (torch.linalg.vector_norm(dphi, dim=-1)
               <= cfg.tracking.anchor_max_jump_rad)
        q_wc = _where(use_anchor, q_abs, q_wc)
        t_wc = _where(use_anchor, t_abs, t_wc)
        tracked = accept | use_anchor
        q_rel_eff, t_rel_eff = lie.se3_compose(
            *lie.se3_inverse(q_wc, t_wc), state.q_wc, state.t_wc)
        n_pnp_out = torch.where(use_anchor, kfa.n_inliers, pnp.n_inliers)
    is_kf = (~state.has_kf) | \
        (n_kf_matches < cfg.keyframe.min_matches_to_last_kf) | \
        (state.frames_since_kf >= cfg.keyframe.max_frames_between_kf)
    is_kf = is_kf & ~lost & (tracked | (~state.has_prev & ~state.has_kf))

    # --- keyframe payload: culled features + world positions -----------------
    keep = _select_keyframe_features(cfg, kps, fm_inlier)
    keep = torch.where(state.has_prev[:, None], keep, kps.mask)
    cap = cfg.map.max_obs_per_keyframe
    sel = containers.topk_mask_int(kps.response, keep, cap)
    sel_idx = containers.stable_partition(sel)[:, :cap]
    g = lambda x: containers.bgather(x, sel_idx, 1)  # noqa: E731
    xyz_c = cam.backproject(k, g(kps.uv), torch.gather(z, 1, sel_idx))
    kf_block = KeyframeBlock(
        q_wc=q_wc, t_wc=t_wc, uv=g(kps.uv),
        xyz_w=cam.camera_to_world(q_wc[:, None], t_wc[:, None], xyz_c),
        desc_bits=g(kps.desc_bits), desc_packed=g(kps.desc_packed),
        response=torch.gather(kps.response, 1, sel_idx),
        mask=torch.gather(sel, 1, sel_idx), frame_idx=state.frame_idx,
        timestamp=timestamp)

    new_state = TrackerState(
        q_wc=q_wc, t_wc=t_wc, prev=kps, prev_depth=z, has_prev=~lost,
        kf_desc_bits=_where(is_kf, kf_block.desc_bits, state.kf_desc_bits),
        kf_mask=_where(is_kf, kf_block.mask, state.kf_mask),
        kf_xyz_w=_where(is_kf, kf_block.xyz_w, state.kf_xyz_w),
        has_kf=state.has_kf | (is_kf & state.has_prev),
        frames_since_kf=torch.where(is_kf, 0, state.frames_since_kf + 1
                                    ).to(torch.int32),
        frame_idx=(state.frame_idx + 1).to(torch.int32),
        q_rel=_where(tracked, q_rel_eff, state.q_rel),
        t_rel=_where(tracked, t_rel_eff, state.t_rel))
    out = TrackOutput(
        q_wc=q_wc, t_wc=t_wc, tracking_ok=tracked, n_features=n_feat,
        n_matches=n_match, n_inliers=n_inlier, n_pnp_inliers=n_pnp_out,
        is_keyframe=is_kf, keyframe=kf_block)
    return new_state, out


def track_batch(cfg: SLAMConfig, state: TrackerState, kps_b: Keypoints,
                depths: torch.Tensor, timestamps: torch.Tensor,
                sampler: Sampler, dets=None, filtered=None
                ) -> Tuple[TrackerState, TrackOutput]:
    """B frames through the tracker (see module docstring).

    kps_b: Keypoints with leading dim B; depths (B, H, W) uint16 millimetres
    or float32 metres; timestamps (B,) float32 sequence-relative seconds.
    dets/filtered (optional): stacked Detections with leading dim B and the
    filtered-category mask, for frontend semantic culling."""
    k = Intrinsics.from_config(cfg.camera)
    b = timestamps.shape[0]
    dev = depths.device
    if depths.dtype == torch.uint16:
        depths = depths.to(torch.float32) * 1e-3
    elif depths.dtype != torch.float32:
        depths = depths.to(torch.float32)
    frame_ids = state.frame_idx.long() + torch.arange(b, device=dev)
    max_ham = float(cfg.match.max_hamming)

    # --- per-frame prep: depth gate + semantic cull ------------------------
    z_b = _depth_at(depths, kps_b.uv)
    depth_ok = (z_b > cfg.depth.min_depth) & (z_b < cfg.depth.max_depth)
    mask_b = kps_b.mask & depth_ok
    if dets is not None and filtered is not None \
            and cfg.semantic.cull_in_frontend:
        drop_box = dets.mask & filtered[dets.category]            # (B, D)
        mask_b = mask_b & ~points_in_boxes(kps_b.uv, dets.boxes,
                                           drop_box).any(-1)
    kps_b = kps_b._replace(mask=mask_b)
    n_feat = mask_b.sum(-1)
    lost = n_feat == 0

    # --- previous-frame chain (frame 0 ← carry state) ----------------------
    prev_b = Keypoints(*(_shift(c, a) for c, a in zip(state.prev, kps_b)))
    prev_z = _shift(state.prev_depth, z_b)
    has_prev = _shift(state.has_prev, ~lost)

    # --- match + F-RANSAC (batched pairs) ----------------------------------
    m = hamming.match(kps_b.desc_bits, prev_b.desc_bits, kps_b.mask,
                      prev_b.mask & has_prev[:, None], max_distance=max_ham)
    uv_prev = containers.bgather(prev_b.uv, m.train_idx, 1)
    fm_samples = sampler("fm", frame_ids, cfg.ransac.fm_iterations, 8,
                         m.valid.sum(-1))
    fm = ransac.fundamental_ransac(uv_prev, kps_b.uv, m.valid,
                                   threshold=cfg.ransac.fm_threshold_px,
                                   samples=fm_samples)
    fm_inlier_b = fm.inliers & fm.valid[:, None]
    z_prev = torch.gather(prev_z, 1, m.train_idx)
    pnp_ok = fm_inlier_b & (z_prev > cfg.depth.min_depth) & \
        (z_prev <= cfg.depth.max_depth)
    xyz_prev = cam.backproject(k, uv_prev, z_prev)
    n_match = m.valid.sum(-1)
    n_inlier = fm_inlier_b.sum(-1)
    pnp_samples = sampler("pnp", frame_ids, cfg.ransac.pnp_iterations, 6,
                          pnp_ok.sum(-1))

    # pass 1: prior-less (identity stands in, keeping the pool layout);
    # pass 2: constant-velocity prior = previous pair's pass-1 solution
    # (frame 0 ← the carried effective rel), same draws → same random pool
    iq = lie.quat_identity(device=dev).expand(b, 4)
    it = torch.zeros((b, 3), dtype=torch.float32, device=dev)
    pnp1 = _pnp(cfg, k, xyz_prev, kps_b.uv, pnp_ok, pnp_samples, iq, it)
    pq1 = _where(pnp1.valid, pnp1.q, iq)
    pt1 = _where(pnp1.valid, pnp1.t, it)
    pnp = _pnp(cfg, k, xyz_prev, kps_b.uv, pnp_ok, pnp_samples,
               _shift(state.q_rel, pq1), _shift(state.t_rel, pt1))

    # relative motion + gate
    q_inv, t_inv = lie.se3_inverse(pnp.q, pnp.t)
    rvec = lie.so3_log(q_inv)
    motion_ok = (torch.linalg.vector_norm(t_inv, dim=-1)
                 <= cfg.motion.max_translation_m) & \
        (torch.linalg.vector_norm(rvec, dim=-1) <= cfg.motion.max_rotation_rad)
    accept_pnp = pnp.valid & motion_ok & has_prev & ~lost

    # --- pose-chain PREDICTION for the speculative anchor prior -----------
    # prefix compose of the accepted-or-identity rels (the reference's
    # associative_scan); only seeds the anchor's hypothesis pool
    rel_q = _where(accept_pnp, q_inv, iq)
    rel_t = _where(accept_pnp, t_inv, it)
    pre_q, pre_t = [rel_q[0]], [rel_t[0]]
    for i in range(1, b):
        pre_t.append(lie.quat_rotate(pre_q[-1], rel_t[i]) + pre_t[-1])
        pre_q.append(lie.quat_mul(pre_q[-1], rel_q[i]))
    pre_q, pre_t = torch.stack(pre_q), torch.stack(pre_t)
    q_pred = lie.quat_normalize(lie.quat_mul(state.q_wc, pre_q))
    t_pred = lie.quat_rotate(state.q_wc, pre_t) + state.t_wc

    # --- keyframe-policy match + anchored PnP vs the batch-start keyframe --
    anchor = cfg.tracking.anchor_to_keyframe
    kf_m = hamming.match(kps_b.desc_bits, state.kf_desc_bits, kps_b.mask,
                         (state.kf_mask & state.has_kf)[None].expand(b, -1),
                         max_distance=max_ham)
    spec_n_kf = kf_m.valid.sum(-1)
    if anchor:
        q_cw, t_cw = lie.se3_inverse(q_pred, t_pred)
        anc_ok = kf_m.valid & state.has_kf
        anc_samples = sampler("anchor", frame_ids, cfg.ransac.pnp_iterations,
                              6, anc_ok.sum(-1))
        spec = _pnp(cfg, k, state.kf_xyz_w[kf_m.train_idx], kps_b.uv, anc_ok,
                    anc_samples, q_cw, t_cw)

    # --- payload candidates (world lift happens in the loop) ---------------
    keep = _select_keyframe_features(cfg, kps_b, fm_inlier_b)
    keep = torch.where(has_prev[:, None], keep, kps_b.mask)
    cap = cfg.map.max_obs_per_keyframe
    sel = containers.topk_mask_int(kps_b.response, keep, cap)
    sel_idx = containers.stable_partition(sel)[:, :cap]
    sel_valid_b = torch.gather(sel, 1, sel_idx)
    g = lambda x: containers.bgather(x, sel_idx, 1)  # noqa: E731
    sel_uv_b = g(kps_b.uv)
    xyz_c_b = cam.backproject(k, sel_uv_b, torch.gather(z_b, 1, sel_idx))
    sel_bits_b = g(kps_b.desc_bits)
    sel_packed_b = g(kps_b.desc_packed)
    sel_resp_b = torch.gather(kps_b.response, 1, sel_idx)

    # --- the sequential core -------------------------------------------------
    q_wc, t_wc = state.q_wc, state.t_wc
    kf_desc, kf_mask, kf_xyz = state.kf_desc_bits, state.kf_mask, state.kf_xyz_w
    has_kf, since_kf = state.has_kf, state.frames_since_kf
    q_rel, t_rel = state.q_rel, state.t_rel
    kf_dirty = torch.zeros((), dtype=torch.bool, device=dev)
    outs_q, outs_t, outs_tracked, outs_kf, outs_xyz, outs_npnp = \
        [], [], [], [], [], []
    for i in range(b):
        q_wc0, t_wc0 = q_wc, t_wc
        # composes the PnP transform itself (prev→curr), as the reference's
        # track_batch scan does (its xs carry pnp.q/pnp.t), where its
        # per-frame track_step (and ours) composes the inverse; each port
        # follows its reference function (ROADMAP.md §C)
        q_new, t_new = lie.se3_compose(q_wc0, t_wc0, pnp.q[i], pnp.t[i])
        q_wc = torch.where(accept_pnp[i], q_new, q_wc0)
        t_wc = torch.where(accept_pnp[i], t_new, t_wc0)

        n_kf_matches = spec_n_kf[i]
        if anchor:
            kfa_q, kfa_t = spec.q[i], spec.t[i]
            kfa_valid, kfa_n = spec.valid[i], spec.n_inliers[i]
        if i > 0:
            # frames after a keyframe inserted earlier in this batch match
            # against it (the reference's lax.cond recompute branch),
            # evaluated unconditionally and selected on kf_dirty
            rm = hamming.match(kps_b.desc_bits[i], kf_desc, kps_b.mask[i],
                               kf_mask & has_kf, max_distance=max_ham)
            n_kf_matches = torch.where(kf_dirty, rm.valid.sum(), n_kf_matches)
            if anchor:
                qc, tc = lie.se3_inverse(q_wc, t_wc)
                r_ok = rm.valid & has_kf
                r_samples = sampler("anchor", frame_ids[i:i + 1],
                                    cfg.ransac.pnp_iterations, 6,
                                    r_ok.sum()[None])[0]
                rec = _pnp(cfg, k, kf_xyz[rm.train_idx], kps_b.uv[i], r_ok,
                           r_samples, qc, tc)
                kfa_q = torch.where(kf_dirty, rec.q, kfa_q)
                kfa_t = torch.where(kf_dirty, rec.t, kfa_t)
                kfa_valid = torch.where(kf_dirty, rec.valid, kfa_valid)
                kfa_n = torch.where(kf_dirty, rec.n_inliers, kfa_n)

        tracked = accept_pnp[i]
        n_pnp_out = pnp.n_inliers[i]
        if anchor:
            q_abs, t_abs = lie.se3_inverse(kfa_q, kfa_t)
            dphi = lie.so3_log(lie.quat_mul(q_abs, lie.quat_conj(q_wc)))
            use_anchor = has_kf & kfa_valid & ~lost[i] \
                & (kfa_n >= cfg.tracking.anchor_min_inliers) \
                & (torch.linalg.vector_norm(t_abs - t_wc)
                   <= cfg.tracking.anchor_max_jump_m) \
                & (torch.linalg.vector_norm(dphi)
                   <= cfg.tracking.anchor_max_jump_rad)
            q_wc = torch.where(use_anchor, q_abs, q_wc)
            t_wc = torch.where(use_anchor, t_abs, t_wc)
            tracked = tracked | use_anchor
            q_rel_eff, t_rel_eff = lie.se3_compose(
                *lie.se3_inverse(q_wc, t_wc), q_wc0, t_wc0)
            n_pnp_out = torch.where(use_anchor, kfa_n, n_pnp_out)
        else:
            q_rel_eff, t_rel_eff = pnp.q[i], pnp.t[i]

        is_kf = (~has_kf) | \
            (n_kf_matches < cfg.keyframe.min_matches_to_last_kf) | \
            (since_kf >= cfg.keyframe.max_frames_between_kf)
        is_kf = is_kf & ~lost[i] & (tracked | (~has_prev[i] & ~has_kf))

        xyz_w = cam.camera_to_world(q_wc, t_wc, xyz_c_b[i])
        kf_desc = torch.where(is_kf, sel_bits_b[i], kf_desc)
        kf_mask = torch.where(is_kf, sel_valid_b[i], kf_mask)
        kf_xyz = torch.where(is_kf, xyz_w, kf_xyz)
        has_kf = has_kf | (is_kf & has_prev[i])
        since_kf = torch.where(is_kf, 0, since_kf + 1).to(torch.int32)
        q_rel = torch.where(tracked, q_rel_eff, q_rel)
        t_rel = torch.where(tracked, t_rel_eff, t_rel)
        kf_dirty = kf_dirty | is_kf
        outs_q.append(q_wc)
        outs_t.append(t_wc)
        outs_tracked.append(tracked)
        outs_kf.append(is_kf)
        outs_xyz.append(xyz_w)
        outs_npnp.append(n_pnp_out)

    last = Keypoints(*(a[-1] for a in kps_b))
    new_state = TrackerState(
        q_wc=q_wc, t_wc=t_wc, prev=last, prev_depth=z_b[-1],
        has_prev=~lost[-1], kf_desc_bits=kf_desc, kf_mask=kf_mask,
        kf_xyz_w=kf_xyz, has_kf=has_kf, frames_since_kf=since_kf,
        frame_idx=(state.frame_idx + b).to(torch.int32), q_rel=q_rel,
        t_rel=t_rel)

    q_wc_b, t_wc_b = torch.stack(outs_q), torch.stack(outs_t)
    kf_blocks = KeyframeBlock(
        q_wc=q_wc_b, t_wc=t_wc_b, uv=sel_uv_b, xyz_w=torch.stack(outs_xyz),
        desc_bits=sel_bits_b, desc_packed=sel_packed_b,
        response=sel_resp_b, mask=sel_valid_b,
        frame_idx=frame_ids.to(torch.int32), timestamp=timestamps)
    out = TrackOutput(
        q_wc=q_wc_b, t_wc=t_wc_b, tracking_ok=torch.stack(outs_tracked),
        n_features=n_feat, n_matches=n_match, n_inliers=n_inlier,
        n_pnp_inliers=torch.stack(outs_npnp), is_keyframe=torch.stack(outs_kf),
        keyframe=kf_blocks)
    return new_state, out
