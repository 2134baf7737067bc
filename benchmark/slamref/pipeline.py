"""Frozen copy of the port's ``pipeline/slam.py`` functions that a step of
the timed path calls: BA with tracker feedback, the loop / relocalization
verification with its seeded draws, and the loop correction (spread over
the ring, or by the pose graph)."""

from __future__ import annotations

from typing import Optional

import torch

from slamref.backend import ba as ba_mod
from slamref.backend import mapping, pose_graph
from slamref.config import SLAMConfig
from slamref.core import lie
from slamref.core.camera import Intrinsics
from slamref.core.containers import row
from slamref.frontend import ransac, tracker
from slamref.ops import hamming


def _correct_tracker(tstate: tracker.TrackerState, q_c: torch.Tensor,
                     t_c: torch.Tensor) -> tracker.TrackerState:
    """Left-compose a world-frame correction onto the live tracker: pose
    T ← T_c ∘ T, and the stored last-keyframe anchor points x ← R_c x + t_c."""
    return tstate._replace(
        q_wc=lie.quat_normalize(lie.quat_mul(q_c, tstate.q_wc)),
        t_wc=lie.quat_rotate(q_c, tstate.t_wc) + t_c,
        kf_xyz_w=lie.quat_rotate(q_c, tstate.kf_xyz_w) + t_c)


def run_ba_fb(cfg: SLAMConfig, k: Intrinsics, mstate: mapping.MapState,
              tstate: tracker.TrackerState):
    """BA + tracker feedback: left-compose the newest keyframe's BA
    correction onto the live tracker pose, unless it exceeds 0.15 m /
    0.1 rad (a poisoned window)."""
    new_m, res = ba_mod.run_ba(cfg, k, mstate)
    f_cap = cfg.map.max_keyframes
    slot = torch.remainder(mstate.keyframes.next_slot - 1, f_cap).long()
    q_oi, t_oi = lie.se3_inverse(row(mstate.keyframes.q, slot),
                                 row(mstate.keyframes.t, slot))
    q_c, t_c = lie.se3_compose(row(new_m.keyframes.q, slot),
                               row(new_m.keyframes.t, slot), q_oi, t_oi)
    ok = (torch.linalg.vector_norm(t_c) < 0.15) \
        & (torch.linalg.vector_norm(lie.so3_log(q_c)) < 0.1)
    q_c = torch.where(ok, q_c, lie.quat_identity(device=q_c.device))
    t_c = torch.where(ok, t_c, torch.zeros_like(t_c))
    return new_m, _correct_tracker(tstate, q_c, t_c), res


def _ring_seq(kdb: mapping.KeyframeDB, f_cap: int) -> torch.Tensor:
    """(F,) monotone keyframe sequence number of each ring slot."""
    s = torch.arange(f_cap, device=kdb.q.device)
    newest = kdb.next_slot.long() - 1
    return newest - torch.remainder(newest - s, f_cap)


def _seq(x, device) -> torch.Tensor:
    """A keyframe sequence id (int or tensor) as an int64 device scalar; an
    int is filled on the device, not copied from the host."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.int64)
    return torch.full((), x, dtype=torch.int64, device=device)


def apply_loop(cfg: SLAMConfig, tstate: tracker.TrackerState,
               mstate: mapping.MapState, q_pnp: torch.Tensor,
               t_pnp: torch.Tensor, cand_seq, entry_seq):
    """Distribute a verified loop's drift correction over the keyframe ring
    (se3 tangent scaled by keyframe age between the loop endpoints), the
    landmarks (by newest observation) and the live tracker (in full).
    T_corr = T_pnp ∘ T_entry⁻¹ against the entry keyframe's CURRENT ring
    pose; corrections over 1 m or 0.5 rad are no-ops."""
    kdb = mstate.keyframes
    dev = kdb.q.device
    cand_seq, entry_seq = _seq(cand_seq, dev), _seq(entry_seq, dev)
    seq = _ring_seq(kdb, cfg.map.max_keyframes)
    entry_hit = (seq == entry_seq) & kdb.active
    slot = torch.argmax(entry_hit.to(torch.int32))
    q_ei, t_ei = lie.se3_inverse(row(kdb.q, slot), row(kdb.t, slot))
    q_corr, t_corr = lie.se3_compose(q_pnp, t_pnp, q_ei, t_ei)
    ok = entry_hit.any() & (torch.linalg.vector_norm(t_corr) < 1.0) \
        & (torch.linalg.vector_norm(lie.so3_log(q_corr)) < 0.5)
    q_corr = torch.where(ok, q_corr, lie.quat_identity(device=dev))
    t_corr = torch.where(ok, t_corr, torch.zeros_like(t_corr))
    span = torch.clamp(entry_seq - cand_seq, min=1).to(torch.float32)
    alpha = torch.clamp((seq - cand_seq).to(torch.float32) / span, 0.0, 1.0) \
        * kdb.active
    phi = lie.so3_log(q_corr)
    q_a = lie.so3_exp(alpha[:, None] * phi[None])
    q_new = lie.quat_normalize(lie.quat_mul(q_a, kdb.q))
    t_new = lie.quat_rotate(q_a, kdb.t) + alpha[:, None] * t_corr[None]
    act = kdb.active[:, None]
    kdb = kdb._replace(q=torch.where(act, q_new, kdb.q),
                       t=torch.where(act, t_new, kdb.t))
    lm = mstate.landmarks
    lm_seq = torch.where(lm.obs_valid, lm.obs_kf, -1).amax(1)
    al = torch.clamp((lm_seq - cand_seq).to(torch.float32) / span, 0.0, 1.0) \
        * lm.active
    q_l = lie.so3_exp(al[:, None] * phi[None])
    xyz = lie.quat_rotate(q_l, lm.xyz) + al[:, None] * t_corr[None]
    lm = lm._replace(xyz=torch.where(lm.active[:, None], xyz, lm.xyz))
    return (_correct_tracker(tstate, q_corr, t_corr),
            mstate._replace(keyframes=kdb, landmarks=lm))


def apply_loop_pgo(cfg: SLAMConfig, tstate: tracker.TrackerState,
                   mstate: mapping.MapState, q_pnp: torch.Tensor,
                   t_pnp: torch.Tensor, cand_seq, entry_seq):
    """Pose-graph variant of apply_loop: the ring poses come from
    ``pose_graph.optimize_ring``; landmarks follow their newest observing
    keyframe's correction; the live tracker follows the newest keyframe.
    Same entry-correction magnitude gate as apply_loop."""
    f_cap = cfg.map.max_keyframes
    kdb = mstate.keyframes
    dev = kdb.q.device
    cand_seq, entry_seq = _seq(cand_seq, dev), _seq(entry_seq, dev)
    seq = _ring_seq(kdb, f_cap)
    entry_hit = (seq == entry_seq) & kdb.active
    slot = torch.argmax(entry_hit.to(torch.int32))
    q_ei, t_ei = lie.se3_inverse(row(kdb.q, slot), row(kdb.t, slot))
    q_raw, t_raw = lie.se3_compose(q_pnp, t_pnp, q_ei, t_ei)
    res = pose_graph.optimize_ring(kdb.q, kdb.t, kdb.active, seq, q_pnp,
                                   t_pnp, entry_seq, cand_seq)
    ok = entry_hit.any() & res.ok \
        & (torch.linalg.vector_norm(t_raw) < 1.0) \
        & (torch.linalg.vector_norm(lie.so3_log(q_raw)) < 0.5)
    kdb = kdb._replace(q=torch.where(ok, res.q, kdb.q),
                       t=torch.where(ok, res.t, kdb.t))
    lm = mstate.landmarks
    lm_seq = torch.where(lm.obs_valid, lm.obs_kf, -1).amax(1)
    live = lm_seq >= (mstate.keyframes.next_slot - f_cap)
    lslot = torch.remainder(torch.clamp(lm_seq, min=0), f_cap).long()
    xyz = lie.quat_rotate(res.q_corr[lslot], lm.xyz) + res.t_corr[lslot]
    move = ok & lm.active & live & (lm_seq >= 0)
    lm = lm._replace(xyz=torch.where(move[:, None], xyz, lm.xyz))
    ns = torch.remainder(mstate.keyframes.next_slot - 1, f_cap).long()
    q_tc = torch.where(ok, row(res.q_corr, ns), lie.quat_identity(device=dev))
    t_tc = torch.where(ok, row(res.t_corr, ns), torch.zeros_like(t_raw))
    return (_correct_tracker(tstate, q_tc, t_tc),
            mstate._replace(keyframes=kdb, landmarks=lm))


def seeded_sampler(seed: int, device) -> tracker.Sampler:
    """A sampler drawing from a ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def sampler(stage, frame_ids, n_hyp, size, count):
        return ransac.sample_indices(gen, n_hyp, size, count)
    return sampler


def verify_loop(cfg: SLAMConfig, k: Intrinsics, d1, uv1, m1, d2, uv2, m2,
                xyz2, seed: int, sampler: Optional[tracker.Sampler] = None):
    """Geometric loop / relocalization verification of keyframe 1 against
    candidate 2: Hamming cross-check match, F-RANSAC, then PnP of the
    candidate's stored world points against keyframe 1's pixels.
    → (F-RANSAC inliers, q_wc, t_wc of keyframe 1 from PnP, PnP inliers or
    0), all device tensors.  Draws: stages "loop_fm" and "loop_pnp" of
    ``sampler`` with frame id ``seed``, or a generator seeded with it."""
    if sampler is None:
        sampler = seeded_sampler(seed, d1.device)
    ids = torch.full((1,), seed, dtype=torch.int64)

    def draws(stage, n_hyp, size, valid):
        return sampler(stage, ids, n_hyp, size, valid.sum()[None])[0]

    res = hamming.match(d1, d2, m1, m2,
                        max_distance=float(cfg.match.max_hamming),
                        cross_check=True)
    fm = ransac.fundamental_ransac(
        uv2[res.train_idx], uv1, res.valid,
        threshold=cfg.ransac.fm_threshold_px,
        samples=draws("loop_fm", cfg.ransac.fm_iterations, 8, res.valid))
    fm_ok = fm.inliers & fm.valid
    pnp = ransac.pnp_ransac(
        k, xyz2[res.train_idx], uv1, fm_ok,
        n_hyp=cfg.ransac.pnp_iterations,
        threshold=cfg.ransac.loop_pnp_threshold_px,
        min_inliers=cfg.ransac.min_pnp_matches,
        refine_iters=cfg.ransac.refine_iterations,
        samples=draws("loop_pnp", cfg.ransac.pnp_iterations, 6, fm_ok))
    q_wc, t_wc = lie.se3_inverse(pnp.q, pnp.t)
    return (fm_ok.sum(), q_wc, t_wc,
            torch.where(pnp.valid, pnp.n_inliers, 0))

