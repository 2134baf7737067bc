"""Sliding-window bundle adjustment: Levenberg-Marquardt with a Schur
complement over the camera/landmark block system.

Port of the reference package's ``backend/ba.py``: world→camera pose
parameters with 6-DoF left-multiplicative tangent updates, weighted
reprojection residuals with a behind-camera guard, Huber IRLS, soft pose and
point priors, the first active window pose held fixed, Ceres-style λ
updates and termination tolerances.  Observations live on a dense (L, W)
landmark×keyframe grid, so every Jacobian/Hessian block is one einsum and
the reduced camera system is a dense (6W, 6W) solve.

The reference exits its ``lax.while_loop`` once ``done`` latches; here all
``max_iterations`` run with every update masked by ``done`` — the carry is
identical (a latched iteration changes nothing), and no iteration reads a
device value on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dynamic_visual_slam_tpu_torch.config import BAConfig
from dynamic_visual_slam_tpu_torch.core import lie
from dynamic_visual_slam_tpu_torch.core.camera import Intrinsics
from dynamic_visual_slam_tpu_torch.core.containers import topk_stable
from dynamic_visual_slam_tpu_torch.ops import linalg_small as ls
from dynamic_visual_slam_tpu_torch.utils.profiling import TRACER


class BAProblem(NamedTuple):
    """Dense-grid window problem.  W keyframes × L landmarks."""

    q_wc: torch.Tensor       # (W, 4) camera-to-world (optical) — input poses
    t_wc: torch.Tensor       # (W, 3)
    kf_active: torch.Tensor  # (W,) bool
    xyz: torch.Tensor        # (L, 3) world points
    lm_active: torch.Tensor  # (L,) bool
    uv: torch.Tensor         # (L, W, 2) observed pixels
    valid: torch.Tensor      # (L, W) bool


class BAResult(NamedTuple):
    q_wc: torch.Tensor       # (W, 4) optimized camera-to-world
    t_wc: torch.Tensor       # (W, 3)
    xyz: torch.Tensor        # (L, 3) optimized points
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    iterations: torch.Tensor
    converged: torch.Tensor  # () bool
    n_residuals: torch.Tensor


def _residuals(k: Intrinsics, q_cw, t_cw, xyz, uv, valid, sigma):
    """r (L, W, 2) weighted residuals + per-obs validity incl. z-guard."""
    xc = lie.quat_rotate(q_cw[None, :, :], xyz[:, None, :]) + t_cw[None]
    z = xc[..., 2]
    guard = z > 0.1
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = k.fx * xc[..., 0] / zs + k.cx
    v = k.fy * xc[..., 1] / zs + k.cy
    r = torch.stack([u - uv[..., 0], v - uv[..., 1]], -1) / sigma
    ok = valid & guard
    return torch.where(ok[..., None], r, 0.0), ok, xc


def _huber_weight(r: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight of the Huber loss on the residual norm (L, W)."""
    n = torch.linalg.vector_norm(r, dim=-1)
    return torch.where(n <= delta, 1.0, delta / torch.clamp(n, min=1e-12))


def _cost(r: torch.Tensor, ok: torch.Tensor, delta: float) -> torch.Tensor:
    """Total robust cost: Huber(||r||) summed (x0.5 like Ceres)."""
    n2 = (r * r).sum(-1)
    n = torch.sqrt(torch.clamp(n2, min=0.0))
    rho = torch.where(n <= delta, n2, 2.0 * delta * n - delta * delta)
    return 0.5 * torch.where(ok, rho, 0.0).sum()


def _inv3x3(m: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate); inactive → zero block."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    adj = torch.stack([
        torch.stack([co_a, -(b * i - c * h), b * f - c * e], -1),
        torch.stack([co_b, a * i - c * g, -(a * f - c * d)], -1),
        torch.stack([co_c, -(a * h - b * g), a * e - b * d], -1)], -2)
    inv = adj / det[..., None, None]
    return inv * active[..., None, None]


def optimize(k: Intrinsics, problem: BAProblem, cfg: BAConfig) -> BAResult:
    """LM iterations with accept/reject steps (cfg.max_iterations masked
    iterations; iterations after convergence are no-ops)."""
    lcap, wcap = problem.valid.shape
    dev = problem.xyz.device
    sigma = cfg.sigma_px
    eye3 = torch.eye(3, device=dev)
    eye6 = torch.eye(6, device=dev)

    q_cw0, t_cw0 = lie.se3_inverse(problem.q_wc, problem.t_wc)
    obs_ok = problem.valid & problem.lm_active[:, None] \
        & problem.kf_active[None, :]
    n_res = obs_ok.sum()

    # gauge: fix the first ACTIVE window pose
    first_active = torch.cumsum(problem.kf_active.long(), 0) == 1
    gauge_free = problem.kf_active & ~first_active
    gf = gauge_free.to(torch.float32)

    w_rot = 1.0 / cfg.pose_prior_sigma_rot ** 2 \
        if cfg.pose_prior_sigma_rot > 0 else 0.0
    w_trn = 1.0 / cfg.pose_prior_sigma_t ** 2 \
        if cfg.pose_prior_sigma_t > 0 else 0.0
    w_pt_prior = 1.0 / cfg.point_prior_sigma ** 2 \
        if cfg.point_prior_sigma > 0 else 0.0
    wp_diag = torch.cat([torch.full((3,), w_rot, device=dev),
                         torch.full((3,), w_trn, device=dev)])
    if cfg.prior_obs_decay > 0:
        n0 = cfg.prior_obs_decay
        decay_pose = n0 / (n0 + obs_ok.sum(0).to(torch.float32))
        decay_pt = n0 / (n0 + obs_ok.sum(1).to(torch.float32))
    else:
        decay_pose = torch.ones(wcap, device=dev)
        decay_pt = torch.ones(lcap, device=dev)
    wp_pose = wp_diag[None, :] * decay_pose[:, None]               # (W,6)
    wp_pt = w_pt_prior * decay_pt                                  # (L,)
    lm_act = problem.lm_active.to(torch.float32)

    def prior_residuals(q_cw, t_cw, xyz):
        q_err = lie.quat_mul(q_cw, lie.quat_conj(q_cw0))
        dtheta = lie.so3_log(q_err)
        dt = t_cw - lie.quat_rotate(q_err, t_cw0)
        rp_pose = torch.cat([dtheta, dt], -1) * gf[:, None]
        rp_pt = (xyz - problem.xyz) * lm_act[:, None]
        return rp_pose, rp_pt

    def prior_cost(q_cw, t_cw, xyz):
        rp_pose, rp_pt = prior_residuals(q_cw, t_cw, xyz)
        return 0.5 * ((rp_pose * rp_pose * wp_pose).sum()
                      + (wp_pt[:, None] * rp_pt * rp_pt).sum())

    def linearize(q_cw, t_cw, xyz):
        r, ok, xc = _residuals(k, q_cw, t_cw, xyz, problem.uv, obs_ok, sigma)
        w_huber = _huber_weight(r, cfg.huber_delta) * ok
        x0, x1, x2 = xc.unbind(-1)
        iz = 1.0 / torch.where(torch.abs(x2) < 1e-9, 1e-9, x2)
        zeros = torch.zeros_like(iz)
        ju = torch.stack([k.fx * iz, zeros, -k.fx * x0 * iz * iz], -1)
        jv = torch.stack([zeros, k.fy * iz, -k.fy * x1 * iz * iz], -1)
        jp = torch.stack([ju, jv], -2) / sigma                     # (L,W,2,3)
        sk = torch.stack([
            torch.stack([zeros, x2, -x1], -1),
            torch.stack([-x2, zeros, x0], -1),
            torch.stack([x1, -x0, zeros], -1)], -2)
        j_pose = torch.cat([jp @ sk, jp], -1)                      # (L,W,2,6)
        r_cw = lie.quat_to_mat(q_cw)                               # (W,3,3)
        j_pt = jp @ r_cw[None]                                     # (L,W,2,3)
        okf = ok.to(torch.float32)[..., None, None]
        j_pose = j_pose * gf[None, :, None, None] * okf
        j_pt = j_pt * okf
        return r, w_huber, j_pose, j_pt

    def solve_step(q_cw, t_cw, xyz, lam):
        r, wh, j_pose, j_pt = linearize(q_cw, t_cw, xyz)
        whx = wh[..., None, None]
        jpw = j_pose * whx
        jtw = j_pt * whx
        u_blk = torch.einsum("lwri,lwrj->wij", jpw, j_pose)        # (W,6,6)
        v_blk = torch.einsum("lwri,lwrj->lij", jtw, j_pt)          # (L,3,3)
        w_blk = torch.einsum("lwri,lwrj->lwij", jpw, j_pt)         # (L,W,6,3)
        g_pose = torch.einsum("lwri,lwr->wi", jpw, r)              # (W,6)
        g_pt = torch.einsum("lwri,lwr->li", jtw, r)                # (L,3)

        rp_pose, rp_pt = prior_residuals(q_cw, t_cw, xyz)
        u_blk = u_blk + eye6[None] * wp_pose[:, None, :] * gf[:, None, None]
        v_blk = v_blk + wp_pt[:, None, None] * eye3[None] \
            * lm_act[:, None, None]
        g_pose = g_pose + wp_pose * rp_pose
        g_pt = g_pt + wp_pt[:, None] * rp_pt

        du = torch.clamp(torch.diagonal(u_blk, dim1=-2, dim2=-1), 1e-6, 1e32)
        dv = torch.clamp(torch.diagonal(v_blk, dim1=-2, dim2=-1), 1e-6, 1e32)
        u_d = u_blk + lam * du[..., None] * eye6[None]
        v_d = v_blk + lam * dv[..., None] * eye3[None]
        v_inv = _inv3x3(v_d, problem.lm_active)

        wv = torch.einsum("lwij,ljk->lwik", w_blk, v_inv)          # (L,W,6,3)
        s = -torch.einsum("lwik,lvjk->wvij", wv, w_blk)            # (W,W,6,6)
        ar = torch.arange(wcap, device=dev)
        s[ar, ar] = s[ar, ar] + u_d
        rhs = g_pose - torch.einsum("lwik,lk->wi", wv, g_pt)       # (W,6)

        s_dense = s.permute(0, 2, 1, 3).reshape(wcap * 6, wcap * 6)
        free = gauge_free.repeat_interleave(6)
        s_dense = torch.where(free[:, None] & free[None, :], s_dense, 0.0)
        s_dense = s_dense + torch.diag(torch.where(free, 0.0, 1.0))
        rhs_vec = torch.where(free, rhs.reshape(-1), 0.0)

        d_pose = -ls.solve_psd(s_dense, rhs_vec, refine=2).reshape(wcap, 6)
        wtd = torch.einsum("lwij,wi->lj", w_blk, d_pose)
        d_pt = -torch.einsum("lij,lj->li", v_inv, g_pt + wtd)
        d_pt = d_pt * lm_act[:, None]

        dq = lie.so3_exp(d_pose[:, :3])
        q_new = lie.quat_normalize(lie.quat_mul(dq, q_cw))
        t_new = lie.quat_rotate(dq, t_cw) + d_pose[:, 3:]
        x_new = xyz + d_pt
        step_sq = (d_pose * d_pose).sum() + (d_pt * d_pt).sum()
        grad_max = torch.maximum(torch.abs(g_pose).amax(),
                                 torch.abs(g_pt).amax())
        g_dot_d = (g_pose * d_pose).sum() + (g_pt * d_pt).sum()
        dtd = (d_pose * d_pose * du).sum() + (d_pt * d_pt * dv).sum()
        pred = -0.5 * g_dot_d + 0.5 * lam * dtd
        return q_new, t_new, x_new, step_sq, grad_max, pred

    r0, ok0, _ = _residuals(k, q_cw0, t_cw0, problem.xyz, problem.uv,
                            obs_ok, sigma)
    cost0 = _cost(r0, ok0, cfg.huber_delta)

    q_cw, t_cw, xyz, cost = q_cw0, t_cw0, problem.xyz, cost0
    lam = torch.full((), cfg.init_lambda, dtype=torch.float32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    converged_any = done.clone()
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(cfg.max_iterations):
        q_new, t_new, x_new, step_sq, grad_max, pred = solve_step(
            q_cw, t_cw, xyz, lam)
        r_new, ok_new, _ = _residuals(k, q_new, t_new, x_new, problem.uv,
                                      obs_ok, sigma)
        cost_new = _cost(r_new, ok_new, cfg.huber_delta) \
            + prior_cost(q_new, t_new, x_new)
        rho = (cost - cost_new) / torch.clamp(pred, min=1e-20)
        accept = (rho > 1e-3) & (cost_new < cost)
        shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        lam_next = torch.where(accept, torch.clamp(lam * shrink, min=1e-12),
                               torch.clamp(lam * 2.0, max=1e10))
        ftol = torch.abs(cost - cost_new) <= cfg.function_tolerance * \
            torch.clamp(cost, min=1e-30)
        gtol = grad_max <= cfg.gradient_tolerance
        ptol = torch.sqrt(step_sq) <= cfg.parameter_tolerance
        converged = accept & (ftol | gtol | ptol)
        collapsed = lam_next >= 1e7
        upd = accept & ~done
        q_cw = torch.where(upd, q_new, q_cw)
        t_cw = torch.where(upd, t_new, t_cw)
        xyz = torch.where(upd, x_new, xyz)
        cost = torch.where(upd, cost_new, cost)
        lam = torch.where(done, lam, lam_next)
        iters = iters + (~done).to(torch.int32)
        # the reference's while_loop runs an iteration only while not done,
        # so convergence is recorded only for iterations that ran
        converged_any = converged_any | (converged & ~done)
        done = done | converged | collapsed

    q_wc, t_wc = lie.se3_inverse(q_cw, t_cw)
    return BAResult(q_wc=q_wc, t_wc=t_wc, xyz=xyz, initial_cost=cost0,
                    final_cost=cost, iterations=iters,
                    converged=converged_any, n_residuals=n_res)


# ---------------------------------------------------------------------------
# Window extraction / write-back
# ---------------------------------------------------------------------------

def extract_window(cfg, state, max_landmarks: int = 512):
    """MapState → (BAProblem, window_slots, lm_slots).

    Window = the last min(window_size, count) keyframes in the ring;
    landmark set = landmarks observed in the window, capped at
    max_landmarks by in-window observation count (ties → lower slot)."""
    lm, kdb = state.landmarks, state.keyframes
    f_cap = kdb.q.shape[0]
    w = cfg.ba.window_size
    dev = lm.xyz.device

    seq = torch.flip(kdb.next_slot - 1 - torch.arange(w, device=dev), [0])
    window_slots = torch.remainder(seq, f_cap).long()
    kf_active = seq >= 0

    in_win = (lm.obs_kf[:, :, None] == seq[None, None, :]) \
        & lm.obs_valid[:, :, None] & kf_active[None, None, :]
    obs_per_lm = in_win.sum((1, 2))
    score = torch.where(lm.active, obs_per_lm, -1)
    max_landmarks = min(max_landmarks, score.shape[-1])
    _, lm_slots = topk_stable(score, max_landmarks)
    lm_sel_active = score[lm_slots] >= 2

    sel_in_win = in_win[lm_slots]                         # (Lba, M, W)
    has_obs = sel_in_win.any(1)
    first_m = torch.argmax(sel_in_win.to(torch.uint8), dim=1)   # (Lba, W)
    obs_uv = lm.obs_uv[lm_slots]                          # (Lba, M, 2)
    uv = torch.gather(obs_uv, 1, first_m[:, :, None].expand(-1, -1, 2))

    problem = BAProblem(
        q_wc=kdb.q[window_slots], t_wc=kdb.t[window_slots],
        kf_active=kf_active, xyz=lm.xyz[lm_slots], lm_active=lm_sel_active,
        uv=uv, valid=has_obs)
    return problem, window_slots, lm_slots


def apply_result(state, result: BAResult, window_slots, lm_slots,
                 min_valid: bool = True):
    """Write optimized poses/points back into the arenas, gated on a cost
    improvement (the LM loop only accepts cost-decreasing steps)."""
    lm, kdb = state.landmarks, state.keyframes
    improved = result.final_cost < result.initial_cost
    apply = improved if min_valid else torch.ones_like(improved)
    q = torch.where(apply, result.q_wc, kdb.q[window_slots])
    t = torch.where(apply, result.t_wc, kdb.t[window_slots])
    x = torch.where(apply, result.xyz, lm.xyz[lm_slots])
    kdb = kdb._replace(q=kdb.q.index_copy(0, window_slots, q),
                       t=kdb.t.index_copy(0, window_slots, t))
    lm = lm._replace(xyz=lm.xyz.index_copy(0, lm_slots, x))
    return state._replace(landmarks=lm, keyframes=kdb)


def run_ba(cfg, k: Intrinsics, state, max_landmarks: int = 512):
    """One BA round on the current window: extract → optimize → write back
    (spans ``ba.window``, ``ba.optimize``, ``ba.apply``)."""
    with TRACER.span("ba.window"):
        problem, window_slots, lm_slots = extract_window(cfg, state,
                                                         max_landmarks)
    with TRACER.span("ba.optimize"):
        result = optimize(k, problem, cfg.ba)
    with TRACER.span("ba.apply"):
        new_state = apply_result(state, result, window_slots, lm_slots)
    return new_state, result


def run_ba_streams(cfg, k: Intrinsics, state, max_landmarks: int = 512):
    """``run_ba`` on S independent maps at once (every leaf of ``state``
    with a leading stream dim S): one vmapped program for all streams.
    → (new state, BAResult with leading dim S)."""
    return torch.func.vmap(lambda s: run_ba(cfg, k, s, max_landmarks))(state)
