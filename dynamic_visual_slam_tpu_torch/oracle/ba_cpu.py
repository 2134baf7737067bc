"""f64 CPU oracle bundle adjustment — the Ceres stand-in.

Solves the exact residual model of `backend/ba.optimize` (which mirrors the
reference's Ceres problem, bundle_adjustment.hpp:531-565,737-905):

    r_{l,w} = (pi(R_cw_w X_l + t_cw_w) - uv_{l,w}) / sigma        (2-vector)
    cost    = 0.5 * sum_{l,w} rho_huber(||r_{l,w}||)

with the first pose held constant (gauge, hpp:781-785) and block-wise
Huber(delta) robustification (hpp:818 — Ceres applies the loss to the
squared norm of the 2-residual block, not per scalar component).

Solver: a damped Levenberg-Marquardt with Schur elimination of the landmark
blocks (f64, analytic block Jacobians via the SO(3) right-Jacobian chain
rule) wrapped in an IRLS loop for the block Huber loss — scipy's own
`loss=` is per-scalar, which is NOT the Ceres semantics, so instead each
outer iteration solves the w-weighted L2 problem with weights
w = min(1, delta/||r||) frozen from the previous iterate; the IRLS fixed
point is the exact robust optimum.

The inner solver was scipy.optimize.least_squares TRF through round 4;
its dense-SVD trust-region subproblem dominated the parity sweep (measured
97 % of a 640x480 oracle run: 87 SVD calls x 4.75 s for TWO window solves,
VERDICT r4 next #3). Each residual couples ONE camera and one landmark, so
the damped normal equations solve exactly via the Schur complement over
6x6 / 3x3 blocks — the same linear algebra Ceres' SPARSE_SCHUR performs —
in milliseconds. Both inner solvers minimize the identical weighted-L2
subproblem to tight tolerances; `inner="trf"` keeps the old path for
cross-checking (tests/test_ba_oracle.py pins the two against each other).

This module is validation-only: f64 numpy/scipy, never on the device
path. Used by the tests, `cli parity` and chip_smoke.py. A copy of the
reference package's `oracle/ba_cpu.py`.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
from scipy.optimize import least_squares
from scipy.spatial.transform import Rotation


def _skew(v: np.ndarray) -> np.ndarray:
    """(...,3) -> (...,3,3) cross-product matrices."""
    z = np.zeros_like(v[..., 0])
    return np.stack([
        np.stack([z, -v[..., 2], v[..., 1]], -1),
        np.stack([v[..., 2], z, -v[..., 0]], -1),
        np.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _so3_right_jacobian(v: np.ndarray) -> np.ndarray:
    """Jr(v) (W,3,3): Exp(v + d) ≈ Exp(v) Exp(Jr(v) d)."""
    th = np.linalg.norm(v, axis=-1)
    th_safe = np.where(th < 1e-6, 1.0, th)     # avoid 0/0 in dead branch
    th2 = th_safe * th_safe
    a = np.where(th < 1e-6, 0.5 - th * th / 24.0,
                 (1.0 - np.cos(th_safe)) / th2)
    b = np.where(th < 1e-6, 1.0 / 6.0 - th * th / 120.0,
                 (th_safe - np.sin(th_safe)) / (th2 * th_safe))
    sk = _skew(v)
    eye = np.broadcast_to(np.eye(3), sk.shape)
    return eye - a[..., None, None] * sk \
        + b[..., None, None] * (sk @ sk)


class OracleResult(NamedTuple):
    q_wc: np.ndarray    # (W, 4) optimized camera-to-world quaternions (w,x,y,z)
    t_wc: np.ndarray    # (W, 3)
    xyz: np.ndarray     # (L, 3)
    cost: float         # robust block-Huber cost (Ceres convention, x0.5)
    n_irls: int
    ok: bool = True     # False: solution left valid-depth territory


def block_huber_cost(r: np.ndarray, valid: np.ndarray, delta: float) -> float:
    """0.5 * sum rho(||r_block||) over valid (L, W) blocks; r is (L, W, 2)."""
    n2 = np.sum(r * r, axis=-1)
    n = np.sqrt(np.maximum(n2, 0.0))
    rho = np.where(n <= delta, n2, 2.0 * delta * n - delta * delta)
    return 0.5 * float(np.sum(np.where(valid, rho, 0.0)))


def _project(rvecs, ts, xyz, fx, fy, cx, cy):
    """rvecs/ts: (W,3) world->camera. Returns uv_hat (L, W, 2), z (L, W)."""
    rm = Rotation.from_rotvec(rvecs).as_matrix()          # (W, 3, 3)
    xc = np.einsum("wij,lj->lwi", rm, xyz) + ts[None]     # (L, W, 3)
    z = xc[..., 2]
    zs = np.where(np.abs(z) < 1e-12, 1e-12, z)
    u = fx * xc[..., 0] / zs + cx
    v = fy * xc[..., 1] / zs + cy
    return np.stack([u, v], axis=-1), z


def solve(q_wc: np.ndarray, t_wc: np.ndarray, xyz: np.ndarray,
          uv: np.ndarray, valid: np.ndarray,
          fx: float, fy: float, cx: float, cy: float,
          sigma: float = 1.0, huber_delta: float = 1.345,
          irls_iters: int = 30, xtol: float = 1e-12,
          max_nfev: Optional[int] = None,
          strict: bool = True,
          point_prior_sigma: float = 0.0,
          prior_obs_decay: float = 0.0,
          inner: str = "lm_schur") -> OracleResult:
    """Inputs mirror BAProblem: camera-to-world poses (quaternion wxyz — the
    package's lie.py convention + t), points, dense (L, W, 2) pixel grid
    with (L, W) validity."""
    w_n = q_wc.shape[0]
    l_n = xyz.shape[0]
    # camera-to-world -> world-to-camera, rotvec parametrization, f64
    # (scipy quaternions are xyzw: roll from the package's wxyz)
    r_wc = Rotation.from_quat(np.roll(np.asarray(q_wc, np.float64), -1,
                                      axis=-1))
    r_cw = r_wc.inv()
    rvec0 = r_cw.as_rotvec()                              # (W, 3)
    tcw0 = -r_cw.apply(np.asarray(t_wc, np.float64))      # (W, 3)
    x0 = np.asarray(xyz, np.float64).copy()
    uv = np.asarray(uv, np.float64)
    valid = np.asarray(valid, bool)
    # NOTE on the behind-camera guard (hpp:545-563): the reference zeroes
    # residuals at z <= 0.1, which makes "everything behind the camera" a
    # degenerate zero-cost global optimum. Ceres' trust region never jumps
    # there from a sane init, but scipy TRF will. The oracle therefore
    # optimizes the UNGUARDED smooth problem (exploding residuals near
    # z -> 0 act as a barrier) and asserts all depths are valid at the
    # solution — on such solutions the guarded and unguarded problems are
    # identical, so the comparison against the guarded solver is exact.

    li, wi = np.nonzero(valid)                            # flattened obs list
    n_obs = li.size

    def unpack(p):
        rv = np.concatenate([rvec0[:1], p[: (w_n - 1) * 3].reshape(-1, 3)])
        tc = np.concatenate([tcw0[:1],
                             p[(w_n - 1) * 3: (w_n - 1) * 6].reshape(-1, 3)])
        pts = p[(w_n - 1) * 6:].reshape(-1, 3)
        return rv, tc, pts

    def pack(rv, tc, pts):
        return np.concatenate([rv[1:].ravel(), tc[1:].ravel(), pts.ravel()])

    def residual_blocks(p, guard: bool = False):
        rv, tc, pts = unpack(p)
        uv_hat, z = _project(rv, tc, pts, fx, fy, cx, cy)
        r = (uv_hat - uv) / sigma                         # (L, W, 2)
        ok = valid & (z > 0.1) if guard else valid
        return np.where(ok[..., None], r, 0.0), ok

    # One-sided depth barrier keeping TRF inside the feasible basin: the
    # reprojection residual explodes only exactly AT z=0, and a large trust
    # step can hop straight across it to a finite-cost collapapsed optimum
    # with points behind the cameras (observed on flat live-pipeline
    # windows). r_bar = c * max(0, z_lo - z) has ZERO value and ZERO
    # gradient wherever z > z_lo, so every feasible optimum of the
    # barrier-augmented problem is exactly an optimum of the true problem —
    # the comparison stays exact; the barrier only blocks the escape path.
    z_lo = 0.1
    barrier_c = 1e3

    # Obs-count-decayed point prior (backend/ba.py w_pt_prior * decay_pt,
    # BAConfig.point_prior_sigma/prior_obs_decay): L2 anchors to the initial
    # points, NOT Huberized, included in the reported cost exactly as the
    # device solver includes them. The point prior also pins the gauge scale,
    # so renormalize_gauge must be skipped when it is active.
    if point_prior_sigma > 0:
        n_obs_pt = valid.sum(axis=1).astype(np.float64)          # (L,)
        decay_pt = prior_obs_decay / (prior_obs_decay + n_obs_pt) \
            if prior_obs_decay > 0 else np.ones(l_n)
        wp_pt = decay_pt / point_prior_sigma ** 2                # (L,)
    else:
        wp_pt = np.zeros(l_n)
    swp = np.sqrt(wp_pt)                                         # (L,)
    has_pt_prior = bool(np.any(wp_pt > 0))

    def residual_barrier(p):
        rv, tc, pts = unpack(p)
        _, z = _project(rv, tc, pts, fx, fy, cx, cy)
        return barrier_c * np.maximum(0.0, z_lo - z)      # (L, W)

    n_params = (w_n - 1) * 6 + l_n * 3

    def jac_weighted(pv, sw):
        """Analytic dense Jacobian of the sw-weighted flattened residuals."""
        rv, tc, pts = unpack(pv)
        rm = Rotation.from_rotvec(rv).as_matrix()             # (W,3,3)
        xc = np.einsum("wij,lj->lwi", rm, pts) + tc[None]     # (L,W,3)
        z = xc[..., 2]
        ok = valid
        iz = 1.0 / np.where(np.abs(z) < 1e-12, 1e-12, z)
        jp = np.zeros((l_n, w_n, 2, 3))
        jp[..., 0, 0] = fx * iz
        jp[..., 0, 2] = -fx * xc[..., 0] * iz * iz
        jp[..., 1, 1] = fy * iz
        jp[..., 1, 2] = -fy * xc[..., 1] * iz * iz
        jp *= (np.where(ok, sw, 0.0) / sigma)[..., None, None]
        # d xc / d rotvec = -R [X]x Jr(rv)  (Exp(v+d) = Exp(v)Exp(Jr d))
        jr = _so3_right_jacobian(rv)                          # (W,3,3)
        dxc_drv = np.einsum("wij,ljk,wkm->lwim",
                            rm, -_skew(pts), jr)              # (L,W,3,3)
        j_rot = np.einsum("lwri,lwij->lwrj", jp, dxc_drv)     # (L,W,2,3)
        j_pt = np.einsum("lwri,wij->lwrj", jp, rm)            # (L,W,2,3)
        jac = np.zeros((n_obs * 3 + 3 * l_n, n_params))
        t_base = (w_n - 1) * 3
        p_base = (w_n - 1) * 6
        # barrier rows: d r_bar/d params = -c * [z < z_lo] * dz/d params
        bar_act = (z < z_lo)                                  # (L,W)
        dz_drv = dxc_drv[..., 2, :]                           # (L,W,3)
        for o in range(n_obs):
            l, w = li[o], wi[o]
            if w > 0:
                jac[2 * o: 2 * o + 2, (w - 1) * 3: w * 3] = j_rot[l, w]
                jac[2 * o: 2 * o + 2,
                    t_base + (w - 1) * 3: t_base + w * 3] = jp[l, w]
            jac[2 * o: 2 * o + 2,
                p_base + 3 * l: p_base + 3 * l + 3] = j_pt[l, w]
            if bar_act[l, w]:
                b = 2 * n_obs + o
                if w > 0:
                    jac[b, (w - 1) * 3: w * 3] = -barrier_c * dz_drv[l, w]
                    jac[b, t_base + (w - 1) * 3 + 2] = -barrier_c
                jac[b, p_base + 3 * l: p_base + 3 * l + 3] = \
                    -barrier_c * rm[w, 2, :]
        for l in range(l_n):                 # point-prior rows: swp_l * I
            r0_ = 3 * n_obs + 3 * l
            c0_ = p_base + 3 * l
            jac[r0_, c0_] = swp[l]
            jac[r0_ + 1, c0_ + 1] = swp[l]
            jac[r0_ + 2, c0_ + 2] = swp[l]
        return jac

    def _lm_blocks(pv, sw):
        """Vectorized residuals + block Jacobians of the sw-weighted L2
        subproblem (reprojection rows, barrier rows, point-prior rows).
        Each observation couples exactly one camera and one landmark, so
        the normal equations decompose into 6x6 camera blocks, 3x3
        landmark blocks, and 6x3 coupling blocks — no dense Jacobian is
        ever formed. Returns (cost, g_c (W,6), g_p (L,3), Hcc (W,6,6),
        Hll (L,3,3), Hcl (L,W,6,3))."""
        rv, tc, pts = unpack(pv)
        rm = Rotation.from_rotvec(rv).as_matrix()             # (W,3,3)
        xc = np.einsum("wij,lj->lwi", rm, pts) + tc[None]     # (L,W,3)
        z = xc[..., 2]
        iz = 1.0 / np.where(np.abs(z) < 1e-12, 1e-12, z)
        u = fx * xc[..., 0] * iz + cx
        v = fy * xc[..., 1] * iz + cy
        r2 = (np.stack([u, v], -1) - uv) / sigma              # (L,W,2)
        r2 = np.where(valid[..., None], r2 * sw[..., None], 0.0)
        # d r2 / d tc  (weighted), d xc / d rotvec = -R [X]x Jr(rv)
        jp = np.zeros((l_n, w_n, 2, 3))
        jp[..., 0, 0] = fx * iz
        jp[..., 0, 2] = -fx * xc[..., 0] * iz * iz
        jp[..., 1, 1] = fy * iz
        jp[..., 1, 2] = -fy * xc[..., 1] * iz * iz
        jp *= (np.where(valid, sw, 0.0) / sigma)[..., None, None]
        jr = _so3_right_jacobian(rv)                          # (W,3,3)
        dxc_drv = np.einsum("wij,ljk,wkm->lwim",
                            rm, -_skew(pts), jr)              # (L,W,3,3)
        j_rot = np.einsum("lwri,lwij->lwrj", jp, dxc_drv)     # (L,W,2,3)
        j_pt = np.einsum("lwri,wij->lwrj", jp, rm)            # (L,W,2,3)
        a2 = np.concatenate([j_rot, jp], axis=-1)             # (L,W,2,6)
        # barrier rows (unweighted, all valid obs): c*max(0, z_lo - z)
        rb = np.where(valid, barrier_c * np.maximum(0.0, z_lo - z), 0.0)
        act = valid & (z < z_lo)                              # (L,W)
        dz_drv = dxc_drv[..., 2, :]                           # (L,W,3)
        a1 = np.concatenate(
            [-barrier_c * dz_drv,
             np.broadcast_to(np.asarray([0.0, 0.0, -barrier_c]),
                             dz_drv.shape)], axis=-1)         # (L,W,6)
        a1 = np.where(act[..., None], a1, 0.0)
        b1 = np.where(act[..., None],
                      -barrier_c * rm[None, :, 2, :], 0.0)    # (L,W,3)
        # prior rows: swp_l * (pts - x0)
        rp = swp[:, None] * (pts - x0)                        # (L,3)
        cost = 0.5 * (float(np.sum(r2 * r2)) + float(np.sum(rb * rb))
                      + float(np.sum(rp * rp)))
        g_c = np.einsum("lwri,lwr->wi", a2, r2) \
            + np.einsum("lwi,lw->wi", a1, rb)                 # (W,6)
        g_p = np.einsum("lwri,lwr->li", j_pt, r2) \
            + np.einsum("lwi,lw->li", b1, rb) + swp[:, None] * rp
        hcc = np.einsum("lwri,lwrj->wij", a2, a2) \
            + np.einsum("lwi,lwj->wij", a1, a1)               # (W,6,6)
        hll = np.einsum("lwri,lwrj->lij", j_pt, j_pt) \
            + np.einsum("lwi,lwj->lij", b1, b1) \
            + (wp_pt[:, None, None] * np.eye(3)[None])        # (L,3,3)
        hcl = np.einsum("lwri,lwrj->lwij", a2, j_pt) \
            + np.einsum("lwi,lwj->lwij", a1, b1)              # (L,W,6,3)
        return cost, g_c, g_p, hcc, hll, hcl

    def _lm_cost(pv, sw):
        return _lm_blocks(pv, sw)[0]

    def lm_schur_solve(p_in, sw, max_iter=120):
        """Damped LM on the weighted L2 subproblem; the damped normal
        equations solve exactly via the Schur complement over the camera
        blocks (camera 0 fixed = gauge). Marquardt scaling (λ·diag)."""
        p_cur = p_in.copy()
        cost, g_c, g_p, hcc, hll, hcl = _lm_blocks(p_cur, sw)
        lam = 1e-4
        eye3 = np.eye(3)
        for _ in range(max_iter):
            gnorm = max(float(np.max(np.abs(g_c[1:]))) if w_n > 1 else 0.0,
                        float(np.max(np.abs(g_p))) if l_n else 0.0)
            if gnorm < 1e-12:
                break
            # damped landmark blocks (+ tiny absolute floor so landmarks
            # with no valid rows stay invertible and get zero update)
            dll = np.einsum("lii->li", hll)
            floor = 1e-12 * max(float(np.max(dll)), 1.0)
            hll_d = hll + np.einsum(
                "li,ij->lij", lam * dll + floor, eye3)
            hll_inv = np.linalg.inv(hll_d)                     # (L,3,3)
            hcl_r = hcl[:, 1:]                                 # (L,W-1,6,3)
            t_blk = np.einsum("lwab,lbc->lwac", hcl_r, hll_inv)
            w_r = w_n - 1
            s = np.zeros((w_r, 6, w_r, 6))
            dcc = np.einsum("wii->wi", hcc[1:])
            for w in range(w_r):
                s[w, :, w, :] = hcc[1 + w] + np.diag(lam * dcc[w] + floor)
            s -= np.einsum("lwac,lvdc->wavd", t_blk, hcl_r)
            b = g_c[1:] - np.einsum("lwac,lc->wa", t_blk, g_p)
            try:
                dc = np.linalg.solve(s.reshape(w_r * 6, w_r * 6),
                                     -b.ravel()).reshape(w_r, 6)
            except np.linalg.LinAlgError:
                lam = min(lam * 4.0, 1e10)
                continue
            u_vec = g_p + np.einsum("lwac,wa->lc", hcl_r, dc)
            dp = -np.einsum("lab,lb->la", hll_inv, u_vec)      # (L,3)
            rv, tc, pts = unpack(p_cur)
            rv2 = rv.copy(); tc2 = tc.copy()
            rv2[1:] += dc[:, :3]
            tc2[1:] += dc[:, 3:]
            p_new = pack(rv2, tc2, pts + dp)
            new = _lm_blocks(p_new, sw)
            step = max(float(np.max(np.abs(dc))) if w_r else 0.0,
                       float(np.max(np.abs(dp))) if l_n else 0.0)
            if new[0] <= cost:
                p_cur = p_new
                cost, g_c, g_p, hcc, hll, hcl = new
                lam = max(lam / 3.0, 1e-12)
                if step < xtol:
                    break
            else:
                lam = min(lam * 4.0, 1e10)
                if lam >= 1e10 or step < xtol:
                    break
        return p_cur

    # reference scale for gauge renormalization: scaling points and camera
    # centers about the FIXED first camera center is an exact symmetry of
    # the cost; renormalizing each iterate keeps TRF from wandering down
    # that flat valley (observed drifts of 70x otherwise)
    c0 = -Rotation.from_rotvec(rvec0[0]).inv().apply(tcw0[0])
    scale_ref = float(np.mean(np.linalg.norm(x0 - c0, axis=1)))

    def renormalize_gauge(p):
        rv, tc, pts = unpack(p)
        cur = float(np.mean(np.linalg.norm(pts - c0, axis=1)))
        s = scale_ref / max(cur, 1e-30)
        pts2 = c0 + s * (pts - c0)
        rm = Rotation.from_rotvec(rv)
        centers = -rm.inv().apply(tc)          # camera centers in world
        centers2 = c0 + s * (centers - c0)
        tc2 = -rm.apply(centers2)
        return pack(rv, tc2, pts2)

    p = pack(rvec0, tcw0, x0)
    n_irls = 0
    w_prev = None
    for _ in range(max(1, irls_iters)):
        r, ok = residual_blocks(p)
        if n_irls == 0:
            # first iteration: plain L2 from the init (unit weights).
            # Weights computed at a far-from-optimal init are tiny and
            # distort the problem enough to reach degenerate basins;
            # Ceres' corrector+trust-region never does that.
            w_blk = np.ones_like(r[..., 0])
        else:
            nrm = np.linalg.norm(r, axis=-1)
            w_blk = np.where(nrm <= huber_delta, 1.0,
                             huber_delta / np.maximum(nrm, 1e-12))
        sw = np.sqrt(np.where(ok, w_blk, 0.0))            # (L, W)

        def flat_weighted(pv, sw=sw):
            rr, _ = residual_blocks(pv)
            bar = residual_barrier(pv)[li, wi]            # (n_obs,)
            _, _, pts = unpack(pv)
            rp = (swp[:, None] * (pts - x0)).ravel()      # (3L,) point prior
            return np.concatenate(
                [(rr * sw[..., None])[li, wi].ravel(), bar, rp])

        unit_weights = bool(np.all(w_blk[ok] >= 1.0 - 1e-12))

        if inner == "lm_schur":
            x_new = lm_schur_solve(p, sw)
        else:                       # "trf": the r1-r4 scipy path, kept for
            #                         cross-checking the LM-Schur solver
            sol = least_squares(flat_weighted, p, jac=lambda pv, sw=sw:
                                jac_weighted(pv, sw),
                                method="trf", xtol=xtol, ftol=1e-12,
                                gtol=1e-12, max_nfev=max_nfev)
            x_new = sol.x
        n_irls += 1
        converged = np.max(np.abs(x_new - p)) < 1e-12
        if os.environ.get("DVS_ORACLE_DEBUG"):
            _, z_dbg = _project(*unpack(x_new), fx, fy, cx, cy)
            bar_dbg = residual_barrier(x_new)[li, wi]
            print(f"[irls {n_irls}] cost={_lm_cost(x_new, sw):.4f} "
                  f"zmin={z_dbg[valid].min():.3g} "
                  f"zmax={z_dbg[valid].max():.3g} "
                  f"bar_max={bar_dbg.max():.3g}",
                  flush=True)
        # the point prior pins the gauge scale — renormalizing would then
        # CHANGE the cost instead of moving along an exact symmetry
        p = x_new if has_pt_prior else renormalize_gauge(x_new)
        r, ok = residual_blocks(p)
        in_l2 = bool(np.all(np.linalg.norm(r, axis=-1)[ok] <= huber_delta))
        # exact stop: this iteration solved the TRUE problem (all weights
        # were 1) and the solution stays in the L2 region — or the iterate
        # stopped moving (IRLS fixed point of the robust problem) — or the
        # weights themselves have stabilized
        nrm2 = np.linalg.norm(r, axis=-1)
        w_now = np.where(nrm2 <= huber_delta, 1.0,
                         huber_delta / np.maximum(nrm2, 1e-12))
        w_stable = w_prev is not None and \
            float(np.max(np.abs(w_now - w_prev))) < 1e-10
        w_prev = w_now
        if (unit_weights and in_l2) or converged or w_stable:
            break

    rv, tc, pts = unpack(p)
    # sanity: the unguarded optimum must have valid depths everywhere —
    # then it equals the guarded (reference-formulation) optimum
    _, z_fin = _project(rv, tc, pts, fx, fy, cx, cy)
    depths_ok = bool(np.all(z_fin[valid] > 0.1))
    if strict and not depths_ok:
        raise RuntimeError("oracle solution has behind-camera points; "
                           "problem too degenerate for oracle comparison")
    r, ok = residual_blocks(p, guard=True)
    cost = block_huber_cost(r, ok, huber_delta) \
        + 0.5 * float(np.sum(wp_pt[:, None] * (pts - x0) ** 2))
    r_cw_f = Rotation.from_rotvec(rv)
    r_wc_f = r_cw_f.inv()
    q_out = np.roll(r_wc_f.as_quat(), 1, axis=-1)         # xyzw -> wxyz
    q_out = q_out * np.where(q_out[:, :1] < 0, -1.0, 1.0)
    t_out = -r_wc_f.apply(tc)
    return OracleResult(q_wc=q_out, t_wc=t_out, xyz=pts, cost=cost,
                        n_irls=n_irls, ok=depths_ok)
