"""Pose-graph optimisation over the keyframe ring for loop corrections:
a frozen copy of the port's ``backend/pose_graph.py``.

Port of the reference package's ``backend/pose_graph.py``: odometry edges
between consecutive keyframes keep their measured relative transforms, the
verified loop adds an absolute pose constraint on the entry keyframe, and a
dense (6F, 6F) Gauss-Newton solve distributes the drift.  The ring has a
fixed capacity (F ≤ 64), so the graph is dense and tiny; inactive slots ride
along pinned to zero correction.  The Jacobian is ``torch.func.jacfwd`` of
the residual stack, and the solve is ``torch.linalg.solve_ex`` (no error
check, so no host read).

Parameterisation per keyframe k: left rotation tangent φ_k plus additive
translation δ_k — q_k = exp(φ_k) ∘ q_k0,  t_k = t_k0 + δ_k.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slamref.core import lie
from slamref.core.containers import row


def _safe_so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """so3_exp with a differentiable norm at φ = 0 (Gauss-Newton starts at
    x = 0, where d‖φ‖/dφ is NaN): sqrt(φ·φ + ε) has the same value to 1e-12
    and a finite derivative."""
    theta = torch.sqrt((phi * phi).sum(-1, keepdim=True) + 1e-24)
    half = 0.5 * theta
    return torch.cat([torch.cos(half), torch.sin(half) / theta * phi], -1)


def _safe_so3_log(q: torch.Tensor) -> torch.Tensor:
    """so3_log with a differentiable vector norm (see _safe_so3_exp)."""
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    vn = torch.sqrt((v * v).sum(-1, keepdim=True) + 1e-24)
    return (2.0 * torch.atan2(vn, w) / vn) * v


class PGOResult(NamedTuple):
    q: torch.Tensor        # (F, 4) optimised ring poses
    t: torch.Tensor        # (F, 3)
    q_corr: torch.Tensor   # (F, 4) world-frame correction per slot:
    t_corr: torch.Tensor   # (F, 3)   T_new ∘ T_old⁻¹ (identity where pinned)
    ok: torch.Tensor       # () bool — entry keyframe was found in the ring


def optimize_ring(q0: torch.Tensor, t0: torch.Tensor, active: torch.Tensor,
                  seq: torch.Tensor, q_loop: torch.Tensor,
                  t_loop: torch.Tensor, entry_seq, cand_seq,
                  iters: int = 8, damping: float = 1e-4,
                  w_loop: float = 4.0) -> PGOResult:
    """Gauss-Newton pose graph over the keyframe ring.

    q0/t0 (F,4)/(F,3): current ring poses (camera-to-world); active (F,)
    bool; seq (F,) monotone keyframe ids; q_loop/t_loop: the verified
    absolute pose of the ENTRY keyframe; entry_seq/cand_seq: the loop
    endpoints' sequence ids.  Residuals: odometry edges between
    consecutive active keyframes, the loop prior (weight w_loop), and pins
    on the candidate (gauge) and inactive slots plus a tiny pull on every
    state so the normal matrix stays positive definite."""
    f = q0.shape[0]
    dev = q0.device
    big = (2 ** 31 - 1) // 2
    seq_key = torch.where(active, seq, big)
    order = torch.argsort(seq_key, stable=True)     # active first, by seq
    ei, ej = order[:-1], order[1:]
    w_odo = (active[ei] & active[ej]).to(torch.float32)

    # measured relative transforms from the current (pre-correction) poses
    q_ij0, t_ij0 = lie.se3_compose(*lie.se3_inverse(q0[ei], t0[ei]),
                                   q0[ej], t0[ej])

    entry_hit = (seq == entry_seq) & active
    entry_slot = torch.argmax(entry_hit.to(torch.int32))
    ok = entry_hit.any()
    cand_hit = (seq == cand_seq) & active
    # gauge: the candidate keyframe if still in the ring, else the oldest
    oldest = torch.argmin(seq_key)
    cand_slot = torch.where(cand_hit.any(),
                            torch.argmax(cand_hit.to(torch.int32)), oldest)
    pin = (~active) | (torch.arange(f, device=dev) == cand_slot)
    pin_w = torch.where(pin, 1e3, 1e-3)
    loop_w = w_loop * ok.to(torch.float32)

    def residuals(x):
        phi, rho = x[:, :3], x[:, 3:]
        q = lie.quat_normalize(lie.quat_mul(_safe_so3_exp(phi), q0))
        t = t0 + rho
        q_rel, t_rel = lie.se3_compose(*lie.se3_inverse(q[ei], t[ei]),
                                       q[ej], t[ej])
        r_rot = _safe_so3_log(lie.quat_mul(lie.quat_conj(q_ij0), q_rel))
        r_odo = torch.cat([r_rot, t_rel - t_ij0], -1) * w_odo[:, None]
        r_lrot = _safe_so3_log(lie.quat_mul(lie.quat_conj(q_loop),
                                            row(q, entry_slot)))
        r_loop = torch.cat([r_lrot, row(t, entry_slot) - t_loop]) * loop_w
        r_pin = (x * pin_w[:, None]).reshape(-1)
        r = torch.cat([r_odo.reshape(-1), r_loop, r_pin])
        return r, r

    eye = torch.eye(6 * f, dtype=torch.float32, device=dev)
    # one evaluation gives the Jacobian and, as aux, the residuals
    jac = torch.func.jacfwd(residuals, has_aux=True)
    x = torch.zeros((f, 6), dtype=torch.float32, device=dev)
    for _ in range(iters):
        j, r = jac(x)
        j = j.reshape(r.shape[0], 6 * f)
        h = j.T @ j + damping * eye
        dx, _ = torch.linalg.solve_ex(h, (j.T @ r)[:, None])
        x = x - dx.reshape(f, 6)

    q_new = lie.quat_normalize(lie.quat_mul(lie.so3_exp(x[:, :3]), q0))
    t_new = t0 + x[:, 3:]
    q_new = torch.where(ok, q_new, q0)
    t_new = torch.where(ok, t_new, t0)
    q_corr, t_corr = lie.se3_compose(q_new, t_new, *lie.se3_inverse(q0, t0))
    return PGOResult(q=q_new, t=t_new, q_corr=q_corr, t_corr=t_corr, ok=ok)
