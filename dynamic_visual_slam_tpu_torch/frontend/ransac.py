"""Batched RANSAC estimators: fundamental matrix + PnP, all hypotheses at once.

Same estimators as the reference package's ``frontend/ransac.py``: a fixed
batch of hypotheses is drawn, solved and scored in parallel, the best one is
refined, and degenerate inputs return valid=False.  Every function here
also takes leading batch dims (frames of a batch), so one call estimates the
geometry of all B frame pairs.

Long reductions: the Gram matrix of the weighted 8-point solve and the
Gauss-Newton normal equations of the PnP refinement sum hundreds of
products.  They are accumulated in float64 and rounded once to float32, so
the result does not depend on the order the CPU's vector ISA (AVX2,
AVX-512) or the card sums in; in float32 that order moved the refined F by
1.35e-4 and a PnP pose by 3.6 mm between two x86 hosts.  Everything else
stays float32, as in the reference, the DLT's 12-row Gram included: in
float64 it took the per-frame slice of tests/test_torch_perframe.py from
25 to 50 mm off the reference up to frame 90.

Sampling: the reference draws its minimal sets with threefry keys, which
torch cannot reproduce.  ``sample_indices`` draws them from an explicit
``torch.Generator`` on the data's device; both estimators also accept the
sample indices directly (``samples=``), which is how the tests feed both
packages the same draws.

PnP routes: ``pnp_ransac`` solves CUDA tensors with one launch of kernel
``csrc/pnp_ransac.cu`` (every problem of the batch a block) and CPU tensors
with ``pnp_ransac_plain``, the chain of batched PyTorch operations that the
kernel follows operation for operation, in the card's rounding.

Counters (``utils/profiling``): ``ransac.hypotheses.fm`` and
``ransac.hypotheses.pnp``, the hypotheses each call scores, every frame
of a batch counted (a PnP's prior pose and identity included);
``ransac.pnp.kernel`` and ``ransac.pnp.plain``, the PnP problems each
route solved.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from dynamic_visual_slam_tpu_torch import kernels
from dynamic_visual_slam_tpu_torch.core import containers, lie
from dynamic_visual_slam_tpu_torch.core.camera import Intrinsics
from dynamic_visual_slam_tpu_torch.ops import linalg_small as ls
from dynamic_visual_slam_tpu_torch.utils.profiling import TRACER


def sample_indices(generator: Optional[torch.Generator], n_hyp: int,
                   sample_size: int, count: torch.Tensor) -> torch.Tensor:
    """(..., n_hyp, sample_size) int64 indices into the compacted valid
    region [0, count) for each count (...,): uniform with replacement across
    draws; within a draw, duplicates are avoided by up to 3 re-draws per
    slot (the reference's rule).  Drawn on ``count``'s device without host
    reads."""
    hi = torch.clamp(count, min=1)[..., None, None, None]
    u = torch.rand(count.shape + (n_hyp, sample_size, 4), generator=generator,
                   device=count.device)
    idx = torch.minimum((u * hi).long(), hi - 1)
    picks = [idx[..., 0, 0]]
    for s in range(1, sample_size):
        cand = idx[..., s, :]
        prev = torch.stack(picks, dim=-1)
        best = cand[..., 0]
        for a in range(1, 4):
            clash = (prev == best[..., None]).any(-1)
            best = torch.where(clash, cand[..., a], best)
        picks.append(best)
    return torch.stack(picks, dim=-1)


def _take(x: torch.Tensor, idx: torch.Tensor, nb: int) -> torch.Tensor:
    """x (*b, N, *f), idx (*b,) → x[b..., idx] (*b, *f)."""
    return containers.bgather(x, idx[..., None], nb).squeeze(nb)


# ===========================================================================
# Fundamental matrix
# ===========================================================================

class FundamentalResult(NamedTuple):
    F: torch.Tensor            # (..., 3, 3)
    inliers: torch.Tensor      # (..., K) bool — over the ORIGINAL match slots
    n_inliers: torch.Tensor    # (...) int64
    valid: torch.Tensor        # (...) bool


def _normalize_points(pts: torch.Tensor):
    """Hartley normalization over dim -2: centroid to 0, mean dist to √2."""
    c = pts.mean(-2, keepdim=True)
    d = torch.linalg.vector_norm(pts - c, dim=-1).mean(-1)
    s = math.sqrt(2.0) / torch.clamp(d, min=1e-9)
    z, o = torch.zeros_like(s), torch.ones_like(s)
    c0, c1 = c[..., 0, 0], c[..., 0, 1]
    t = torch.stack([torch.stack([s, z, -s * c0], -1),
                     torch.stack([z, s, -s * c1], -1),
                     torch.stack([z, z, o], -1)], -2)
    return (pts - c) * s[..., None, None], t


def _eight_point_weighted(p1: torch.Tensor, p2: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """Normalized 8-point from weighted correspondences (..., P, 2) → F."""
    n1, t1 = _normalize_points(p1)
    n2, t2 = _normalize_points(p2)
    x1, y1 = n1[..., 0], n1[..., 1]
    x2, y2 = n2[..., 0], n2[..., 1]
    a = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], -1) * w[..., None]
    a64 = a.to(torch.float64)          # Gram in float64, rounded once
    f = ls.smallest_eigvec((a64.transpose(-1, -2) @ a64).to(a.dtype)).reshape(
        a.shape[:-2] + (3, 3))
    _, v = ls.eigh3x3(f.transpose(-1, -2) @ f)
    v3 = v[..., 0]
    f2 = f - (f @ v3[..., None]) * v3[..., None, :]
    return t2.transpose(-1, -2) @ f2 @ t1


def _epipolar_errors(f: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor
                     ) -> torch.Tensor:
    """Symmetric point-to-epipolar-line distance (max of both directions);
    f (..., 3, 3), p (..., K, 2) → (..., K)."""
    h1 = torch.cat([p1, torch.ones_like(p1[..., :1])], -1)
    h2 = torch.cat([p2, torch.ones_like(p2[..., :1])], -1)
    l2 = h1 @ f.transpose(-1, -2)
    l1 = h2 @ f
    num = torch.abs((h2 * l2).sum(-1))
    d2 = num / torch.clamp(torch.linalg.vector_norm(l2[..., :2], dim=-1),
                           min=1e-12)
    d1 = num / torch.clamp(torch.linalg.vector_norm(l1[..., :2], dim=-1),
                           min=1e-12)
    return torch.maximum(d1, d2)


def fundamental_ransac(p1: torch.Tensor, p2: torch.Tensor, mask: torch.Tensor,
                       n_hyp: int = 256, threshold: float = 2.0,
                       samples: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> FundamentalResult:
    """p1/p2: (..., K, 2) matched pixels (same slot = same match), mask
    (..., K) bool.  samples: optional (..., n_hyp, 8) indices into the
    compacted valid matches; drawn from ``generator`` when absent."""
    nb = mask.ndim - 1
    count = mask.sum(-1)
    order = containers.stable_partition(mask)
    cp1 = containers.bgather(p1, order, nb)
    cp2 = containers.bgather(p2, order, nb)
    if samples is None:
        samples = sample_indices(generator, n_hyp, 8, count)
    TRACER.count("ransac.hypotheses.fm", samples.shape[:-1].numel())
    s1 = containers.bgather(cp1, samples, nb)             # (..., N, 8, 2)
    s2 = containers.bgather(cp2, samples, nb)
    fs = _eight_point_weighted(s1, s2, torch.ones_like(s1[..., 0]))
    errs = _epipolar_errors(fs, p1[..., None, :, :], p2[..., None, :, :])
    inl = (errs < threshold) & mask[..., None, :]         # (..., N, K)
    scores = inl.sum(-1)
    best = torch.argmax(scores, dim=-1)
    inl_best = _take(inl, best, nb)
    score_best = _take(scores, best, nb)

    w = inl_best.to(torch.float32)
    zero = torch.zeros((), dtype=p1.dtype, device=p1.device)
    f = _eight_point_weighted(torch.where(mask[..., None], p1, zero),
                              torch.where(mask[..., None], p2, zero), w)
    refined_inl = (_epipolar_errors(f, p1, p2) < threshold) & mask
    refined_n = refined_inl.sum(-1)
    use_refined = refined_n >= score_best
    inliers = torch.where(use_refined[..., None], refined_inl, inl_best)
    f_out = torch.where(use_refined[..., None, None], f, _take(fs, best, nb))
    n_in = torch.maximum(refined_n, score_best)
    return FundamentalResult(f_out, inliers, n_in, (count >= 8) & (n_in >= 8))


# ===========================================================================
# PnP
# ===========================================================================

class PnPResult(NamedTuple):
    """Pose maps object-frame points into the camera: X_cam = R X + t."""

    q: torch.Tensor            # (..., 4) wxyz
    t: torch.Tensor            # (..., 3)
    inliers: torch.Tensor      # (..., K) bool
    n_inliers: torch.Tensor    # (...) int64
    valid: torch.Tensor        # (...) bool


def _dlt_pose(xyz: torch.Tensor, xn: torch.Tensor):
    """(..., 6,3) object points + (..., 6,2) normalized image points →
    (R, t) via DLT + Procrustes orthogonalization + cheirality fix."""
    xh = torch.cat([xyz, torch.ones_like(xyz[..., :1])], -1)     # (..., 6, 4)
    zeros = torch.zeros_like(xh)
    rows_u = torch.cat([xh, zeros, -xn[..., :1] * xh], -1)
    rows_v = torch.cat([zeros, xh, -xn[..., 1:2] * xh], -1)
    a = torch.cat([rows_u, rows_v], -2)                          # (..., 12, 12)
    p = ls.smallest_eigvec(a.transpose(-1, -2) @ a).reshape(
        a.shape[:-2] + (3, 4))
    depths = (xh @ p[..., 2, :, None])[..., 0]
    p = p * torch.where(depths.mean(-1) < 0, -1.0, 1.0)[..., None, None]
    m = p[..., :3]
    u, s, vt2 = ls.svd3x3(m)
    det = lie.det3x3(u @ vt2)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    r = (u * d[..., None, :]) @ vt2
    scale = s.mean(-1) * torch.where(det < 0, -1.0, 1.0)
    t = p[..., 3] / torch.clamp(torch.abs(scale), min=1e-12)[..., None] \
        * torch.sign(scale)[..., None]
    return r, t


def _reproj_errors(k: Intrinsics, r: torch.Tensor, t: torch.Tensor,
                   xyz: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    xc = xyz @ r.transpose(-1, -2) + t[..., None, :]
    z = torch.clamp(xc[..., 2], min=1e-6)
    u = k.fx * xc[..., 0] / z + k.cx
    v = k.fy * xc[..., 1] / z + k.cy
    err = torch.sqrt((u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2)
    return torch.where(xc[..., 2] > 1e-6, err, 1e9)


def _gauss_newton_refine(k: Intrinsics, q0, t0, xyz, uv, w, iters: int):
    """Masked GN on SE(3) (left-multiplicative so3+t), reprojection
    residuals; q0 (..., 4), t0 (..., 3), xyz (..., K, 3), uv (..., K, 2),
    w (..., K)."""
    q, t = q0, t0
    for _ in range(iters):
        r = lie.quat_to_mat(q)
        xc = xyz @ r.transpose(-1, -2) + t[..., None, :]
        x0, x1, x2 = xc.unbind(-1)
        z = torch.clamp(x2, min=1e-6)
        iz = 1.0 / z
        u = k.fx * x0 * iz + k.cx
        v = k.fy * x1 * iz + k.cy
        res = torch.stack([u - uv[..., 0], v - uv[..., 1]], -1)   # (..., K, 2)
        zs = torch.zeros_like(z)
        ju = torch.stack([k.fx * iz, zs, -k.fx * x0 * iz * iz], -1)
        jv = torch.stack([zs, k.fy * iz, -k.fy * x1 * iz * iz], -1)
        jp = torch.stack([ju, jv], -2)                            # (..., K, 2, 3)
        skew = torch.stack([
            torch.stack([zs, x2, -x1], -1),
            torch.stack([-x2, zs, x0], -1),
            torch.stack([x1, -x0, zs], -1)], -2)                  # -[xc]×
        jtheta = jp @ skew
        # [J | r] (..., K, 2, 7); one Gram in float64 gives JᵀWJ and JᵀWr
        # (w is 0/1, so the weighting is exact in either precision)
        jr = torch.cat([jtheta, jp, res[..., None]], -1).to(torch.float64)
        wk = (w * (x2 > 1e-6))[..., None, None]
        g = torch.einsum("...kri,...krj->...ij", jr * wk, jr).to(res.dtype)
        h, b = g[..., :6, :6], g[..., :6, 6]
        dx = -ls.solve_psd(h, b, damping=1e-6)
        dq = lie.so3_exp(dx[..., :3])
        q_new = lie.quat_normalize(lie.quat_mul(dq, q))
        t = lie.quat_rotate(dq, t) + dx[..., 3:]
        q = q_new
    return q, t


KERNEL = "pnp_ransac"
# shared memory the kernel takes beside its fixed part: two inlier bit
# masks of K bits and a counter a hypothesis (csrc/pnp_ransac.cu)
MAX_DYN_SMEM = 180 * 1024


def pnp_ransac(k: Intrinsics, xyz: torch.Tensor, uv: torch.Tensor,
               mask: torch.Tensor, n_hyp: int = 128,
               threshold: float = 4.0, min_inliers: int = 6,
               refine_iters: int = 10,
               prior_q: Optional[torch.Tensor] = None,
               prior_t: Optional[torch.Tensor] = None,
               samples: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> PnPResult:
    """xyz: (..., K, 3) object-frame points; uv: (..., K, 2) observed pixels;
    mask (..., K).  prior_q/prior_t (optional, (..., 4)/(..., 3)): a
    predicted pose that joins the hypothesis pool with an identity
    hypothesis.  samples: optional (..., n_hyp, 6) indices into the
    compacted valid points, each in [0, K); drawn from ``generator`` when
    absent.  CUDA tensors take kernel ``pnp_ransac`` (one launch, no host
    read), CPU tensors ``pnp_ransac_plain``."""
    if samples is None:
        samples = sample_indices(generator, n_hyp, 6, mask.sum(-1))
    n_prob = mask.shape[:-1].numel()
    TRACER.count("ransac.hypotheses.pnp", n_prob * (
        samples.shape[-2] + (2 if prior_q is not None else 0)))
    args = (k, xyz, uv, mask, samples, threshold, min_inliers, refine_iters,
            prior_q, prior_t)
    if mask.device.type == "cpu":
        TRACER.count("ransac.pnp.plain", n_prob)
        return pnp_ransac_plain(*args)
    if mask.device.type != "cuda":
        raise ValueError(f"pnp_ransac: unsupported device {mask.device}")
    TRACER.count("ransac.pnp.kernel", n_prob)
    return _pnp_kernel(*args)


def _pnp_kernel(k: Intrinsics, xyz, uv, mask, samples, threshold,
                min_inliers, refine_iters, prior_q, prior_t) -> PnPResult:
    """``pnp_ransac`` on the card: checks, one launch of the kernel."""
    lead = mask.shape[:-1]
    kk = mask.shape[-1]
    n_hyp = samples.shape[-2] if samples.ndim >= 2 else 0
    dev = mask.device
    prior = prior_q is not None
    want = [(xyz, torch.float32, lead + (kk, 3)),
            (uv, torch.float32, lead + (kk, 2)),
            (mask, torch.bool, lead + (kk,)),
            (samples, torch.int64, lead + (n_hyp, 6))]
    if prior or prior_t is not None:
        if not (prior and prior_t is not None):
            raise ValueError("pnp_ransac: give both prior_q and prior_t")
        want += [(prior_q, torch.float32, lead + (4,)),
                 (prior_t, torch.float32, lead + (3,))]
    for x, dtype, shape in want:
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"pnp_ransac: expected {dtype} {shape} on {dev}; got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")
    n_words = (kk + 31) // 32
    dyn = 4 * (2 * n_words + n_hyp + 2)
    if kk < 1 or n_hyp + 2 * prior < 1 or dyn > MAX_DYN_SMEM:
        raise ValueError(f"pnp_ransac: K = {kk} points and {n_hyp} "
                         f"hypotheses (prior: {prior}) are outside the "
                         "kernel's range")
    b = lead.numel()
    xyz, uv, mask, samples = (x.contiguous() for x in (xyz, uv, mask,
                                                        samples))
    if prior:
        prior_q, prior_t = prior_q.contiguous(), prior_t.contiguous()
    perm = torch.empty(b * kk, dtype=torch.int32, device=dev)
    hyp = torch.empty(b * (n_hyp + 2) * 12, dtype=torch.float32, device=dev)
    q = torch.empty(lead + (4,), dtype=torch.float32, device=dev)
    t = torch.empty(lead + (3,), dtype=torch.float32, device=dev)
    inl = torch.empty(lead + (kk,), dtype=torch.bool, device=dev)
    n_in = torch.empty(lead, dtype=torch.int64, device=dev)
    valid = torch.empty(lead, dtype=torch.bool, device=dev)
    ptr = lambda x: x.data_ptr() if x is not None else None  # noqa: E731
    fn = kernels.entry(KERNEL)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # (uv - c) / f on the card multiplies by 1/f rounded from double
        status = fn(ptr(xyz), ptr(uv), ptr(mask), ptr(samples),
                    ptr(prior_q), ptr(prior_t), ptr(perm), ptr(hyp), ptr(q),
                    ptr(t), ptr(inl), ptr(n_in), ptr(valid), b, kk, n_hyp,
                    refine_iters, min_inliers, k.fx, k.fy, k.cx, k.cy,
                    1.0 / k.fx, 1.0 / k.fy, threshold, dyn, stream)
    kernels.check(KERNEL, status)
    if b:
        kernels.count(KERNEL)
    return PnPResult(q, t, inl, n_in, valid)


def pnp_ransac_plain(k: Intrinsics, xyz: torch.Tensor, uv: torch.Tensor,
                     mask: torch.Tensor, samples: torch.Tensor,
                     threshold: float = 4.0, min_inliers: int = 6,
                     refine_iters: int = 10,
                     prior_q: Optional[torch.Tensor] = None,
                     prior_t: Optional[torch.Tensor] = None) -> PnPResult:
    """``pnp_ransac``'s plain version: the same arguments, the minimal sets
    given."""
    nb = mask.ndim - 1
    count = mask.sum(-1)
    order = containers.stable_partition(mask)
    cxyz = containers.bgather(xyz, order, nb)
    xn = torch.stack([(uv[..., 0] - k.cx) / k.fx, (uv[..., 1] - k.cy) / k.fy], -1)
    cxn = containers.bgather(xn, order, nb)
    rs, ts = _dlt_pose(containers.bgather(cxyz, samples, nb),
                       containers.bgather(cxn, samples, nb))
    if prior_q is not None:
        eye = torch.eye(3, dtype=rs.dtype, device=rs.device).expand(
            rs.shape[:-3] + (1, 3, 3))
        rs = torch.cat([rs, lie.quat_to_mat(prior_q)[..., None, :, :], eye], -3)
        ts = torch.cat([ts, prior_t[..., None, :],
                        torch.zeros_like(ts[..., :1, :])], -2)
    errs = _reproj_errors(k, rs, ts, xyz[..., None, :, :], uv[..., None, :, :])
    inl = (errs < threshold) & mask[..., None, :]
    scores = inl.sum(-1)
    best = torch.argmax(scores, dim=-1)
    inl_best = _take(inl, best, nb)
    score_best = _take(scores, best, nb)

    q0 = lie.mat_to_quat(_take(rs, best, nb))
    t0 = _take(ts, best, nb)
    w = inl_best.to(torch.float32)
    q, t = _gauss_newton_refine(k, q0, t0, xyz, uv, w, refine_iters)
    mid_err = _reproj_errors(k, lie.quat_to_mat(q), t, xyz, uv)
    w2 = ((mid_err < threshold) & mask).to(torch.float32)
    q, t = _gauss_newton_refine(k, q, t, xyz, uv, w2, refine_iters)
    final_err = _reproj_errors(k, lie.quat_to_mat(q), t, xyz, uv)
    inliers = (final_err < threshold) & mask
    n_in = inliers.sum(-1)
    keep = n_in >= score_best
    q = torch.where(keep[..., None], q, q0)
    t = torch.where(keep[..., None], t, t0)
    inliers = torch.where(keep[..., None], inliers, inl_best)
    n_in = torch.maximum(n_in, score_best)
    return PnPResult(q, t, inliers, n_in,
                     (count >= min_inliers) & (n_in >= min_inliers))
