"""Small-matrix linear algebra for thousands of tiny batched systems.

Same closed-form / fixed-iteration methods as the reference package's
``ops/linalg_small.py``: LAPACK-style batched decompositions would each be a
library call with its own launches (and, for some torch.linalg routines on
CUDA, host synchronisation), while these are a fixed chain of batched
elementwise ops and matmuls:

- smallest_eigvec: shifted power iteration by repeated squaring, polished by
  two inverse-iteration steps (the 8-point, DLT and triangulation
  nullspaces);
- eigh3x3 / svd3x3: closed-form symmetric 3x3 eigendecomposition
  (trigonometric Cardano) + SVD built from it;
- solve_psd: unrolled pivot-free Gauss-Jordan for small SPD systems.

All functions accept arbitrary leading batch dims.
"""

from __future__ import annotations

import math

import torch

from slamref.core.lie import cross, det3x3


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def smallest_eigvec(m: torch.Tensor, squarings: int = 8) -> torch.Tensor:
    """Smallest-eigenvalue unit eigenvector of symmetric PSD m (..., n, n)."""
    n = m.shape[-1]
    shift = torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    b = shift * _eye(n, m) - m
    for _ in range(squarings):
        b = b / torch.clamp(torch.linalg.matrix_norm(b, keepdim=True), min=1e-30)
        b = b @ b
    ar = torch.arange(n, dtype=m.dtype, device=m.device)
    v = torch.ones(m.shape[:-2] + (n, 1), dtype=m.dtype, device=m.device) \
        + 0.1 * ar[:, None]
    v = b @ (b @ v)
    nrm = torch.linalg.vector_norm(v, dim=-2, keepdim=True)
    v2 = b @ (b @ torch.cos(ar)[:, None])
    v = torch.where(nrm > 1e-25, v, v2)
    v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-2, keepdim=True),
                        min=1e-30)
    v = v[..., 0]
    eps = 1e-7 * shift[..., 0, 0] + 1e-30
    for _ in range(2):
        v = solve_psd(m + eps[..., None, None] * _eye(n, m), v)
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                            min=1e-30)
    return v


def eigh3x3(a: torch.Tensor):
    """Symmetric (...,3,3) → (eigvals ascending (...,3), eigvecs (...,3,3)
    columns).  Closed-form eigenvalues; eigenvectors from the largest cross
    product of two shifted rows, with a degeneracy fallback."""
    dtype = a.dtype
    a = a.to(torch.float32)
    q = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1) / 3.0
    b = a - q[..., None, None] * _eye(3, a)
    p2 = (b * b).sum((-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    detb = det3x3(b)
    r = detb / (2.0 * torch.clamp(p, min=1e-30) ** 3)
    r = torch.clamp(r, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    vals = torch.stack([e3, e2, e1], dim=-1)

    def eigvec(ev):
        m = a - ev[..., None, None] * _eye(3, a)
        c01 = cross(m[..., 0, :], m[..., 1, :])
        c02 = cross(m[..., 0, :], m[..., 2, :])
        c12 = cross(m[..., 1, :], m[..., 2, :])
        cands = torch.stack([c01, c02, c12], dim=-2)
        norms = (cands * cands).sum(-1)
        best = torch.argmax(norms, dim=-1)
        v = torch.gather(cands, -2, best[..., None, None].expand(
            best.shape + (1, 3)))[..., 0, :]
        nrm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        fallback = torch.eye(1, 3, dtype=a.dtype,
                             device=a.device)[0].expand(v.shape)
        return torch.where(nrm > 1e-20, v / torch.clamp(nrm, min=1e-30),
                           fallback)

    v1 = eigvec(e3)
    v3 = eigvec(e1)
    v2 = cross(v3, v1)
    v2 = v2 / torch.clamp(torch.linalg.vector_norm(v2, dim=-1, keepdim=True),
                          min=1e-30)
    vecs = torch.stack([v1, v2, v3], dim=-1)
    return vals.to(dtype), vecs.to(dtype)


def svd3x3(m: torch.Tensor):
    """(...,3,3) → (u, s, vt) with s descending; built on eigh3x3(mᵀm)."""
    mtm = m.transpose(-1, -2) @ m
    vals, v = eigh3x3(mtm)
    s = torch.sqrt(torch.clamp(torch.flip(vals, [-1]), min=0.0))
    v = torch.flip(v, [-1])
    u_raw = m @ v
    nrm = torch.linalg.vector_norm(u_raw, dim=-2, keepdim=True)
    u = u_raw / torch.clamp(nrm, min=1e-30)
    u2 = cross(u[..., :, 0], u[..., :, 1])
    u_fixed_col2 = torch.where(nrm[..., 0, 2:3] > 1e-12, u[..., :, 2], u2)
    u = torch.cat([u[..., :, :2], u_fixed_col2[..., :, None]], dim=-1)
    return u, s, v.transpose(-1, -2)


def procrustes_rotation(m: torch.Tensor) -> torch.Tensor:
    """Nearest rotation matrix to m (...,3,3): U diag(1,1,det(UVᵀ)) Vᵀ."""
    u, _, vt = svd3x3(m)
    det = det3x3(u @ vt)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    return (u * d[..., None, :]) @ vt


def solve_psd(a: torch.Tensor, b: torch.Tensor, damping: float = 0.0,
              refine: int = 0) -> torch.Tensor:
    """Unrolled pivot-free Gauss-Jordan solve of small SPD systems.
    refine > 0 adds rounds of iterative refinement x += solve(a, b − a x).
    a: (..., n, n), b: (..., n) → (..., n)."""
    n = a.shape[-1]
    if damping:
        a = a + damping * _eye(n, a)
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-1])
    a = a.expand(lead + (n, n))
    b = b.expand(lead + (n,))

    def gj(rhs):
        aug = torch.cat([a, rhs[..., None]], dim=-1)   # (..., n, n+1)
        for i in range(n):
            piv = aug[..., i, i:i + 1]
            piv = torch.where(torch.abs(piv) < 1e-20, 1e-20, piv)
            row = aug[..., i, :] / piv
            factors = aug[..., :, i:i + 1]
            aug = aug - factors * row[..., None, :]
            aug[..., i, :] = row
        return aug[..., :, -1]

    x = gj(b)
    for _ in range(refine):
        resid = b - (a @ x[..., None])[..., 0]
        x = x + gj(resid)
    return x
