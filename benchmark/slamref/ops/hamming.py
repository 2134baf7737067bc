"""Hamming descriptor distance + brute-force matching as matrix products.

With descriptors kept as 256 unpacked bits, popcount(a XOR b) =
|a| + |b| − 2 a·b, so the N × M distance matrix is one (N,256)×(256,M)
product plus rank-1 corrections.  The product runs in float32 with TF32
off (package-wide), which is exact for sums ≤ 256.

Descriptors: ``bits`` are (..., N, 256) in {0,1} (uint8 or float);
``packed`` is the 32-byte OpenCV wire format (LSB-first per byte).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slamref.core.containers import masked_argmin


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) {0,1} → (..., 32) uint8, LSB-first within each byte."""
    w = 2 ** torch.arange(8, dtype=torch.int32, device=bits.device)
    b = bits.to(torch.int32).reshape(bits.shape[:-1] + (32, 8))
    return (b * w).sum(-1).to(torch.uint8)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """(..., 32) uint8 → (..., 256) uint8 in {0,1}."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[:-1] + (256,))


def hamming_matrix(a_bits: torch.Tensor, b_bits: torch.Tensor) -> torch.Tensor:
    """(..., N,256),(..., M,256) {0,1} → (..., N,M) float32 distances."""
    a = a_bits.to(torch.float32)
    b = b_bits.to(torch.float32)
    dot = torch.matmul(a, b.transpose(-1, -2))
    na = a.sum(-1)
    nb = b.sum(-1)
    return na[..., :, None] + nb[..., None, :] - 2.0 * dot


class MatchResult(NamedTuple):
    """For each query row: best train index, distance, validity."""

    train_idx: torch.Tensor   # (..., N) int64
    distance: torch.Tensor    # (..., N) float32
    valid: torch.Tensor       # (..., N) bool


def match(query_bits: torch.Tensor, train_bits: torch.Tensor,
          query_mask: torch.Tensor, train_mask: torch.Tensor,
          max_distance: float = 256.0, cross_check: bool = False) -> MatchResult:
    """BFMatcher.match equivalent: nearest train descriptor per query (first
    index on ties), with a distance gate.  cross_check=True additionally
    requires mutual nearest neighbours.  Leading batch dims are allowed."""
    d = hamming_matrix(query_bits, train_bits)          # (..., N, M)
    pair_ok = query_mask[..., :, None] & train_mask[..., None, :]
    idx, dist, any_valid = masked_argmin(d, pair_ok, dim=-1)
    valid = any_valid & (dist < max_distance) & query_mask
    if cross_check:
        ridx, _, r_ok = masked_argmin(d, pair_ok, dim=-2)
        n = d.shape[-2]
        mutual = torch.gather(ridx, -1, idx) == torch.arange(n, device=d.device)
        valid = valid & mutual & torch.gather(r_ok, -1, idx)
    return MatchResult(idx, dist, valid)
