"""Fixed-capacity masked-set utilities.

Every variable-size set (keypoints, matches, landmarks, observations) is a
(capacity, ...) tensor plus a boolean validity mask, as in the reference.
Fixed shapes keep the device path free of host reads: boolean-mask indexing
and ``nonzero`` would each synchronise with the host to learn an output
size, so none of these helpers use them.

Tie order: ``torch.topk`` leaves the order of equal values undefined (and
does differ on CUDA), while the reference's ``lax.top_k`` puts ties at the
lower index.  Top-k here is a stable descending sort, which gives the
reference's order exactly.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

NEG_INF = -1e30


def topk_stable(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` semantics along the last dim: descending, ties at the
    lower index first.  → (values (..., k), indices (..., k) int64)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def masked_topk(scores: torch.Tensor, mask: torch.Tensor, k: int):
    """Top-k by score among valid entries (last dim).

    Returns (indices (..., k), valid (..., k)) — ``valid[i]`` false when fewer
    than k valid entries exist; callers gate on it.
    """
    s = torch.where(mask, scores, NEG_INF)
    vals, idx = topk_stable(s, k)
    return idx, vals > NEG_INF / 2


def stable_partition(mask: torch.Tensor) -> torch.Tensor:
    """(..., N) bool → (..., N) int64 permutation putting valid rows first,
    stable (``argsort(where(mask, 0, 1), stable=True)``)."""
    return torch.argsort((~mask).to(torch.int8), dim=-1, stable=True)


def topk_mask_int(scores: torch.Tensor, valid: torch.Tensor, k: int,
                  max_score: int = 255) -> torch.Tensor:
    """Mask of the k highest-scoring valid rows (last dim), for scores whose
    integer part lies in [0, max_score] (FAST responses).

    Histogram form: threshold t = lowest bucket that still fits in k → keep
    all rows above t plus the first (by index) tie rows at t.  Selects
    exactly min(k, n_valid) rows — the same set as top_k for integer
    scores."""
    s = torch.where(valid, torch.clamp(scores, 0, max_score), -1.0
                    ).to(torch.int64)                      # -1 = invalid
    bins = torch.arange(max_score + 1, device=s.device)
    hist = (s[..., None, :] == bins[:, None]).sum(-1)      # (..., max+1)
    cnt_ge = torch.flip(torch.cumsum(torch.flip(hist, [-1]), -1), [-1])
    cnt_gt = torch.cat([cnt_ge[..., 1:], torch.zeros_like(cnt_ge[..., :1])], -1)
    t = torch.argmax((cnt_gt < k).to(torch.int32), dim=-1, keepdim=True)
    sel_hi = s > t
    n_hi = sel_hi.sum(-1, keepdim=True)
    ties = s == t
    tie_rank = torch.cumsum(ties.to(torch.int64), -1) - 1
    return sel_hi | (ties & (tie_rank < k - n_hi) & valid)


def compress_to_capacity(values: Dict[str, Any], mask: torch.Tensor,
                         capacity: int, fill=0):
    """Stable-compact valid rows (dim 0) to the front, padded/truncated to
    capacity.  values: dict of tensors with leading dim N.
    → (dict with leading dim ``capacity``, newmask (capacity,))."""
    n = mask.shape[0]
    order = stable_partition(mask)
    count = mask.sum()
    if capacity <= n:
        sel = order[:capacity]
    else:
        sel = torch.cat([order, order.new_zeros(capacity - n)])
    newmask = torch.arange(capacity, device=mask.device) < count
    out = {}
    for name, v in values.items():
        g = v[sel]
        m = newmask.reshape((capacity,) + (1,) * (g.ndim - 1))
        out[name] = torch.where(m, g, torch.full_like(g, fill))
    return out, newmask


def masked_argmin(costs: torch.Tensor, mask: torch.Tensor, dim: int = -1):
    """(argmin index, min value, any-valid) along dim with invalid = +inf."""
    c = torch.where(mask, costs, -NEG_INF)
    val = torch.amin(c, dim=dim)
    idx = torch.argmin(c, dim=dim)    # first minimum, as jnp.argmin
    return idx, val, val < -NEG_INF / 2


def scatter_set(arr: torch.Tensor, idx: torch.Tensor, updates: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """arr[idx] = updates where valid (dim 0); invalid writes go to a guard
    row that is dropped.  Returns a new tensor."""
    n = arr.shape[0]
    safe = torch.where(valid, idx, n)
    ext = torch.cat([arr, arr[:1]], 0)
    ext = ext.index_copy(0, safe, updates.to(arr.dtype))
    return ext[:n]


def tree_map(fn, tree):
    """``fn`` applied to every tensor of a (nested) NamedTuple; None
    leaves stay None."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    return fn(tree)


def tree_map2(fn, a, b):
    """``fn(x, y)`` over the tensors of two (nested) NamedTuples of one
    type."""
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return type(a)(*(tree_map2(fn, x, y) for x, y in zip(a, b)))
    return fn(a, b)


def tree_stack(trees):
    """A list of (nested) NamedTuples of one type → one whose tensors are
    stacked along a new leading dim."""
    first = trees[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(tree_stack([getattr(t, n) for t in trees])
                             for n in first._fields))
    return torch.stack(trees)


def row(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d index tensor without a host read (indexing with a
    0-d tensor converts it to a Python int, which waits for the device)."""
    return x.index_select(0, i.reshape(1)).squeeze(0)


def count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(-1)


def bgather(x: torch.Tensor, idx: torch.Tensor, batch_dims: int) -> torch.Tensor:
    """Batched row gather along the dim after ``batch_dims`` leading dims:
    x (*b, N, *f), idx (*b, *s) int → (*b, *s, *f) = x[b..., idx, :]."""
    b = x.shape[:batch_dims]
    n = x.shape[batch_dims]
    f = x.shape[batch_dims + 1:]
    s = idx.shape[batch_dims:]
    nb = 1
    for d in b:
        nb *= d
    nf = 1
    for d in f:
        nf *= d
    xb = x.reshape(nb, n, nf)
    ib = idx.reshape(nb, -1, 1).expand(-1, -1, nf)
    return torch.gather(xb, 1, ib).reshape(b + s + f)
