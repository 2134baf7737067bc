"""Bag-of-binary-words place recognition (the DBoW2 component).

Port of the reference package's ``place/bow.py``:

- the hierarchical vocabulary is a list of dense per-level centre tables;
  ``descend`` walks it with one batched Hamming comparison per level;
- a BoW vector is a dense (n_words,) L1-normalised tf-idf histogram;
- the database scores a query against every stored entry in one pass over
  the (capacity, n_words) matrix with DBoW2's L1 score
  s(v, w) = Σᵢ min(v̂ᵢ, ŵᵢ).

Vocabulary training is host-side numpy k-medians (DBoW2's ``create()``),
a copy of the reference's, so the same descriptors and seed give the same
tree.  Ties go as in the reference: ``descend`` takes the first minimum
(``torch.argmin``, as ``jnp.argmin``), ``Database.query`` the lower entry
id among equal scores (``containers.topk_stable``, as ``lax.top_k``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dynamic_visual_slam_tpu_torch.core.containers import topk_stable
from dynamic_visual_slam_tpu_torch.utils.profiling import TRACER, traced


# ---------------------------------------------------------------------------
# Vocabulary
# ---------------------------------------------------------------------------

@dataclass
class Vocabulary:
    """Hierarchical binary vocabulary with dense level tables.

    levels[l]: (k^(l+1), 256) uint8 bit matrix of all nodes at depth l+1,
    node n's children in rows [n*k, (n+1)*k); missing children (unbalanced
    trees) are masked by ``valid[l]``."""

    k: int
    depth: int
    levels: List[torch.Tensor]
    valid: List[torch.Tensor]
    word_weights: torch.Tensor          # (n_words,) idf weights

    @property
    def n_words(self) -> int:
        return self.levels[-1].shape[0]

    def transform(self, desc_bits: torch.Tensor, mask: torch.Tensor
                  ) -> torch.Tensor:
        """(N,256) descriptors → (n_words,) L1-normalised tf-idf vector."""
        word = descend(self, desc_bits)
        tf = torch.zeros(self.n_words, dtype=torch.float32,
                         device=desc_bits.device).index_add_(
            0, word, mask.to(torch.float32))
        v = tf * self.word_weights
        n = v.sum()
        return v / torch.where(n > 0, n, 1.0)


def descend(voc: Vocabulary, desc_bits: torch.Tensor) -> torch.Tensor:
    """(N,256) → (N,) int64 word (leaf) indices: per level, the Hamming
    argmin over the current node's k children (first minimum on ties)."""
    n = desc_bits.shape[0]
    node = torch.zeros(n, dtype=torch.int64, device=desc_bits.device)
    kids = torch.arange(voc.k, device=desc_bits.device)
    for centers, val in zip(voc.levels, voc.valid):
        child_rows = node[:, None] * voc.k + kids[None, :]
        cand = centers[child_rows]                       # (N, k, 256)
        d = (cand != desc_bits[:, None, :]).sum(-1)
        d = torch.where(val[child_rows], d, 1 << 20)
        node = node * voc.k + torch.argmin(d, dim=1)
    return node


def _vocabulary(k, depth, levels, valids, weights, device) -> Vocabulary:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bow: device='cuda' but torch.cuda.is_available() "
                           "is False; pass device='cpu'")
    return Vocabulary(
        k=int(k), depth=int(depth),
        levels=[torch.as_tensor(np.asarray(lv, np.uint8), device=dev)
                for lv in levels],
        valid=[torch.as_tensor(np.asarray(va, bool), device=dev)
               for va in valids],
        word_weights=torch.as_tensor(np.asarray(weights, np.float32),
                                     device=dev))


def train_vocabulary(descs: np.ndarray, k: int = 10, depth: int = 3,
                     seed: int = 0, iters: int = 8,
                     doc_ids: np.ndarray = None,
                     device: Any = "cuda") -> Vocabulary:
    """Host-side hierarchical binary k-medians (DBoW2 create()).

    descs: (N, 256) uint8 bits in {0,1}.  doc_ids: optional (N,) keyframe
    index per descriptor, for DBoW2's TF_IDF weighting
    idf = log(n_docs / n_docs_containing_word); without it idf counts
    descriptors.  The tables are placed on ``device``."""
    rng = np.random.default_rng(seed)
    descs = np.asarray(descs, np.uint8)

    def kmedians(data: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        if len(data) == 0:
            return np.zeros((k, 256), np.uint8), np.zeros(k, bool)
        init = data[rng.choice(len(data), size=min(k, len(data)),
                               replace=False)]
        centers = np.zeros((k, 256), np.uint8)
        centers[:len(init)] = init
        alive = np.zeros(k, bool)
        alive[:len(init)] = True
        for _ in range(iters):
            d = (data[:, None, :] != centers[None, :, :]).sum(-1)
            d[:, ~alive] = 1 << 20
            assign = d.argmin(1)
            for c in range(k):
                sel = data[assign == c]
                if len(sel):
                    centers[c] = (sel.mean(0) >= 0.5).astype(np.uint8)
        return centers, alive

    levels: List[np.ndarray] = []
    valids: List[np.ndarray] = []
    groups = {0: np.arange(len(descs))}     # descriptor indices per node
    n_nodes = 1
    for _ in range(depth):
        n_next = n_nodes * k
        centers = np.zeros((n_next, 256), np.uint8)
        valid = np.zeros(n_next, bool)
        next_groups = {}
        for node, idxs in groups.items():
            data = descs[idxs]
            c, alive = kmedians(data)
            centers[node * k:(node + 1) * k] = c
            valid[node * k:(node + 1) * k] = alive
            if len(data):
                d = (data[:, None, :] != c[None, :, :]).sum(-1)
                d[:, ~alive] = 1 << 20
                a = d.argmin(1)
                for ci in range(k):
                    next_groups[node * k + ci] = idxs[a == ci]
        levels.append(centers)
        valids.append(valid)
        groups = next_groups
        n_nodes = n_next

    n_words = n_nodes
    counts = np.zeros(n_words)
    if doc_ids is not None:
        doc_ids = np.asarray(doc_ids)
        n_docs = max(len(np.unique(doc_ids)), 1)
        for node, idxs in groups.items():
            counts[node] = len(np.unique(doc_ids[idxs]))
    else:
        n_docs = max(len(descs), 1)
        for node, idxs in groups.items():
            counts[node] = len(idxs)
    idf = np.log(n_docs / np.maximum(counts, 1.0))
    idf[counts == 0] = 0.0
    # weight 1 everywhere keeps plain tf when idf degenerates
    if not np.isfinite(idf).all() or idf.max() <= 0:
        idf = np.ones(n_words)
    return _vocabulary(k, depth, levels, valids, np.maximum(idf, 1e-3),
                       device)


def load_orbvoc_text(path: str, device: Any = "cuda") -> Vocabulary:
    """Load ORB-SLAM's pretrained ORBvoc.txt (DBoW2's text format) onto
    ``device``: a ``k L scoring weighting`` header, then one node per line
    (parent id, is_leaf, 32 byte values, weight; ids implicit in file order,
    root 0).  Bytes unpack to bits little-endian.  DBoW2 trees are
    unbalanced, so a leaf above the bottom level is propagated down as a
    single-child chain and ``descend`` lands on a weighted word."""
    with open(path) as f:
        header = f.readline().split()
        k, depth = int(header[0]), int(header[1])
        nodes = []
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parent = int(parts[0])
            bits = np.unpackbits(
                np.asarray([int(x) for x in parts[2:34]], np.uint8)[:, None],
                axis=1, bitorder="little").reshape(-1)
            weight = float(parts[34])
            nodes.append((parent, int(parts[1]), bits, weight))

    # dense level tables: children of node n at rows n*k .. n*k+k-1
    levels = [np.zeros((k ** (l + 1), 256), np.uint8) for l in range(depth)]
    valids = [np.zeros(k ** (l + 1), bool) for l in range(depth)]
    weights = np.zeros(k ** depth, np.float32)
    pos = {0: (-1, 0)}          # node id → (level, slot); root at level -1
    child_count = {0: 0}
    shallow_leaves = []
    for i, (parent, is_leaf, bits, w) in enumerate(nodes, start=1):
        pl, pslot = pos[parent]
        lvl = pl + 1
        slot = pslot * k + child_count.get(parent, 0)
        child_count[parent] = child_count.get(parent, 0) + 1
        child_count[i] = 0
        pos[i] = (lvl, slot)
        levels[lvl][slot] = bits
        valids[lvl][slot] = True
        if lvl == depth - 1:
            weights[slot] = w
        elif is_leaf:
            shallow_leaves.append((lvl, slot, bits, w))
    for lvl, slot, bits, w in shallow_leaves:
        s = slot
        for l2 in range(lvl + 1, depth):
            s = s * k
            levels[l2][s] = bits
            valids[l2][s] = True
        weights[s] = w
    return _vocabulary(k, depth, levels, valids, np.maximum(weights, 1e-6),
                       device)


def save_vocabulary(voc: Vocabulary, path: str) -> None:
    """Persist a vocabulary as compressed npz (bits packed per row), the
    layout of the reference's ``save_vocabulary``."""
    arrs = dict(k=np.asarray(voc.k), depth=np.asarray(voc.depth),
                word_weights=voc.word_weights.cpu().numpy())
    for l, (lv, va) in enumerate(zip(voc.levels, voc.valid)):
        arrs[f"level_{l}"] = np.packbits(lv.cpu().numpy().astype(np.uint8),
                                         axis=1)
        arrs[f"valid_{l}"] = va.cpu().numpy()
    np.savez_compressed(path, **arrs)


def load_vocabulary(path: str, device: Any = "cuda") -> Vocabulary:
    """Load a ``save_vocabulary`` npz (e.g. ``assets/orbvoc_synth.npz``)
    onto ``device``."""
    data = np.load(path)
    depth = int(data["depth"])
    levels = [np.unpackbits(data[f"level_{l}"], axis=1, count=256)
              for l in range(depth)]
    valids = [data[f"valid_{l}"] for l in range(depth)]
    return _vocabulary(data["k"], depth, levels, valids,
                       data["word_weights"], device)


# ---------------------------------------------------------------------------
# Database
# ---------------------------------------------------------------------------

def l1_score(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 score between L1-normalised BoW vectors: Σ min(aᵢ, bᵢ)."""
    return torch.minimum(a, b).sum(-1)


class QueryResult(NamedTuple):
    entry_ids: torch.Tensor   # (top_k,) int64
    scores: torch.Tensor      # (top_k,) float32
    valid: torch.Tensor       # (top_k,) bool


@dataclass
class Database:
    """Fixed-capacity BoW database: a ring of ``capacity`` entries on the
    vocabulary's device.  ``add`` writes in place (the reference rebuilds
    its donated arrays); neither ``add`` nor ``query`` reads the device."""

    vocabulary: Vocabulary
    capacity: int = 1024
    vectors: Optional[torch.Tensor] = None    # (capacity, n_words)
    used: Optional[torch.Tensor] = None       # (capacity,) bool
    count: int = 0

    def __post_init__(self):
        dev = self.vocabulary.word_weights.device
        if self.vectors is None:
            self.vectors = torch.zeros((self.capacity,
                                        self.vocabulary.n_words),
                                       dtype=torch.float32, device=dev)
            self.used = torch.zeros(self.capacity, dtype=torch.bool,
                                    device=dev)

    def _vector(self, desc_bits, mask) -> torch.Tensor:
        if mask is None:
            mask = torch.ones(desc_bits.shape[0], dtype=torch.bool,
                              device=desc_bits.device)
        return self.vocabulary.transform(desc_bits, mask)

    @traced("place.add")
    def add(self, desc_bits: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> int:
        """Add a keyframe's descriptors; returns its entry id (ring slot)."""
        v = self._vector(desc_bits, mask)
        slot = self.count % self.capacity
        self.vectors[slot].copy_(v)
        self.used[slot].fill_(True)
        self.count += 1
        return slot

    @traced("place.query")
    def query(self, desc_bits: torch.Tensor,
              mask: Optional[torch.Tensor] = None,
              top_k: int = 5) -> QueryResult:
        """The top_k stored entries by L1 score (unused slots score -1)."""
        TRACER.count("place.queries")
        v = self._vector(desc_bits, mask)
        scores = torch.where(self.used, l1_score(self.vectors, v[None, :]),
                             -1.0)
        vals, idx = topk_stable(scores, top_k)
        return QueryResult(idx, vals, vals >= 0)
