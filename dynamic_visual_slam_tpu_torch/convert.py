"""State carried across from the reference package, and back.

The reference's state is a tree of NamedTuples of JAX arrays.  This module
takes that state as nested dicts of numpy arrays — the caller turns each
NamedTuple into ``{field: numpy array or nested dict}``, so nothing here
imports JAX — and builds the port's NamedTuples of tensors on a device;
``to_numpy`` goes the other way.

Covered: ``Keypoints``, ``TrackerState``, ``KeyframeBlock``, ``MapState``
(``LandmarkMap`` + ``KeyframeDB``), ``BAProblem``; the place recognition
state, ``bow.Vocabulary`` (``k``, ``depth``, lists ``levels`` and
``valid``, ``word_weights``) and ``bow.Database`` (``vocabulary``,
``capacity``, ``vectors``, ``used``, ``count``), both ways; and the YOLOv8
weights (``load_params`` reads the reference's path-keyed npz,
``yolo_state_dict`` turns its HWIO tree into ``models.yolov8.YOLOv8``'s
OIHW state dict).

The reference's ``TrackerState.rng`` (a threefry key, two uint32 words a
state) has no tensor counterpart: the port takes its randomness from a
``torch.Generator`` (``SLAMSystem`` seeds its with 0, each shard of a
``SLAMFleet`` its with the index of its first stream),
or from an explicit sampler.  ``from_numpy`` leaves ``rng`` out of the
state and ``seed_from_words`` maps its words to a generator seed (the
first stream's, for a fleet's states with a leading stream dim);
``tracker_state_to_numpy`` writes the generator's seed back as
``jax.random.key(seed)``'s words (``seed_words``), one pair a stream, as
``pipeline/snapshot.py`` does.  The two packages' draws differ for the
same seed; tests that need identical draws inject the reference's own
samples.  Every function here takes leaves with any leading dims, so a
fleet's states (leading dim B) cross as a single system's do.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Type

import numpy as np
import torch

from dynamic_visual_slam_tpu_torch.backend.ba import BAProblem
from dynamic_visual_slam_tpu_torch.backend.mapping import (KeyframeDB,
                                                            LandmarkMap,
                                                            MapState)
from dynamic_visual_slam_tpu_torch.frontend.orb import Keypoints
from dynamic_visual_slam_tpu_torch.frontend.tracker import (KeyframeBlock,
                                                             TrackerState)
from dynamic_visual_slam_tpu_torch.place import bow

# fields whose type is itself a NamedTuple
_NESTED: Dict[Type, Dict[str, Type]] = {
    TrackerState: {"prev": Keypoints},
    MapState: {"landmarks": LandmarkMap, "keyframes": KeyframeDB},
}
_DROPPED = {TrackerState: ("rng",)}


def _tensor(a: Any, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)


def from_numpy(cls: Type, d: Mapping[str, Any], device="cpu"):
    """dict of numpy arrays (nested for nested NamedTuples) → ``cls`` of
    tensors on ``device``.  Unknown keys raise; the reference's ``rng`` is
    dropped (see module docstring)."""
    fields = cls._fields
    extra = set(d) - set(fields) - set(_DROPPED.get(cls, ()))
    if extra:
        raise ValueError(f"{cls.__name__}: unexpected fields {sorted(extra)}")
    nested = _NESTED.get(cls, {})
    vals = {}
    for name in fields:
        if name in nested:
            vals[name] = from_numpy(nested[name], d[name], device)
        else:
            vals[name] = _tensor(d[name], device)
    return cls(**vals)


def to_numpy(nt) -> Dict[str, Any]:
    """NamedTuple of tensors (nested) → dict of numpy arrays."""
    out = {}
    for name, v in nt._asdict().items():
        out[name] = to_numpy(v) if hasattr(v, "_asdict") else \
            v.detach().cpu().numpy()
    return out


def seed_words(seed: int) -> np.ndarray:
    """(2,) uint32 words of ``jax.random.key(seed)``."""
    seed &= (1 << 64) - 1
    return np.asarray([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def seed_from_words(words) -> int:
    """A generator seed from a reference key's words, (2,) or (..., 2):
    the first key's ``w0 << 32 | w1``."""
    w = np.asarray(words, np.uint64).reshape(-1, 2)[0]
    return int(w[0]) << 32 | int(w[1])


def tracker_state_to_numpy(state: TrackerState,
                           generator: Optional[torch.Generator] = None
                           ) -> Dict[str, Any]:
    """``to_numpy`` plus the reference's ``rng``: the words of the
    generator's seed (0 without one), one pair per leading index."""
    d = to_numpy(state)
    seed = generator.initial_seed() if generator is not None else 0
    d["rng"] = np.broadcast_to(seed_words(seed),
                               tuple(state.frame_idx.shape) + (2,)).copy()
    return d


def keypoints(d, device="cpu") -> Keypoints:
    return from_numpy(Keypoints, d, device)


def tracker_state(d, device="cpu") -> TrackerState:
    return from_numpy(TrackerState, d, device)


def keyframe_block(d, device="cpu") -> KeyframeBlock:
    return from_numpy(KeyframeBlock, d, device)


def map_state(d, device="cpu") -> MapState:
    return from_numpy(MapState, d, device)


def ba_problem(d, device="cpu") -> BAProblem:
    return from_numpy(BAProblem, d, device)


def vocabulary(d, device="cpu") -> bow.Vocabulary:
    return bow._vocabulary(d["k"], d["depth"], d["levels"], d["valid"],
                           d["word_weights"], device)


def database(d, device="cpu") -> bow.Database:
    return bow.Database(vocabulary(d["vocabulary"], device),
                        capacity=int(d["capacity"]),
                        vectors=_tensor(d["vectors"], device),
                        used=_tensor(d["used"], device), count=int(d["count"]))


def vocabulary_to_numpy(voc: bow.Vocabulary) -> Dict[str, Any]:
    return dict(k=voc.k, depth=voc.depth,
                levels=[lv.cpu().numpy() for lv in voc.levels],
                valid=[va.cpu().numpy() for va in voc.valid],
                word_weights=voc.word_weights.cpu().numpy())


def database_to_numpy(db: bow.Database) -> Dict[str, Any]:
    return dict(vocabulary=vocabulary_to_numpy(db.vocabulary),
                capacity=db.capacity, vectors=db.vectors.cpu().numpy(),
                used=db.used.cpu().numpy(), count=db.count)


def load_params(path: str) -> Dict[str, Any]:
    """The reference's YOLOv8 npz (``yolo/<path>`` keys, float32 arrays) →
    its nested parameter tree as numpy: dicts, lists where every key is a
    digit, ``num_classes`` from the last class convolution, and the
    scalar ``input_size`` when the file embeds one."""
    root: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")[1:]
            node = root
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(data[key], np.float32)
    return _yolo_tree(root)


def _yolo_tree(root: Dict[str, Any]) -> Dict[str, Any]:
    """Nested dicts keyed by path parts → the parameter tree: a dict whose
    keys are all digits becomes a list; ``num_classes`` from the last class
    convolution."""
    def listify(node):
        if isinstance(node, dict):
            if node and all(k.isdigit() for k in node):
                return [listify(node[str(i)]) for i in range(len(node))]
            return {k: listify(v) for k, v in node.items()}
        return node

    params = listify(root)
    params["num_classes"] = params["heads"][0]["cls3"]["b"].shape[0]
    return params


def yolo_state_dict(params: Mapping[str, Any], dtype=torch.bfloat16
                    ) -> Dict[str, torch.Tensor]:
    """The reference's YOLOv8 parameter tree (numpy: from ``load_params``,
    or ``np.asarray`` of its ``init_params``) → ``YOLOv8``'s state dict:
    ``w`` HWIO → OIHW, every array cast to ``dtype``: bf16 rounds to
    nearest even, as the reference's cast; float32 keeps training masters
    as they are.  ``num_classes`` and ``input_size`` are not weights and
    are skipped."""
    out: Dict[str, torch.Tensor] = {}

    def rec(node, prefix):
        if isinstance(node, Mapping):
            for k, v in node.items():
                if prefix or k not in ("num_classes", "input_size"):
                    rec(v, f"{prefix}{k}.")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, f"{prefix}{i}.")
        else:
            a = np.asarray(node, np.float32)
            if prefix.endswith("w."):
                a = a.transpose(3, 2, 0, 1)
            out[prefix[:-1]] = torch.from_numpy(
                np.ascontiguousarray(a)).to(dtype)

    rec(params, "")
    return out


def yolo_params(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """``yolo_state_dict``'s inverse: a ``YOLOv8`` state dict → the
    reference's parameter tree as numpy float32 (``w`` OIHW → HWIO; lists
    where every key is a digit) with ``num_classes``."""
    root: Dict[str, Any] = {}
    for name, t in state.items():
        parts = name.split(".")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        a = t.detach().to("cpu", torch.float32).numpy()
        node[parts[-1]] = np.ascontiguousarray(
            a.transpose(2, 3, 1, 0) if parts[-1] == "w" else a)
    return _yolo_tree(root)
