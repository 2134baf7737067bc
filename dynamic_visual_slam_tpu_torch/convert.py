"""State carried across from the reference package, and back.

The reference's state is a tree of NamedTuples of JAX arrays.  This module
takes that state as nested dicts of numpy arrays — the caller turns each
NamedTuple into ``{field: numpy array or nested dict}``, so nothing here
imports JAX — and builds the port's NamedTuples of tensors on a device;
``to_numpy`` goes the other way.

Covered: ``Keypoints``, ``TrackerState``, ``KeyframeBlock``, ``MapState``
(``LandmarkMap`` + ``KeyframeDB``), ``BAProblem``.

The reference's ``TrackerState.rng`` (a threefry key) has no torch
counterpart and is dropped: the port takes its randomness from a
``torch.Generator`` (``SLAMSystem`` seeds it with 0), or from an explicit
``tracker.Sampler``.  The two packages' draws differ for the same seed;
tests that need identical draws inject the reference's own samples.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Type

import numpy as np
import torch

from dynamic_visual_slam_tpu_torch.backend.ba import BAProblem
from dynamic_visual_slam_tpu_torch.backend.mapping import (KeyframeDB,
                                                            LandmarkMap,
                                                            MapState)
from dynamic_visual_slam_tpu_torch.frontend.orb import Keypoints
from dynamic_visual_slam_tpu_torch.frontend.tracker import (KeyframeBlock,
                                                             TrackerState)

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
