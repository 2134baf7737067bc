"""Map / pose snapshotting: checkpoint and resume.

Port of the reference package's ``pipeline/snapshot.py``.  The system's
state is two fixed-shape trees (``TrackerState``, ``MapState``), so a
checkpoint is a flat npz: one key per leaf (``tracker/prev/uv``,
``map/landmarks/xyz``, ...), the reference's keys, shapes and dtypes
(bfloat16 widened to float32), and ``__config__``, the config's JSON as
uint8 bytes.  Either package loads the other's files.

Randomness.  The reference keeps a threefry key in its tracker state
(``tracker/rng``, two uint32 words); the port draws its RANSAC samples from
a ``torch.Generator`` the caller owns (``SLAMSystem.generator``).  ``save``
writes ``tracker/rng`` as the key of the generator's seed, ``[seed >> 32,
seed & 0xffffffff]`` (``jax.random.key(seed)``'s words), so the reference
loads the file, and the generator's own state under ``torch/generator``,
which the reference's loader ignores.  ``load`` restores that state when it
is there and was saved from a generator of the same device type; otherwise
(a reference snapshot) it seeds the generator with the two key words.  A
port run resumed from a port snapshot draws what the uninterrupted run
would have drawn; a run resumed across packages draws other samples from
there on (the two packages' generators differ anyway).

Host clock.  The reference saves the device states only, so a system it
restores starts a new time base and BA timer at its first frame and counts
frames (the relocalization draws' key) from 0: its BA rounds and
relocalization draws then fall elsewhere than in the uninterrupted run.
``SLAMSystem.save`` adds those host counters under ``torch/host`` (JSON),
which the reference's loader ignores, and the port's ``restore`` resumes
them, so a resume within the port is exact.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from dynamic_visual_slam_tpu_torch import convert
from dynamic_visual_slam_tpu_torch.backend import mapping
from dynamic_visual_slam_tpu_torch.config import SLAMConfig
from dynamic_visual_slam_tpu_torch.frontend import tracker
from dynamic_visual_slam_tpu_torch.pipeline.slam import resolve_device

GENERATOR_KEY = "torch/generator"
GENERATOR_DEVICE_KEY = "torch/generator_device"
HOST_KEY = "torch/host"


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            _flatten(getattr(tree, name), f"{prefix}/{name}", out)
    else:
        if tree.dtype == torch.bfloat16:
            tree = tree.to(torch.float32)
        out[prefix] = tree.detach().cpu().numpy()


def save(path: str, tracker_state: tracker.TrackerState,
         map_state: mapping.MapState, config: SLAMConfig,
         generator: Optional[torch.Generator] = None,
         host: Optional[Dict[str, Any]] = None) -> None:
    """One npz of both states and the config (see module docstring);
    ``generator`` (the tracker's) adds its state, ``host`` (a JSON-able
    dict of the caller's host-side counters) goes under ``torch/host``."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(tracker_state, "tracker", flat)
    flat["tracker/rng"] = convert.seed_words(
        generator.initial_seed() if generator is not None else 0)
    _flatten(map_state, "map", flat)
    flat["__config__"] = np.frombuffer(config.to_json().encode(),
                                       dtype=np.uint8)
    if generator is not None:
        flat[GENERATOR_KEY] = generator.get_state().numpy()
        flat[GENERATOR_DEVICE_KEY] = np.frombuffer(
            generator.device.type.encode(), dtype=np.uint8)
    if host is not None:
        flat[HOST_KEY] = np.frombuffer(json.dumps(host).encode(),
                                       dtype=np.uint8)
    np.savez_compressed(path, **flat)


def _rebuild(cls, prefix: str, data, template) -> Any:
    """``cls`` from the npz's ``prefix/...`` keys; a field missing from the
    file (added after it was written) keeps the template's value."""
    vals = []
    for name in cls._fields:
        key = f"{prefix}/{name}"
        tmpl = getattr(template, name)
        if isinstance(tmpl, tuple) and hasattr(tmpl, "_fields"):
            vals.append(_rebuild(type(tmpl), key, data, tmpl))
        elif key not in data:
            vals.append(tmpl)
        else:
            vals.append(torch.from_numpy(np.array(data[key])).to(
                device=tmpl.device, dtype=tmpl.dtype))
    return cls(*vals)


def _restore_generator(data, generator: torch.Generator) -> None:
    """Set ``generator`` from a snapshot's arrays (module docstring)."""
    if GENERATOR_KEY in data and bytes(data[GENERATOR_DEVICE_KEY]).decode() \
            == generator.device.type:
        generator.set_state(torch.from_numpy(np.array(data[GENERATOR_KEY])))
        return
    generator.manual_seed(convert.seed_from_words(data["tracker/rng"]))


def load(path: str, device="cuda",
         generator: Optional[torch.Generator] = None
         ) -> Tuple[tracker.TrackerState, mapping.MapState, SLAMConfig]:
    """→ (TrackerState, MapState, SLAMConfig) on ``device``; ``generator``,
    if given, is set from the file (module docstring)."""
    dev = resolve_device(device)
    with np.load(path) as data:
        config = SLAMConfig.from_json(bytes(data["__config__"]).decode())
        ts = _rebuild(tracker.TrackerState, "tracker", data,
                      tracker.init_state(config, dev))
        ms = _rebuild(mapping.MapState, "map", data,
                      mapping.init_map(config, dev))
        # two fields added after the first snapshots are not safe as the
        # template's zeros:
        if "map/landmarks/desc_anchor" not in data:
            # a zero anchor would win min-Hamming association for
            # low-popcount descriptors; the newest descriptor was the only
            # one stored when the snapshot was written
            ms = ms._replace(landmarks=ms.landmarks._replace(
                desc_anchor=ms.landmarks.desc_bits))
        if "tracker/kf_xyz_w" not in data:
            # no anchor points stored: drop the keyframe arm so the next
            # frame keyframes again instead of anchoring PnP on zeros
            ts = ts._replace(has_kf=torch.zeros((), dtype=torch.bool,
                                                device=dev))
        if generator is not None:
            _restore_generator(data, generator)
    return ts, ms, config


def load_host(path: str) -> Optional[Dict[str, Any]]:
    """The ``host`` dict ``save`` wrote, or None (a reference snapshot)."""
    with np.load(path) as data:
        if HOST_KEY not in data:
            return None
        return json.loads(bytes(data[HOST_KEY]).decode())
