"""Shared helpers of the tests that hold the PyTorch port against the JAX
reference: same inputs, same RANSAC draws, numpy in between."""

from __future__ import annotations

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dynamic_visual_slam_tpu.frontend import ransac as jax_ransac


def to_numpy_tree(nt):
    """JAX NamedTuple (nested) → dict of numpy arrays (the form the port's
    convert.py takes)."""
    if hasattr(nt, "_asdict"):
        return {k: to_numpy_tree(v) for k, v in nt._asdict().items()}
    if jnp.issubdtype(nt.dtype, jax.dtypes.prng_key):
        return np.asarray(jax.random.key_data(nt))
    return np.asarray(nt)


def from_numpy_tree(template, d):
    """dict of numpy arrays (nested) → a JAX NamedTuple shaped like
    ``template``; the template's PRNG keys (the tracker's rng) are kept."""
    vals = {}
    for name, t in template._asdict().items():
        if hasattr(t, "_asdict"):
            vals[name] = from_numpy_tree(t, d[name])
        elif jnp.issubdtype(t.dtype, jax.dtypes.prng_key):
            vals[name] = t
        else:
            vals[name] = jnp.asarray(d[name], t.dtype)
    return type(template)(**vals)


@functools.lru_cache(maxsize=None)
def _jitted_sample(n_hyp: int, size: int):
    return jax.jit(lambda key, count: jax_ransac._sample_indices(
        key, n_hyp, size, count))


class JaxSampler:
    """tracker.Sampler returning the reference's own minimal sets: frame f's
    (F-RANSAC, PnP, anchor) keys are the f-th split of the reference
    tracker's key chain, which starts at jax.random.key(0).  The geometric
    verification of the place chain keys its F-RANSAC with
    jax.random.key(seed) and its PnP with fold_in(that key, 1) (stages
    "loop_fm" and "loop_pnp", the seed passed as the frame id)."""

    def __init__(self, n_frames: int, start=None):
        r = jax.random.key(0) if start is None else start
        self.keys = {"fm": [], "pnp": [], "anchor": []}
        for _ in range(n_frames):
            r, k_fm, k_pnp, k_anc = jax.random.split(r, 4)
            self.keys["fm"].append(k_fm)
            self.keys["pnp"].append(k_pnp)
            self.keys["anchor"].append(k_anc)
        self.calls = 0

    def __call__(self, stage, frame_ids, n_hyp, size, count):
        self.calls += 1
        fn = _jitted_sample(n_hyp, size)
        out = [np.asarray(fn(self._key(stage, f), jnp.asarray(c, jnp.int32)))
               for f, c in zip(frame_ids.tolist(), count.tolist())]
        return torch.as_tensor(np.stack(out), dtype=torch.int64,
                               device=count.device)

    def _key(self, stage, f):
        if stage == "loop_fm":
            return jax.random.key(f)
        if stage == "loop_pnp":
            return jax.random.fold_in(jax.random.key(f), 1)
        return self.keys[stage][f]


class JaxFleetSampler:
    """The fleet's sampler (parallel/mesh.FleetSampler) returning the
    reference fleet's own draws: stream s's key chain starts at
    fold_in(key(0), s), the key the reference's SLAMFleet gives it, and
    frame f of stream s draws as JaxSampler's frame f."""

    def __init__(self, n_streams: int, n_frames: int):
        self.streams = [JaxSampler(n_frames, start=jax.random.fold_in(
            jax.random.key(0), s)) for s in range(n_streams)]

    def __call__(self, stage, streams, frame_ids, n_hyp, size, count):
        return torch.cat([
            self.streams[s](stage, f[None], n_hyp, size, c[None])
            for s, f, c in zip(streams.tolist(), frame_ids, count)])

    def solo(self, stream: int) -> JaxSampler:
        """The tracker.Sampler of one stream (a solo run's draws)."""
        return self.streams[stream]


class Pacer:
    """Paces a threaded run so that ApproximateTime pairs every frame with
    its detection: ``frames`` hands out frame k only once the detector has
    answered frames 0..k-1.  Then at most two frames wait for their
    detections, never more than the pairing's ``timeout_entries``, and the
    threaded run sees the detections the synchronous run sees however slow
    the detector thread is scheduled.  ``wrap`` counts a detector's answers
    (its call keeps the detector's stamp parameter)."""

    def __init__(self, timeout_s: float = 120.0):
        self.timeout_s = timeout_s
        self.answered = 0
        self._cv = threading.Condition()

    def wrap(self, call):
        def paced(det_self, rgb, stamp=None):
            out = call(det_self, rgb, stamp)
            with self._cv:
                self.answered += 1
                self._cv.notify_all()
            return out
        return paced

    def frames(self, frames):
        for k, f in enumerate(frames):
            with self._cv:
                self._cv.wait_for(lambda: self.answered >= k, self.timeout_s)
            yield f
