"""Shared helpers of the tests that hold the PyTorch port against the JAX
reference: same inputs, same RANSAC draws, numpy in between."""

from __future__ import annotations

import functools

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


@functools.lru_cache(maxsize=None)
def _jitted_sample(n_hyp: int, size: int):
    return jax.jit(lambda key, count: jax_ransac._sample_indices(
        key, n_hyp, size, count))


class JaxSampler:
    """tracker.Sampler returning the reference's own minimal sets: frame f's
    (F-RANSAC, PnP, anchor) keys are the f-th split of the reference
    tracker's key chain, which starts at jax.random.key(0)."""

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
        out = [np.asarray(fn(self.keys[stage][f], jnp.asarray(c, jnp.int32)))
               for f, c in zip(frame_ids.tolist(), count.tolist())]
        return torch.as_tensor(np.stack(out), dtype=torch.int64,
                               device=count.device)
