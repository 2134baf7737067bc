"""The cell's frames, rendered from the seed by the benchmark's own copy of
the synthetic renderer (``slamref.io.synthetic``) in spawned worker
processes, in the formats the traffic mix names.

Traffic keys read here: ``frames`` (distinct frames, cycled by the driver),
``trajectory`` ("orbit": ``generate_sequence``'s wandering camera, its
seed ``trajectory_seed``, or s + 1 for scene seed s as there; "loop": one
closed orbit of ``loop_trajectory``, radius ``radius``), ``walkers`` (``default_walkers``
in the scene, rendered at each frame's time), ``gray`` ("uint8" or
"float32"), ``depth`` ("uint16_mm" or "float32_m"), ``rgb`` (the gray frame
as three uint8 channels, for the detector).
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

SEED_MOD = 2 ** 63
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def scene_seed(seed: int) -> int:
    """--seed as a scene seed: any whole number, kept non-negative."""
    return int(seed) % SEED_MOD


def poses(traffic: Dict[str, Any], seed: int):
    from slamref.io import synthetic
    n = int(traffic["frames"])
    kind = traffic.get("trajectory", "orbit")
    if kind == "orbit":
        traj_seed = traffic.get("trajectory_seed")
        return synthetic.orbit_trajectory(n, seed=scene_seed(seed) + 1
                                          if traj_seed is None
                                          else int(traj_seed))
    if kind == "loop":
        return synthetic.loop_trajectory(n, radius=float(
            traffic.get("radius", 0.35)))
    raise ValueError(f"unknown trajectory {kind!r}")


def _render_part(camera: Dict[str, Any], traffic: Dict[str, Any], seed: int,
                 lo: int, hi: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Gray (float32) and depth (float32 metres) of frames lo .. hi - 1."""
    from slamref.config import CameraConfig
    from slamref.io import synthetic
    cam = CameraConfig(**camera)
    n = int(traffic["frames"])
    objects = synthetic.default_walkers(n, int(traffic["walkers"])) \
        if traffic.get("walkers") else ()
    scene = synthetic.SyntheticScene(cam, seed=scene_seed(seed),
                                     objects=objects)
    traj = poses(traffic, seed)
    return [scene.render(r, t, t_s=i / 30.0)
            for i, (r, t) in enumerate(traj[lo:hi], start=lo)]


def _formats(gray: np.ndarray, depth: np.ndarray, traffic: Dict[str, Any]
             ) -> Dict[str, np.ndarray]:
    g8 = gray.astype(np.uint8)
    out = {"gray": g8 if traffic.get("gray", "uint8") == "uint8"
           else g8.astype(np.float32)}
    if traffic.get("depth", "uint16_mm") == "uint16_mm":
        out["depth"] = (depth * 1000.0).astype(np.uint16)
    else:
        out["depth"] = depth.astype(np.float32)
    if traffic.get("rgb"):
        out["rgb"] = np.stack([g8] * 3, axis=-1)
    return out


def render(camera: Dict[str, Any], traffic: Dict[str, Any], seed: int,
           workers: int = 8) -> List[Dict[str, np.ndarray]]:
    """The ``traffic["frames"]`` frames of the mix for ``seed``: one dict a
    frame with ``gray``, ``depth`` and, if asked, ``rgb``.  The gray frame
    is the renderer's rounded to uint8, whatever format is handed over, so
    every format shows the same image.  ``workers`` > 1 renders in that
    many spawned processes."""
    n = int(traffic["frames"])
    workers = max(1, min(workers, n, os.cpu_count() or 1))
    bounds = np.linspace(0, n, workers + 1).astype(int)
    parts: Sequence[Tuple[int, int]] = [
        (int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
    if workers == 1:
        raw = [f for lo, hi in parts
               for f in _render_part(camera, traffic, seed, lo, hi)]
    else:
        # one thread a worker: the workers share the cores already
        saved = {k: os.environ.get(k) for k in THREAD_VARS}
        os.environ.update({k: "1" for k in THREAD_VARS})
        try:
            ctx = multiprocessing.get_context("spawn")
            with ProcessPoolExecutor(len(parts), mp_context=ctx) as pool:
                futs = [pool.submit(_render_part, camera, traffic, seed, lo,
                                    hi) for lo, hi in parts]
                raw = [f for fut in futs for f in fut.result()]
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return [_formats(g, d, traffic) for g, d in raw]
