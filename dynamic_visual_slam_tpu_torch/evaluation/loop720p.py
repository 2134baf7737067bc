"""Loop closure at the shipped 720p defaults on the port: the counterpart
of the reference's ``scripts/loop720p.py``.

    python scripts/torch_loop720p.py [--frames-per-orbit 240] [--orbits 3]
        [--batch 24] [--drift 0.35] [--noise 0] [--[no-]loop-pgo]
        [--out loop720p_torch.json] [--device cuda|cpu]

The fixture is the reference's: the seed-5 scene, ``orbits`` orbits of
``loop_trajectory`` (radius 0.35, then 0.34, alternating), depth scaled
by up to 1 + ``drift`` over the run, optional Gaussian image noise from
``default_rng(11)``, the depth gate widened to 6.0 m.  The run is the
reference's: ``SLAMSystem(cfg, ba_async=True, sync_every=2)`` with the
shipped vocabulary, ``warmup_place``, batches of ``batch`` through
``process_batch``, the tail frame by frame, once with loop correction and
once without (the control).  The record has the reference's keys plus
``device`` and ``power_limit``; the contract is the reference's: at least
one loop applied, and the ATE with loops at most max(1.5 x the ATE
without, 0.2 m).  Exit code 1 when it fails.

The frames render in spawned worker processes (a 720p frame takes the
host about half a second); the drift and the noise are applied in frame
order afterwards, so the frames are the reference's bit for bit.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses as dc
import json
import multiprocessing
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dynamic_visual_slam_tpu_torch.config import CameraConfig, SLAMConfig
from dynamic_visual_slam_tpu_torch.evaluation import card
from dynamic_visual_slam_tpu_torch.io import synthetic
from dynamic_visual_slam_tpu_torch.io.trajectory import ate_rmse
from dynamic_visual_slam_tpu_torch.pipeline.slam import (SLAMSystem,
                                                         resolve_device)

VOCAB = Path(__file__).resolve().parents[2] / "assets" / "orbvoc_synth.npz"
CONFIG_NOTE = ("shipped defaults (pretrained vocab, loop_pgo on, geometric "
               "verification on, reloc on)")


def fixture_config(cfg: SLAMConfig) -> SLAMConfig:
    """``cfg`` with the depth gate widened to 6.0 m, so that the scaled
    depths stay inside it."""
    return cfg.replace(depth=dc.replace(cfg.depth, max_depth=6.0))


def poses(frames_per_orbit: int, orbits: int):
    """The revisit trajectory: ``orbits`` orbits of ``loop_trajectory``,
    radius 0.35 - 0.01 (k % 2)."""
    out = []
    for k in range(orbits):
        out += synthetic.loop_trajectory(frames_per_orbit,
                                         radius=0.35 - 0.01 * (k % 2))
    return out


def _render(cam: CameraConfig, part) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Gray and depth of each pose of ``part`` (a worker's share)."""
    scene = synthetic.SyntheticScene(cam, seed=5)
    return [scene.render(r, t) for r, t in part]


def fixture(cam: CameraConfig, frames_per_orbit: int, orbits: int,
            drift: float, noise: float, workers: int = 0
            ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """[(gray uint8, depth uint16 millimetres, t_gt)] of the revisit run;
    ``workers`` > 0 renders in that many spawned processes."""
    trajectory = poses(frames_per_orbit, orbits)
    n = len(trajectory)
    if workers > 0:
        k = max(1, min(workers, n))
        cuts = [n * j // k for j in range(k + 1)]
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(
                k, mp_context=ctx) as pool:
            parts = pool.map(_render, [cam] * k,
                             [trajectory[a:b] for a, b in zip(cuts,
                                                              cuts[1:])])
            rendered = [f for part in parts for f in part]
    else:
        rendered = _render(cam, trajectory)
    rng = np.random.default_rng(11)
    frames = []
    for i, ((gray, depth), (_, t)) in enumerate(zip(rendered, trajectory)):
        scale = 1.0 + drift * i / n
        g = gray.astype(np.float32)
        if noise > 0.0:
            g = g + rng.normal(0.0, noise, g.shape)
        frames.append((np.clip(g, 0, 255).astype(np.uint8),
                       (depth * scale * 1000.0).astype(np.uint16), t))
    return frames


def run(cfg: SLAMConfig, frames, *, batch: int, loop_correction: bool,
        loop_pgo: bool, device, vocab_path: Optional[str] = None):
    """One pass of the reference's run → (system, ATE in m, wall s)."""
    gt = np.stack([t for _, _, t in frames])
    n = len(frames)
    slam = SLAMSystem(cfg, ba_async=True, sync_every=2,
                      vocab_path=vocab_path, loop_correction=loop_correction,
                      loop_pgo=loop_pgo, device=device)
    slam.warmup_place()
    t0 = time.perf_counter()
    for i0 in range(0, n - n % batch, batch):
        gs = np.stack([frames[i0 + j][0] for j in range(batch)])
        ds = np.stack([frames[i0 + j][1] for j in range(batch)])
        slam.process_batch(gs, ds, (i0 + np.arange(batch)) / 30.0)
    for i in range(n - n % batch, n):
        slam.process(frames[i][0], frames[i][1], i / 30.0)
    slam.finalize()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    est = np.stack([f.t_wc for f in slam.trajectory])
    order = np.argsort([f.timestamp for f in slam.trajectory])
    est = est[order]
    return slam, float(ate_rmse(est, gt[: len(est)])), wall


def evaluate(cfg: SLAMConfig, frames, *, batch: int, loop_pgo: bool,
             device, drift: float, noise: float,
             vocab_path: Optional[str] = None) -> Dict:
    """Loops on, then off (the control) → the reference's record with
    ``passed``, the contract's verdict, beside it (not in the record)."""
    print("== loops ON (shipped defaults) ==", flush=True)
    slam_on, ate_on, wall_on = run(cfg, frames, batch=batch,
                                   loop_correction=True, loop_pgo=loop_pgo,
                                   device=device, vocab_path=vocab_path)
    print(f"ate={ate_on:.4f} loops_applied="
          f"{slam_on.stats.get('loops_applied', 0)} "
          f"candidates={slam_on.stats['loop_candidates']} "
          f"wall={wall_on:.1f}s", flush=True)
    for rec in slam_on.loop_candidates:
        print("  loop:", json.dumps(rec), flush=True)
    print("== loops OFF (control) ==", flush=True)
    _, ate_off, _ = run(cfg, frames, batch=batch, loop_correction=False,
                        loop_pgo=loop_pgo, device=device,
                        vocab_path=vocab_path)
    print(f"ate={ate_off:.4f}", flush=True)
    rec = dict(
        platform="gpu" if torch.device(device).type == "cuda" else "cpu",
        resolution=f"{cfg.camera.width}x{cfg.camera.height}",
        frames=len(frames), drift_injected=drift, noise_std=noise,
        config=CONFIG_NOTE,
        loops_applied=int(slam_on.stats.get("loops_applied", 0)),
        loop_candidates=int(slam_on.stats["loop_candidates"]),
        keyframes=int(slam_on.stats["keyframes"]),
        ate_with_loops_m=round(ate_on, 5),
        ate_without_loops_m=round(ate_off, 5),
        improvement=round(ate_off / max(ate_on, 1e-9), 3),
        wall_s=round(wall_on, 1))
    rec["loops"] = slam_on.loop_candidates
    rec["scheme"] = "pgo" if loop_pgo else "interp"
    # the contract: the chain fires and the ATE stays bounded
    passed = rec["loops_applied"] >= 1 and ate_on <= max(1.5 * ate_off, 0.2)
    return dict(record=rec, passed=passed)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="torch_loop720p")
    ap.add_argument("--frames-per-orbit", type=int, default=240)
    ap.add_argument("--orbits", type=int, default=3)
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--drift", type=float, default=0.35,
                    help="injected depth-scale drift over the run")
    ap.add_argument("--noise", type=float, default=0.0,
                    help="additive Gaussian image noise std (u8 levels)")
    ap.add_argument("--out", default="loop720p_torch.json")
    ap.add_argument("--loop-pgo", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="loop consumption scheme (--no-loop-pgo = the "
                         "age-interpolated correction)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    device_name, power_limit = card(dev)
    cfg = fixture_config(SLAMConfig())     # shipped 1280x720 defaults
    frames = fixture(cfg.camera, args.frames_per_orbit, args.orbits,
                     args.drift, args.noise,
                     workers=min(8, os.cpu_count() or 1))
    res = evaluate(cfg, frames, batch=args.batch, loop_pgo=args.loop_pgo,
                   device=dev, drift=args.drift, noise=args.noise,
                   vocab_path=str(VOCAB) if VOCAB.exists() else None)
    rec = dict(res["record"], device=device_name, power_limit=power_limit)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=2)
    print(json.dumps(rec, indent=2))
    print("PASS" if res["passed"] else "FAIL", flush=True)
    return 0 if res["passed"] else 1
