"""The parity sweep on the port: the counterpart of the reference's
``scripts/parity_sweep.py``.

    python scripts/torch_parity_sweep.py [--seeds 5] [--out parity_sweep_torch]
        [--quick] [--frames-list 120 240 480] [--res-list 640x480]
        [--sync-every 8] [--device cuda|cpu]

Grid: seeds x frame counts (120, 240, 480) x resolutions (424x240,
640x480) x tracking modes (frame-to-frame, anchored), the port's
``SLAMSystem`` (place recognition off) against the CPU oracle
(``oracle/pipeline_cpu.OracleSLAM``) on ``generate_sequence(cam, n,
seed, depth_noise=0.004)``.  Both pipelines are causal and the sequence
is prefix-stable, so one run of the longest length a (resolution, seed,
mode) gives every shorter cell by slicing.  ``--quick``: 2 seeds x (120,
240) x 424x240.

Artifacts, the reference's schema key for key (``platform`` is "gpu" on a
card; each cell and the summary add ``device``, the card's name, and
``power_limit``, nvidia-smi's):
  <out>/cell_f{frames}_{W}x{H}_{mode}.json   per-cell seed runs
  <out>/sweep.json                           everything + summary
  <out>/oracle_cache/oracle_{W}x{H}_seed{s}_f{n}_{fingerprint}.npz
  <out>/runs/run_{W}x{H}_seed{s}_{mode}_f{n}_{fingerprint}.npz

The oracle's trajectories are cached by config fingerprint, as the
reference's are.  Unlike the reference, the port also caches its own runs
(``runs/``, keyed the same way), so that a matrix can be filled in across
several calls: a call that is cut resumes where it stopped.  ``--out``
never points under the reference's ``parity_sweep/``, whose oracle cache
holds an older configuration's trajectories.
"""

from __future__ import annotations

import argparse
import dataclasses as dc
import hashlib
import json
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from dynamic_visual_slam_tpu_torch.config import SLAMConfig
from dynamic_visual_slam_tpu_torch.evaluation import card
from dynamic_visual_slam_tpu_torch.io import synthetic, trajectory
from dynamic_visual_slam_tpu_torch.oracle.pipeline_cpu import OracleSLAM
from dynamic_visual_slam_tpu_torch.pipeline.slam import (SLAMSystem,
                                                         resolve_device)

REFERENCE_OUT = Path(__file__).resolve().parents[2] / "parity_sweep"
MODES = ("anchored", "frame2frame")
DEPTH_NOISE = 0.004
PROVENANCE = ("prefix-sliced from one {n}-frame run per seed (strictly "
              "causal pipeline, prefix-stable sequence)")


def cfg_fingerprint(cfg: SLAMConfig) -> str:
    """The reference's cache key: the first 16 hex digits of the SHA-256
    of the config's sorted JSON."""
    return hashlib.sha256(
        json.dumps(cfg.to_dict(), sort_keys=True).encode()).hexdigest()[:16]


def mode_config(cfg0: SLAMConfig, mode: str) -> SLAMConfig:
    """``cfg0`` with keyframe anchoring on ("anchored") or off."""
    return cfg0.replace(tracking=dc.replace(
        cfg0.tracking, anchor_to_keyframe=(mode == "anchored")))


def run_record(seed: int, n_frames: int, gt_t, orc_t, orc_kf_cum,
               orc_ba_cum, tpu_t, tpu_kf_cum) -> Dict:
    """One seed's entry of a cell, from full-length trajectories and
    per-frame cumulative counters sliced to ``n_frames``."""
    gt_n, orc_n, tpu_n = gt_t[:n_frames], orc_t[:n_frames], tpu_t[:n_frames]
    orc_ate = float(trajectory.ate_rmse(orc_n, gt_n))
    tpu_ate = float(trajectory.ate_rmse(tpu_n, gt_n))
    return dict(
        seed=seed, source=f"synthetic(seed={seed})", frames=n_frames,
        tpu_keyframes=int(tpu_kf_cum[n_frames - 1]),
        oracle_keyframes=int(orc_kf_cum[n_frames - 1]),
        oracle_ba_rounds=int(orc_ba_cum[n_frames - 1]),
        tpu_vs_oracle_ate_m=round(float(trajectory.ate_rmse(tpu_n, orc_n)),
                                  5),
        tpu_ate_m=round(tpu_ate, 5),
        oracle_ate_m=round(orc_ate, 5),
        ate_ratio=round(tpu_ate / max(orc_ate, 1e-9), 4))


def summarize(runs: Sequence[Dict]) -> Dict:
    """A cell's aggregate over its seed runs, with the reference's
    rounding: the ATE ratio's mean, median and worst, and each pipeline's
    mean ATE."""
    ratios = [r["ate_ratio"] for r in runs]
    return dict(
        ate_ratio_mean=round(float(np.mean(ratios)), 4),
        ate_ratio_median=round(float(np.median(ratios)), 4),
        ate_ratio_worst=round(float(np.max(ratios)), 4),
        tpu_ate_mean_m=round(float(np.mean([r["tpu_ate_m"] for r in runs])),
                             5),
        oracle_ate_mean_m=round(float(np.mean(
            [r["oracle_ate_m"] for r in runs])), 5))


def run_pipeline_full(cfg: SLAMConfig, frames, sync_every: int, device):
    """One full-length run of the port → (positions (N, 3), cumulative
    keyframes (N,))."""
    slam = SLAMSystem(cfg, enable_place_recognition=False,
                      sync_every=max(1, sync_every), device=device)
    for gray, depth, _, _, ts in frames:
        slam.process(gray, depth, ts)
    slam.finalize()
    _, _, t = slam.frontend_trajectory()
    return t, np.cumsum([f.is_keyframe for f in slam.trajectory])


def run_oracle_full(cfg: SLAMConfig, frames):
    """One full-length oracle run → (positions, cumulative keyframes,
    cumulative BA rounds), the counters read after every frame; prints how
    many frames' F estimates raised in OpenCV, if any."""
    orc = OracleSLAM(cfg, run_ba=True)
    kf_cum, ba_cum = [], []
    for gray, depth, _, _, ts in frames:
        orc.process(gray, depth, ts)
        kf_cum.append(len(orc.keyframes))
        ba_cum.append(orc.ba_rounds)
    _, _, t = orc.frontend_trajectory()
    if orc.fm_errors:
        print(f"  oracle: the F estimate raised in OpenCV on "
              f"{orc.fm_errors} of {len(frames)} frames", flush=True)
    return t, np.asarray(kf_cum), np.asarray(ba_cum)


def _cached(path: str, compute, names):
    """Load ``names`` from the npz at ``path``, or compute them, save them
    there and return them; the flag says whether the cache served."""
    if os.path.exists(path):
        d = np.load(path)
        return tuple(d[k] for k in names), True
    vals = compute()
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez_compressed(tmp, **dict(zip(names, vals)))
    os.replace(tmp, path)
    return tuple(vals), False


def _under(path: Path, root: Path) -> bool:
    return path == root or root in path.parents


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="torch_parity_sweep")
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--out", default="parity_sweep_torch")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--frames-list", type=int, nargs="*", default=None,
                    help="restrict the frame-count axis (resume/fill runs)")
    ap.add_argument("--res-list", nargs="*", default=None,
                    help="restrict resolutions, e.g. 640x480")
    ap.add_argument("--sync-every", type=int, default=8,
                    help="result-drain cadence (drain timing only: "
                         "trajectories are identical for any value)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    out = Path(args.out).resolve()
    if _under(out, REFERENCE_OUT):
        raise ValueError(f"--out {args.out}: the reference's parity_sweep/ "
                         "is not written by the port")
    dev = resolve_device(args.device)
    device_name, power_limit = card(dev)
    platform = "gpu" if dev.type == "cuda" else dev.type

    frame_counts = [120, 240] if args.quick else [120, 240, 480]
    resolutions = [(424, 240)] if args.quick else [(424, 240), (640, 480)]
    if args.frames_list:
        frame_counts = args.frames_list
    if args.res_list:
        resolutions = [tuple(int(v) for v in r.split("x"))
                       for r in args.res_list]
    seeds = list(range(2 if args.quick else args.seeds))
    n_max = max(frame_counts)

    cache_dir = out / "oracle_cache"
    runs_dir = out / "runs"
    cache_dir.mkdir(parents=True, exist_ok=True)
    runs_dir.mkdir(parents=True, exist_ok=True)
    tag = dict(device=device_name, power_limit=power_limit)

    all_cells = []
    t_start = time.time()

    def log(msg):
        print(f"[{time.time() - t_start:7.1f}s] {msg}", flush=True)

    for w, h in resolutions:
        base = SLAMConfig()
        cam = base.camera.scaled(w, h)
        cfg0 = base.replace(camera=cam)
        fp = cfg_fingerprint(cfg0)
        per_seed = {}
        for seed in seeds:
            frames = None

            def sequence():
                nonlocal frames
                if frames is None:
                    frames = list(synthetic.generate_sequence(
                        cam, n_max, seed=seed, depth_noise=DEPTH_NOISE))
                return frames

            # generate_sequence's own poses, without rendering a frame
            gt_t = np.stack([t for _, t in synthetic.orbit_trajectory(
                n_max, seed=seed + 1)])
            (orc_t, orc_kf, orc_ba), hit = _cached(
                str(cache_dir
                    / f"oracle_{w}x{h}_seed{seed}_f{n_max}_{fp}.npz"),
                lambda: run_oracle_full(cfg0, sequence()),
                ("t", "kf_cum", "ba_cum"))
            log(f"{w}x{h} seed={seed} oracle done "
                f"({'cache' if hit else 'fresh'})")
            tpu = {}
            for mode in MODES:
                cfg = mode_config(cfg0, mode)
                tpu[mode], hit = _cached(
                    str(runs_dir / f"run_{w}x{h}_seed{seed}_{mode}_f{n_max}_"
                        f"{cfg_fingerprint(cfg)}.npz"),
                    lambda: run_pipeline_full(cfg, sequence(),
                                              args.sync_every, dev),
                    ("t", "kf_cum"))
                log(f"{w}x{h} seed={seed} port {mode} done "
                    f"({'cache' if hit else 'fresh'})")
            per_seed[seed] = (gt_t, orc_t, orc_kf, orc_ba, tpu)

        for n_frames in frame_counts:
            for mode in MODES:
                runs = []
                for seed in seeds:
                    gt_t, orc_t, okf, oba, tpu = per_seed[seed]
                    runs.append(run_record(seed, n_frames, gt_t, orc_t, okf,
                                           oba, *tpu[mode]))
                cell = dict(
                    platform=platform, mode=mode, frames=n_frames,
                    resolution=f"{w}x{h}", seeds=len(seeds), runs=runs,
                    provenance=PROVENANCE.format(n=n_max),
                    **summarize(runs), **tag)
                all_cells.append(cell)
                path = out / f"cell_f{n_frames}_{w}x{h}_{mode}.json"
                with open(path, "w") as f:
                    json.dump(cell, f, indent=2)
                log(f"wrote {path} (ratio mean {cell['ate_ratio_mean']})")

    summary = dict(
        platform=platform,
        elapsed_s=round(time.time() - t_start, 1),
        cells=[{k: v for k, v in c.items() if k != "runs"}
               for c in all_cells],
        tpu_beats_oracle_mean_everywhere=all(
            c["tpu_ate_mean_m"] <= c["oracle_ate_mean_m"]
            for c in all_cells if c["mode"] == "anchored"),
        **tag)
    with open(out / "sweep.json", "w") as f:
        json.dump(dict(summary=summary, cells=all_cells), f, indent=2)
    print(json.dumps(summary, indent=2))
    return 0
