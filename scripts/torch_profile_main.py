"""Where the time of the PyTorch port's main paths goes, on one GPU.

    python3 scripts/torch_profile_main.py [--per-frame]

Default: drives SLAMSystem(SLAMConfig()).process_batch on the 720p fixture
of chip_smoke.py (its frames, batches of 24 and warm-up, imported from there
so both scripts drive the same batches), then measures the next
PROFILE_BATCHES batches twice.

--per-frame: drives SLAMSystem(SLAMConfig(), vocab_path=...).process, every
default on, on chip_smoke.py's 720p revisit fixture (phase place_frames:
two orbits of ORBIT_FRAMES frames, loops verified and applied in the
second); the stage timers run over all frames but the last
PROFILE_FRAMES, the profile over those.

  stages   each stage (ORB extraction, tracker, the telemetry read, keyframe
           inserts, emission with the place chain, BA tick; per frame also
           the BoW add + query, loop verification and loop harvest with its
           correction) timed on the host clock between
           torch.cuda.synchronize() calls, so a stage's time includes its
           device work; a stage that runs inside another is counted only in
           its own line (self time);
  profile  the next units under torch.profiler with no added
           synchronisation: wall time, the summed device time of all
           kernels (busy share = device time / wall), kernel launches per
           unit (batch or frame) and the kernels that take the most device
           time.

Prints one JSON line per phase.  Imports nothing of JAX or of the JAX
package.  Needs a card; fails without one.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import (ORBIT_FRAMES, VOCAB, WARMUP_BATCHES,  # noqa: E402
                        emit, frames_720p, phase_device, revisit_frames,
                        stage, warm_up)
from dynamic_visual_slam_tpu_torch.config import SLAMConfig  # noqa: E402
from dynamic_visual_slam_tpu_torch.frontend import orb, tracker  # noqa: E402
from dynamic_visual_slam_tpu_torch.pipeline import slam as slam_mod  # noqa: E402

PROFILE_BATCHES = 3
PROFILE_FRAMES = 48
SYSTEM = slam_mod.SLAMSystem
BATCH_STAGES = [(orb, "extract_batch", "extract"),
                (tracker, "track_batch", "track"),
                (SYSTEM, "_read", "read"),
                (SYSTEM, "_insert_keyframe", "insert"),
                (SYSTEM, "_drain_results", "emit"),
                (SYSTEM, "_ba_tick", "ba_tick")]
FRAME_STAGES = [(tracker, "extract", "extract"),
                (tracker, "track_step", "track"),
                (SYSTEM, "_read", "read"),
                (SYSTEM, "_insert_keyframe", "insert"),
                (SYSTEM, "_drain_results", "emit"),
                (SYSTEM, "_place_recognition", "bow_add_query"),
                (SYSTEM, "_dispatch_verify", "verify"),
                (SYSTEM, "_harvest_loops", "harvest_loops"),
                (SYSTEM, "_ba_tick", "ba_tick")]


def timed_stages(patched, drive):
    """Run drive() with every (owner, attr) of ``patched`` wrapped in a
    synchronised host timer.  → (wall ms, self ms per stage, calls)."""
    totals = collections.defaultdict(float)
    calls = collections.Counter()
    nested = []

    def timer(name, fn):
        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nested.append(0.0)
            try:
                out = fn(*args, **kw)
                torch.cuda.synchronize()
            finally:
                inner = nested.pop()
            dt = (time.perf_counter() - t0) * 1e3
            totals[name] += dt - inner
            if nested:
                nested[-1] += dt
            calls[name] += 1
            return out
        return timed

    saved = []
    for owner, attr, name in patched:
        fn = getattr(owner, attr)
        saved.append((owner, attr, fn))
        setattr(owner, attr, timer(name, fn))
    try:
        t0 = time.perf_counter()
        drive()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    return wall, totals, calls


def profiled(drive, n: int, unit: str) -> None:
    """Run drive() (n units) under torch.profiler and emit the profile."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        drive()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device_us, launches, kernels = 0.0, 0, []
    for ev in prof.key_averages():
        if ev.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cuLaunchKernelEx"):
            launches += ev.count
        # device-side events only (kernels, copies, sets): a CPU op's own
        # device total repeats its kernels' time
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev = getattr(ev, "self_device_time_total", None)
        if dev is None:
            dev = ev.self_cuda_time_total
        device_us += dev
        kernels.append((dev, ev.count, ev.key))
    kernels.sort(reverse=True)
    u = unit
    emit("profile", unit=u, units=n, **{
        f"ms_per_{u}": wall / n,
        f"device_ms_per_{u}": device_us / 1e3 / n,
        "device_busy_share": device_us / 1e3 / wall,
        f"kernel_launches_per_{u}": launches / n,
        "top_device_ops": [{"name": nm[:80], f"calls_per_{u}": c / n,
                            f"device_ms_per_{u}": d / 1e3 / n}
                           for d, c, nm in kernels[:15]]})
    print(prof.key_averages().table(sort_by="cpu_time_total",
                                    row_limit=25), file=sys.stderr)


def batched() -> None:
    n = PROFILE_BATCHES
    frames = frames_720p()
    system = SYSTEM(SLAMConfig(), enable_place_recognition=False,
                    device="cuda")
    warm_up(system, frames)
    batches, _ = stage(frames, WARMUP_BATCHES, 2 * n)

    def drive(part):
        return lambda: [system.process_batch(gs, ds, ts)
                        for gs, ds, ts in part]

    ba_before = system.stats["ba_runs"]
    wall, totals, calls = timed_stages(BATCH_STAGES, drive(batches[:n]))
    emit("stages", batches=n, ms_per_batch=wall / n,
         ba_runs=system.stats["ba_runs"] - ba_before,
         stage_ms_per_batch={k: v / n for k, v in totals.items()},
         stage_calls=dict(calls))
    profiled(drive(batches[n:]), n, "batch")


def per_frame() -> None:
    cfg = SLAMConfig()
    cfg = cfg.replace(depth=dataclasses.replace(cfg.depth, max_depth=6.0))
    frames = revisit_frames(cfg.camera, ORBIT_FRAMES)
    system = SYSTEM(cfg, vocab_path=VOCAB, device="cuda")
    system.warmup_place()
    n_timed = len(frames) - PROFILE_FRAMES

    def drive(first, last):
        def run():
            for i in range(first, last):
                g, d, _ = frames[i]
                system.process(g, d, i / 30.0)
        return run

    wall, totals, calls = timed_stages(FRAME_STAGES, drive(0, n_timed))
    emit("stages", frames=n_timed, ms_per_frame=wall / n_timed,
         stats=dict(system.stats),
         stage_ms_per_frame={k: v / n_timed for k, v in totals.items()},
         stage_calls=dict(calls))
    profiled(drive(n_timed, len(frames)), PROFILE_FRAMES, "frame")
    system.finalize()
    emit("per_frame_run", stats=system.stats)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--per-frame", action="store_true",
                    help="profile process() on the 720p revisit fixture")
    args = ap.parse_args()
    phase_device()
    if args.per_frame:
        per_frame()
    else:
        batched()


if __name__ == "__main__":
    main()
