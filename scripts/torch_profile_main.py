"""Where the time of the PyTorch port's main path goes, on one GPU.

    python3 scripts/torch_profile_main.py

Drives SLAMSystem(SLAMConfig()).process_batch on the 720p fixture of
chip_smoke.py (its frames, batches of 24 and warm-up, imported from there so
both scripts drive the same batches), then measures the next PROFILE_BATCHES
batches twice:

  stages   each stage of process_batch (ORB extraction, tracker, drain +
           keyframe inserts, BA tick) timed on the host clock between
           torch.cuda.synchronize() calls, so a stage's time includes its
           device work;
  profile  the next PROFILE_BATCHES batches under torch.profiler with no
           added synchronisation: wall time, the summed device time of all
           kernels (busy share = device time / wall), kernel launches per
           batch and the kernels that take the most device time.

Prints one JSON line per phase.  Imports nothing of JAX or of the JAX
package.  Needs a card; fails without one.
"""

from __future__ import annotations

import collections
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import (WARMUP_BATCHES, emit, frames_720p,  # noqa: E402
                        phase_device, stage, warm_up)
from dynamic_visual_slam_tpu_torch.config import SLAMConfig  # noqa: E402
from dynamic_visual_slam_tpu_torch.frontend import orb, tracker  # noqa: E402
from dynamic_visual_slam_tpu_torch.pipeline import slam as slam_mod  # noqa: E402

PROFILE_BATCHES = 3


def wrap_stages(timer):
    """Route the four stages of process_batch through ``timer(name, fn)``."""
    patched = [(orb, "extract_batch", "extract"),
               (tracker, "track_batch", "track"),
               (slam_mod.SLAMSystem, "_drain_results", "drain_insert"),
               (slam_mod.SLAMSystem, "_ba_tick", "ba_tick")]
    saved = []
    for owner, attr, name in patched:
        fn = getattr(owner, attr)
        saved.append((owner, attr, fn))
        setattr(owner, attr, timer(name, fn))
    return saved


def restore(saved) -> None:
    for owner, attr, fn in saved:
        setattr(owner, attr, fn)


def main() -> None:
    phase_device()
    n = PROFILE_BATCHES
    frames = frames_720p()
    system = slam_mod.SLAMSystem(SLAMConfig(), enable_place_recognition=False,
                                 device="cuda")
    warm_up(system, frames)
    batches, _ = stage(frames, WARMUP_BATCHES, 2 * n)

    # --- stages: synchronised host timers around each stage --------------
    totals = collections.defaultdict(float)
    calls = collections.Counter()

    def timer(name, fn):
        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            totals[name] += (time.perf_counter() - t0) * 1e3
            calls[name] += 1
            return out
        return timed

    saved = wrap_stages(timer)
    ba_before = system.stats["ba_runs"]
    t0 = time.perf_counter()
    for gs, ds, ts in batches[:n]:
        system.process_batch(gs, ds, ts)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    restore(saved)
    emit("stages", batches=n, ms_per_batch=wall / n,
         ba_runs=system.stats["ba_runs"] - ba_before,
         stage_ms_per_batch={k: v / n for k, v in totals.items()},
         stage_calls=dict(calls))

    # --- profile: no added synchronisation -------------------------------
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    ba_before = system.stats["ba_runs"]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for gs, ds, ts in batches[n:]:
            system.process_batch(gs, ds, ts)
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
    emit("profile", batches=n, ms_per_batch=wall / n,
         ba_runs=system.stats["ba_runs"] - ba_before,
         device_ms_per_batch=device_us / 1e3 / n,
         device_busy_share=device_us / 1e3 / wall,
         kernel_launches_per_batch=launches / n,
         top_device_ops=[dict(name=nm[:80], calls_per_batch=c / n,
                              device_ms_per_batch=d / 1e3 / n)
                         for d, c, nm in kernels[:15]])
    print(prof.key_averages().table(sort_by="cpu_time_total",
                                    row_limit=25), file=sys.stderr)


if __name__ == "__main__":
    main()
