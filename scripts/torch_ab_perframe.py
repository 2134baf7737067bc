"""The per-frame path of one source tree on the card: ``SLAMSystem.process``
on ``chip_smoke.py``'s 720p fixture (the 6-frame cycle of
``generate_sequence(cam, 6, seed=3)``, place recognition off), host
milliseconds a frame (each frame ended by ``torch.cuda.synchronize()``)
after a warm-up, and the kernel launches of one frame under
``torch.profiler``.  ROOT is the tree to import (``.`` for this checkout,
or a parent commit unpacked under ``build/``), so two commits are compared
in one call, in turns:

    python3 scripts/torch_ab_perframe.py ROOT [TIMED_FRAMES]

Prints one JSON line.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time


def main() -> None:
    root = os.path.abspath(sys.argv[1])
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 48
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    from dynamic_visual_slam_tpu_torch.config import SLAMConfig
    from dynamic_visual_slam_tpu_torch.pipeline.slam import SLAMSystem

    frames = chip_smoke.frames_720p()
    slam = SLAMSystem(SLAMConfig(), enable_place_recognition=False,
                      device="cuda")
    ms = []
    for i in range(12 + n):
        g, d, _ = frames[i % len(frames)]
        t0 = time.perf_counter()
        slam.process(g, d, i / 30.0)
        torch.cuda.synchronize()
        if i >= 12:
            ms.append((time.perf_counter() - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    g, d, _ = frames[0]
    with torch.profiler.profile(activities=acts) as prof:
        slam.process(g, d, (12 + n) / 30.0)
        torch.cuda.synchronize()
    launches = sum(ev.count for ev in prof.key_averages()
                   if ev.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                 "cuLaunchKernel", "cuLaunchKernelEx"))
    print(json.dumps(dict(root=sys.argv[1], frames=n,
                          ms_per_frame_median=statistics.median(ms),
                          ms_per_frame_mean=statistics.mean(ms),
                          launches_one_frame=launches,
                          card=torch.cuda.get_device_name(0))), flush=True)


if __name__ == "__main__":
    main()
