"""Where a fleet split over a mesh parts from the one-device fleet on the
card, and what a thread a shard costs, on ``chip_smoke.py``'s 720p fleet
fixture (8 streams, each offset by its index in the 6-frame cycle):

- the pyramid, the blur (unrounded and rounded) and the extraction of the
  first scan step's frames at B = 4 against the first 4 of B = 8: pixels
  and descriptor bits that differ (cuBLAS may pick another kernel when the
  batch, hence a matmul's shape, changes);
- the position gap (m) and the F-RANSAC inlier difference of every stream
  and scan step over 6 scan steps, the fleet on ``["cuda:0", "cuda:0"]``
  against the one-device fleet, both on ``chip_smoke.keyed_draws``;
- host seconds of one ``step_batch`` call of 24 scan steps (synchronised,
  after a 4-step warm-up call) on that two-shard mesh with a thread a
  shard and with the shards run in turn on the calling thread, in turns,
  and on one device.

    python3 scripts/torch_mesh_split.py

Needs a card; prints one JSON line per part.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from dynamic_visual_slam_tpu_torch.frontend import orb
    from dynamic_visual_slam_tpu_torch.ops import image as imops
    from dynamic_visual_slam_tpu_torch.parallel import mesh

    if not torch.cuda.is_available():
        sys.exit("torch_mesh_split.py: needs a CUDA device")
    name, _ = cs.phase_device()
    cs.phase_build()
    cfg = cs.SLAMConfig()
    o = cfg.orb
    gs, ds, ts = cs.fleet_batch(cs.frames_720p(), 0, 8)
    g = gs[0].to(torch.float32)
    lv8 = imops.build_pyramid(g, o.n_levels, o.scale_factor)
    lv4 = imops.build_pyramid(g[:4].contiguous(), o.n_levels, o.scale_factor)
    b8 = [imops.gaussian_blur(a, 7, 2.0)[:4] for a in lv8]
    b4 = [imops.gaussian_blur(a, 7, 2.0) for a in lv4]
    k8 = orb.extract_batch(g, o)
    k4 = orb.extract_batch(g[:4].contiguous(), o)
    print(json.dumps(dict(
        part="batch", device=name,
        pyramid_px_differ=[int((a[:4] != b).sum()) for a, b in zip(lv8, lv4)],
        blur_px_differ=[int((a != b).sum()) for a, b in zip(b8, b4)],
        blur_rounded_px_differ=[int((torch.round(a) != torch.round(b)).sum())
                                for a, b in zip(b8, b4)],
        desc_bits_differ=int((k8.desc_bits[:4] != k4.desc_bits).sum()),
        uv_differ=int((k8.uv[:4] != k4.uv).sum()))), flush=True)

    draws, _ = cs.keyed_draws("cuda")
    two = mesh.make_mesh(devices=["cuda:0"] * 2)
    res = {}
    for label, kw in (("one", dict(device="cuda")), ("mesh", dict(mesh=two))):
        f = mesh.SLAMFleet(cfg, 8, sampler=draws, **kw)
        res[label] = f.step_batch(gs[:6], ds[:6], ts[:6],
                                  auto_ba=False).cpu().numpy()
    err = np.linalg.norm(res["mesh"][..., 4:7] - res["one"][..., 4:7], axis=-1)
    print(json.dumps(dict(
        part="split", device=name, err_m_by_step_stream=err.tolist(),
        inlier_diff=(res["mesh"][..., 9] - res["one"][..., 9]).tolist())),
        flush=True)

    def in_turn(devices, calls):
        out = []
        for dev, call in zip(devices, calls):
            with torch.cuda.device(dev):
                out.append(call())
        return out

    threaded = mesh._parallel
    times = {}
    for mode in ("threads", "in_turn", "threads", "in_turn", "one_device"):
        mesh._parallel = in_turn if mode == "in_turn" else threaded
        f = mesh.SLAMFleet(cfg, 8, **(dict(device="cuda")
                                      if mode == "one_device"
                                      else dict(mesh=two)))
        f.step_batch(gs[:4], ds[:4], ts[:4], auto_ba=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f.step_batch(gs, ds, ts, auto_ba=False)
        torch.cuda.synchronize()
        times.setdefault(mode, []).append(time.perf_counter() - t0)
    mesh._parallel = threaded
    print(json.dumps(dict(part="threads", device=name,
                          step_batch_s=times)), flush=True)


if __name__ == "__main__":
    main()
