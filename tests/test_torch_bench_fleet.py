"""The port's fleet stage (``bench._fleet_bench``) against the reference's
``bench._fleet_bench`` (the root ``bench.py``), on the CPU at 160x120
(SLAMConfig's defaults, the camera of tests/test_torch_fleet.py, BA every
0.7 s of input time instead of 2 s), the bench's 6-frame cycle, 2 streams,
``step_batch`` calls of 24 scan steps, 1 timed call.  The reference runs
its ``SLAMFleet`` on ``make_mesh(min(2, devices))`` of the 8 virtual CPU
devices that tests/conftest.py sets up, the port on one CPU entry.

Tolerance: none.  ``fleet_streams``, ``fleet_frames`` and
``fleet_ba_runs`` are set by the input alone: the fleet's BA tick fires on
a call whose last stamp lies 0.7 s after the previous tick's (the warm-up
call sets the first, the explicit ``run_ba`` counts one, the timed call,
ending at frame 47, 0.8 s later, the second).
"""

import dataclasses

import numpy as np
import torch

import bench as ref_bench

from dynamic_visual_slam_tpu.config import CameraConfig, SLAMConfig
from dynamic_visual_slam_tpu_torch import bench
from dynamic_visual_slam_tpu_torch.config import SLAMConfig as PSLAMConfig

torch.set_num_threads(2)
CAM = CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                   cx=79.5, cy=59.5)
CFG = SLAMConfig().replace(camera=CAM, ba=dataclasses.replace(
    SLAMConfig().ba, period_s=0.7))
PCFG = PSLAMConfig.from_dict(CFG.to_dict())
STREAMS, T_PER, N_BATCHES = 2, 24, 1


def test_fleet_bench_counts_match_the_reference():
    np_frames = bench.native_frames(PCFG)
    got = bench._fleet_bench(PCFG, np_frames, STREAMS, T_PER, N_BATCHES,
                             "cpu")
    want = ref_bench._fleet_bench(CFG, np_frames, STREAMS, T_PER, N_BATCHES)
    print(f"fleet: port {got}, reference {want}")
    assert set(got) == set(want)
    for key in ("fleet_streams", "fleet_frames", "fleet_ba_runs"):
        assert got[key] == want[key], key
    assert got["fleet_frames"] == STREAMS * T_PER * N_BATCHES
    assert got["fleet_ba_runs"] == 2
    assert np.isfinite(got["fleet_aggregate_fps"])
    assert got["fleet_aggregate_fps"] > 0
