"""The port's bench (``dynamic_visual_slam_tpu_torch/bench.py``) against the
reference's own bench functions (the root ``bench.py``), on the CPU at
160x120 (SLAMConfig's defaults, the camera of tests/test_torch_fleet.py,
BA every 0.7 s of input time instead of 2 s), the bench's 6-frame cycle
(``bench.native_frames``), batches of 24, ``sync_every`` 3, 24 timed
frames: stage 1, after 48 warm-up frames instead of 144, against a
reference ``SLAMSystem`` driven as the reference's ``_run`` drives it, and
stage 3, ``_place_bench``, against the reference's ``_place_bench``.  The
fleet's stage is in tests/test_torch_bench_fleet.py (its reference compile
takes about a minute of its own).

Tolerances, and why:
- counts set by input time alone are equal: stage 1's
  ``ba_runs_in_timed_window`` (the BA tick fires on the last stamp of a
  batch 0.7 s after the one before, so once a batch of 0.8 s) and
  ``timed_frames``;
- stage 3 on the reference's own draws (the port's ``SLAMSystem`` gets
  ``torch_parity.JaxSampler``): ``place_keyframes`` within 1 of the
  reference's, tests/test_parallel.py's keyframe bound (a F-RANSAC
  inlier on the epipolar threshold can flip the keyframe decision of a
  frame, tests/test_torch_tracker.py); ``loop_checks`` equal (a loop check
  needs a BoW candidate ten keyframes back, which a one-keyframe
  difference does not create on this cycle);
- stage 1's keyframes within 1 of the reference's, for the same reason.
Measured: 8 keyframes in stage 1 and 11 in stage 3 on both sides, one BA
round in the timed window, no loop check (the cycle's 11 keyframes leave
no candidate ten keyframes back).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import bench as ref_bench
from torch_parity import JaxSampler

from dynamic_visual_slam_tpu.config import CameraConfig, SLAMConfig
from dynamic_visual_slam_tpu.pipeline.slam import SLAMSystem as JaxSLAM
from dynamic_visual_slam_tpu_torch import bench
from dynamic_visual_slam_tpu_torch.config import SLAMConfig as PSLAMConfig
from dynamic_visual_slam_tpu_torch.pipeline.slam import SLAMSystem

torch.set_num_threads(2)
CAM = CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                   cx=79.5, cy=59.5)
CFG = SLAMConfig().replace(camera=CAM, ba=dataclasses.replace(
    SLAMConfig().ba, period_s=0.7))
PCFG = PSLAMConfig.from_dict(CFG.to_dict())
BATCH, SYNC_EVERY, N_TIMED, WARMUP = 24, 3, 24, 48


@pytest.fixture(scope="module")
def np_frames():
    return bench.native_frames(PCFG)


def test_headline_counts_match_a_reference_system(np_frames, monkeypatch):
    """Stage 1: the port's ``_headline`` against the reference's
    SLAMSystem driven as the reference's ``_run`` drives it."""
    monkeypatch.setattr(bench, "WARMUP_FRAMES", WARMUP)
    _, fps, got = bench._headline(PCFG, np_frames, BATCH, SYNC_EVERY,
                                  N_TIMED, "cpu")
    ref = JaxSLAM(CFG, ba_async=True, enable_place_recognition=False,
                  sync_every=SYNC_EVERY)
    for i0 in range(0, bench.WARMUP_FRAMES, BATCH):
        ref.process_batch(*bench.batch_at(np_frames, i0, BATCH))
    ref.finalize()
    assert ref.stats["ba_runs"] >= 1
    before = ref.stats["ba_runs"]
    for i0 in range(bench.WARMUP_FRAMES, bench.WARMUP_FRAMES + N_TIMED,
                    BATCH):
        ref.process_batch(*bench.batch_at(np_frames, i0, BATCH))
    ref.finalize()
    print(f"stage 1: port {got}, reference ba_runs "
          f"{ref.stats['ba_runs'] - before}, keyframes "
          f"{ref.stats['keyframes']}")
    assert np.isfinite(fps) and fps > 0
    assert got["timed_frames"] == N_TIMED
    assert got["ba_runs_in_timed_window"] == ref.stats["ba_runs"] - before \
        == 1
    assert abs(got["keyframes"] - ref.stats["keyframes"]) <= 1


def test_place_bench_matches_the_reference(np_frames, monkeypatch):
    """Stage 3: the port's ``_place_bench`` on the reference's draws
    against the reference's ``_place_bench``."""
    n_frames = bench.PLACE_WARMUP_FRAMES + N_TIMED
    monkeypatch.setattr(bench, "SLAMSystem", functools.partial(
        SLAMSystem, sampler=JaxSampler(n_frames)))
    got = bench._place_bench(PCFG, np_frames, BATCH, SYNC_EVERY, N_TIMED,
                             "cpu")
    want = ref_bench._place_bench(CFG, np_frames, BATCH, SYNC_EVERY,
                                  n_timed=N_TIMED)
    print(f"stage 3: port {got}, reference {want}")
    assert set(got) == set(want)
    assert got["full_pipeline_fps_with_place"] > 0
    assert abs(got["place_keyframes"] - want["place_keyframes"]) <= 1
    assert got["loop_checks"] == want["loop_checks"]
