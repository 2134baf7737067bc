"""PyTorch port vs the JAX reference: the whole slice,
``SLAMSystem.process_batch`` (ORB → tracker → keyframe inserts → periodic BA
with tracker feedback), on the pipeline fixture of tests/test_pipeline.py
(320x240, 70 frames, seed 11), in batches of 7, place recognition off.

Both systems see the same frames and the same RANSAC draws (the port gets
the reference's own threefry samples through ``sampler=``).

Bounds and tolerances:
- the port alone meets test_pipeline.py's own bounds: ATE below
  max(0.05 m, 6 % of the path), at least one BA round, every BA round
  lowering its cost, a keyframe trajectory within 0.06 m;
- against the reference: keyframe flags, tracking flags and BA round count
  equal; per-frame positions within 5 mm RMS and 25 mm at worst; BA costs
  and residual counts within 2 %; active landmark counts within 2 %.  The
  slack is for F-RANSAC inliers whose epipolar error sits on the threshold
  and falls on the other side in float32 evaluated in another order
  (tests/test_torch_tracker.py counts those frames); the changed support
  moves that frame's pose by millimetres and the keyframes built on it
  carry the difference forward."""

import numpy as np
import pytest
import torch

from torch_parity import JaxSampler

from dynamic_visual_slam_tpu.config import CameraConfig, SLAMConfig
from dynamic_visual_slam_tpu.io import synthetic, trajectory
from dynamic_visual_slam_tpu.pipeline.slam import SLAMSystem as JaxSLAM
from dynamic_visual_slam_tpu_torch.config import SLAMConfig as PSLAMConfig
from dynamic_visual_slam_tpu_torch.pipeline.slam import SLAMSystem

torch.set_num_threads(2)
CAM = CameraConfig(width=320, height=240, fx=260.0, fy=260.0,
                   cx=159.5, cy=119.5)
CFG = SLAMConfig().replace(camera=CAM)
PCFG = PSLAMConfig.from_dict(CFG.to_dict())
N_FRAMES = 70
B = 7


@pytest.fixture(scope="module")
def runs():
    seq = list(synthetic.generate_sequence(CAM, N_FRAMES, seed=11,
                                           depth_noise=0.004))
    grays = np.stack([f[0] for f in seq]).astype(np.uint8)
    depths = (np.stack([f[1] for f in seq]) * 1000.0).astype(np.uint16)
    stamps = np.asarray([f[4] for f in seq])
    gt = np.stack([f[3] for f in seq])
    ref = JaxSLAM(CFG, ba_async=False, enable_place_recognition=False)
    port = SLAMSystem(PCFG, ba_async=False, device="cpu",
                      sampler=JaxSampler(N_FRAMES))
    returned = []
    for i in range(0, N_FRAMES, B):
        sl = slice(i, i + B)
        ref.process_batch(grays[sl], depths[sl], stamps[sl])
        returned.append(len(port.process_batch(grays[sl], depths[sl],
                                               stamps[sl])))
    ref.finalize()
    port.finalize()
    return ref, port, gt, returned


def test_port_meets_pipeline_bounds(runs):
    _, port, gt, returned = runs
    assert returned == [B] * (N_FRAMES // B)   # this batch's results
    assert port.stats["frames"] == N_FRAMES
    assert 2 <= port.stats["keyframes"] < N_FRAMES
    assert port.stats["ba_runs"] >= 1
    assert all(e["final_cost"] < e["initial_cost"] for e in port.ba_log)
    _, _, est = port.frontend_trajectory()
    assert np.isfinite(est).all()
    ate = trajectory.ate_rmse(est, gt)
    dist = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
    assert ate < max(0.05, 0.06 * dist), (ate, dist)
    lms = port.landmarks_world()
    assert len(lms["xyz"]) > 200
    assert (lms["n_obs"] >= 2).sum() > 50


def test_port_keyframe_trajectory(runs):
    _, port, gt, _ = runs
    stamps, rs, kf_t = port.keyframe_trajectory()
    assert len(stamps) == min(port.stats["keyframes"], PCFG.map.max_keyframes)
    assert rs.shape == (len(stamps), 3, 3)
    gt_stamps = np.arange(len(gt)) / 30.0
    gt_at_kf = np.stack([gt[np.argmin(np.abs(gt_stamps - s))]
                         for s in stamps])
    assert trajectory.ate_rmse(kf_t, gt_at_kf) < 0.06


def test_trajectory_matches_reference(runs):
    ref, port, _, _ = runs
    for name in ("is_keyframe", "tracking_ok"):
        assert [getattr(f, name) for f in port.trajectory] == \
            [getattr(f, name) for f in ref.trajectory], name
    _, _, pt = port.frontend_trajectory()
    _, _, jt = ref.frontend_trajectory()
    d = np.linalg.norm(pt - jt, axis=1)
    print(f"position difference to the reference: RMS "
          f"{np.sqrt(np.mean(d ** 2)):.5f} m, max {d.max():.5f} m "
          f"(frame {int(d.argmax())})")
    assert np.sqrt(np.mean(d ** 2)) < 5e-3
    assert d.max() < 2.5e-2


def test_ba_and_map_match_reference(runs):
    ref, port, _, _ = runs
    assert port.stats["ba_runs"] == ref.stats["ba_runs"]
    assert len(port.ba_log) == len(ref.ba_log)
    for p, j in zip(port.ba_log, ref.ba_log):
        print(f"BA at {p['timestamp']:.2f} s: port {p['initial_cost']:.1f} → "
              f"{p['final_cost']:.1f} ({p['n_residuals']} residuals), "
              f"reference {j['initial_cost']:.1f} → {j['final_cost']:.1f} "
              f"({j['n_residuals']})")
        assert p["timestamp"] == pytest.approx(float(j["timestamp"]))
        for key in ("initial_cost", "final_cost", "n_residuals"):
            assert p[key] == pytest.approx(j[key], rel=0.02), key
    n_port = len(port.landmarks_world()["xyz"])
    n_ref = len(ref.landmarks_world()["xyz"])
    assert n_port == pytest.approx(n_ref, rel=0.02), (n_port, n_ref)
