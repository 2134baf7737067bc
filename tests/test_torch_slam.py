"""PyTorch port vs the JAX reference: the whole slice,
``SLAMSystem.process_batch`` (ORB → tracker → keyframe inserts → periodic BA
with tracker feedback), on the pipeline fixture of tests/test_pipeline.py
(320x240, 70 frames, seed 11), in batches of 7, place recognition off;
its return cadence (``sync_every`` 1, 2 and 3) against the reference's;
and both systems on the root ``bench.py``'s six-frame cycle (below).

Both systems see the same frames and the same RANSAC draws (the port gets
the reference's own threefry samples through ``sampler=``).

Bounds and tolerances:
- the port alone meets test_pipeline.py's own bounds: ATE below
  max(0.05 m, 6 % of the path), at least one BA round, every BA round
  lowering its cost, a keyframe trajectory within 0.06 m;
- against the reference: keyframe flags, tracking flags and BA round count
  equal; per-frame positions within 8 mm RMS and 48 mm at worst; BA costs
  and residual counts within 2 %; active landmark counts within 2 %.  The
  slack is for F-RANSAC inliers whose epipolar error sits on the threshold
  and falls on the other side in float32 evaluated in another order
  (tests/test_torch_tracker.py counts those frames); the changed support
  moves that frame's pose by millimetres and the keyframes built on it
  carry the difference forward.

Position bounds, measured: on an AVX-512 host the slice gives 5.26 mm RMS
and 31.66 mm at worst (frame 17), the same under MKL_CBWR AVX2, AVX512 and
COMPATIBLE and ATEN_CPU_CAPABILITY default and avx2, with the port's
8-point Gram and Gauss-Newton normal equations summed in float64
(frontend/ransac.py).  The differences are single frames: frame 13's
F-RANSAC keeps 604 inliers where the reference keeps 613 from the same
draws, its PnP support differs by one (324 against 325) and its pose by
24 mm.  Frame 17, tracked from the reference's state, lands 0.7 mm from
it; from the port's own state after frame 13 it lands 31.7 mm apart.  The
port's summation moves these figures: with every sum in float32, as in the
reference, the slice gave 6.24 mm RMS on that host and 2.2 mm RMS on
another x86 host; the threshold cases that flip are other ones.
The bounds are those worst values times 1.5: 8 mm RMS, 48 mm at worst.

The cycle runs: the root ``bench.py``'s 6-frame sequence (seed 3) at
160x120 in the camera's native formats (uint8 gray, uint16 millimetre
depth), played round in batches of 24 with ``sync_every`` 3 and BA every
0.7 s of input time instead of 2 s (a round ends every batch of 0.8 s): 48
frames, ``finalize``, 24 more, ``finalize``; with place recognition off
(the port's own draws) and on (the shipped vocabulary, the reference's
draws through ``sampler=``).  Tolerances, and why:
- every frame is emitted, on the reference's cadence, and BA rounds are
  equal: both are set by input time alone;
- keyframes within 1, tests/test_parallel.py's keyframe bound: an
  F-RANSAC inlier on the epipolar threshold can flip the keyframe
  decision of a frame (tests/test_torch_tracker.py);
- loop checks (candidates and relocalization records) equal: a check
  needs a BoW candidate ten keyframes back, which a one-keyframe
  difference does not create on this cycle.
The port's run with place recognition off is also held bit-equal to the
same batches handed over as tensors."""

import dataclasses
import functools
from pathlib import Path

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
VOCAB = str(Path(__file__).resolve().parent.parent / "assets"
            / "orbvoc_synth.npz")
CYCLE_CAM = CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                         cx=79.5, cy=59.5)
CYCLE_CFG = SLAMConfig().replace(camera=CYCLE_CAM, ba=dataclasses.replace(
    SLAMConfig().ba, period_s=0.7))
CYCLE_PCFG = PSLAMConfig.from_dict(CYCLE_CFG.to_dict())
CYCLE_BATCH, CYCLE_SYNC, CYCLE_PARTS = 24, 3, (48, 24)


@pytest.fixture(scope="module")
def runs():
    seq = list(synthetic.generate_sequence(CAM, N_FRAMES, seed=11,
                                           depth_noise=0.004))
    grays = np.stack([f[0] for f in seq]).astype(np.uint8)
    depths = (np.stack([f[1] for f in seq]) * 1000.0).astype(np.uint16)
    stamps = np.asarray([f[4] for f in seq])
    gt = np.stack([f[3] for f in seq])
    ref = JaxSLAM(CFG, ba_async=False, enable_place_recognition=False)
    port = SLAMSystem(PCFG, ba_async=False, enable_place_recognition=False,
                      device="cpu", sampler=JaxSampler(N_FRAMES))
    returned = []
    for i in range(0, N_FRAMES, B):
        sl = slice(i, i + B)
        returned.append((
            len(port.process_batch(grays[sl], depths[sl], stamps[sl])),
            len(ref.process_batch(grays[sl], depths[sl], stamps[sl]))))
    ref.finalize()
    port.finalize()
    return ref, port, gt, returned


def test_port_meets_pipeline_bounds(runs):
    _, port, gt, returned = runs
    # the reference's cadence: each call returns the previous batch
    assert [p for p, _ in returned] == [j for _, j in returned] \
        == [0] + [B] * (N_FRAMES // B - 1)
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
    assert np.sqrt(np.mean(d ** 2)) < 8e-3
    assert d.max() < 4.8e-2


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


@pytest.mark.parametrize("sync_every", [1, 2, 3])
def test_return_cadence_matches_reference(sync_every):
    """Which frames each process_batch call returns, and after finalize()
    the whole trajectory in order, as the reference's on its cadence."""
    seq = list(synthetic.generate_sequence(CAM, 5 * B, seed=11,
                                           depth_noise=0.004))
    grays = np.stack([f[0] for f in seq]).astype(np.uint8)
    depths = (np.stack([f[1] for f in seq]) * 1000.0).astype(np.uint16)
    stamps = np.asarray([f[4] for f in seq])
    kw = dict(ba_async=False, enable_place_recognition=False,
              sync_every=sync_every)
    ref = JaxSLAM(CFG, **kw)
    port = SLAMSystem(PCFG, device="cpu", **kw)
    got, want = [], []
    for i in range(0, len(seq), B):
        sl = slice(i, i + B)
        got.append([f.timestamp for f in port.process_batch(
            grays[sl], depths[sl], stamps[sl])])
        want.append([f.timestamp for f in ref.process_batch(
            grays[sl], depths[sl], stamps[sl])])
    assert got == want
    assert [len(g) for g in got] == {1: [0, 7, 7, 7, 7],
                                     2: [0, 0, 14, 0, 14],
                                     3: [0, 0, 0, 21, 0]}[sync_every]
    port.finalize()
    ref.finalize()
    assert [f.timestamp for f in port.trajectory] == \
        [f.timestamp for f in ref.trajectory] == list(stamps)


def cycle_batches():
    """The cycle's batches of CYCLE_BATCH frames, for both parts: (uint8
    grays, uint16 depths, 30 fps stamps)."""
    cycle = [(g.astype(np.uint8), (d * 1000.0).astype(np.uint16))
             for g, d, _, _, _ in synthetic.generate_sequence(CYCLE_CAM, 6,
                                                              seed=3)]
    for i0 in range(0, sum(CYCLE_PARTS), CYCLE_BATCH):
        idx = [(i0 + j) % len(cycle) for j in range(CYCLE_BATCH)]
        yield (np.stack([cycle[i][0] for i in idx]),
               np.stack([cycle[i][1] for i in idx]),
               (i0 + np.arange(CYCLE_BATCH)) / 30.0)


@functools.lru_cache(maxsize=None)
def cycle_run(place: bool):
    """Both systems through the cycle's two parts; per system, the frames
    each call returned and the BA rounds after each part."""
    kw = dict(enable_place_recognition=place, sync_every=CYCLE_SYNC)
    if place:
        kw["vocab_path"] = VOCAB
    ref = JaxSLAM(CYCLE_CFG, **kw)
    port = SLAMSystem(CYCLE_PCFG, device="cpu", **kw, **(
        dict(sampler=JaxSampler(sum(CYCLE_PARTS))) if place else {}))
    out = {}
    for name, slam in (("reference", ref), ("port", port)):
        batches = cycle_batches()
        returned, ba_runs = [], []
        for n in CYCLE_PARTS:
            for _ in range(n // CYCLE_BATCH):
                returned.append(len(slam.process_batch(*next(batches))))
            slam.finalize()
            ba_runs.append(slam.stats["ba_runs"])
        out[name] = dict(slam=slam, returned=returned, ba_runs=ba_runs)
    print(f"cycle, place recognition {place}: " + ", ".join(
        f"{k} keyframes {v['slam'].stats['keyframes']} BA {v['ba_runs']}"
        for k, v in out.items()))
    return out


@pytest.fixture(params=[False, True], ids=["place_off", "place_on"])
def cycle_runs(request):
    return cycle_run(request.param)


def test_cycle_emits_every_frame_on_the_references_cadence(cycle_runs):
    want = list(np.concatenate([b[2] for b in cycle_batches()]))
    for r in cycle_runs.values():
        assert [f.timestamp for f in r["slam"].trajectory] == want
    port, ref = cycle_runs["port"], cycle_runs["reference"]
    assert port["returned"] == ref["returned"]
    checks = [len(r["slam"].loop_candidates) + len(r["slam"].reloc_log)
              for r in (port, ref)]
    assert checks[0] == checks[1], checks


def test_cycle_ba_rounds_equal(cycle_runs):
    port, ref = cycle_runs["port"]["ba_runs"], \
        cycle_runs["reference"]["ba_runs"]
    # a round in the first 48 frames, one more in the next 24
    assert port == ref and 1 <= port[0] < port[1], (port, ref)


def test_cycle_keyframes_within_one(cycle_runs):
    kf = [r["slam"].stats["keyframes"] for r in cycle_runs.values()]
    assert min(kf) >= 2 and abs(kf[0] - kf[1]) <= 1, kf


def test_process_batch_takes_tensors_as_it_takes_arrays():
    """The cycle's batches handed over as CPU tensors give the poses and
    flags, bit for bit, of the same batches as numpy arrays (place
    recognition off, the port's own draws)."""
    slam = SLAMSystem(CYCLE_PCFG, device="cpu", enable_place_recognition=False,
                      sync_every=CYCLE_SYNC)
    batches = cycle_batches()
    for n in CYCLE_PARTS:
        for _ in range(n // CYCLE_BATCH):
            gs, ds, tss = next(batches)
            slam.process_batch(torch.from_numpy(gs), torch.from_numpy(ds), tss)
        slam.finalize()
    want = cycle_run(False)["port"]["slam"]
    np.testing.assert_array_equal(slam.frontend_trajectory()[2],
                                  want.frontend_trajectory()[2])
    assert [(f.is_keyframe, f.tracking_ok) for f in slam.trajectory] == \
        [(f.is_keyframe, f.tracking_ok) for f in want.trajectory]
    assert len(slam.trajectory) == sum(CYCLE_PARTS)
