"""PyTorch port vs the JAX reference: the fleet's throughput mode,
``parallel/mesh.SLAMFleet.step_batch``, on the CPU, with
tests/test_torch_fleet.py's fixture (160x120, 2 streams, every tracked
frame a keyframe; the reference fleet's own draws).

Tolerances, and why:
- ``step_batch`` against T ``step`` calls of the port: translations within
  1e-6 m, keyframe flags equal, nothing dropped with ``kf_slots = T``; the
  reference's own test of its fleet holds the same (tests/test_parallel.py).
- the K-slot insert with ``kf_slots = 3`` over 8 frames: telemetry flags,
  per-stream dropped counts, keyframe counts and active landmarks equal to
  the reference's ``step_batch`` (drop-newest: each stream keeps its first
  3 flagged frames).
- both fleets on the root ``bench.py``'s fleet input at 160x120 (its
  6-frame cycle, stream s offset by s frames, BA every 0.7 s of input
  time instead of 2 s), 2 streams, a ``step_batch`` call of 24 scan steps,
  ``run_ba``, then one more call, the port on the reference fleet's draws:
  frames and BA rounds equal (set by the input alone); per stream
  keyframes within 1 and active landmarks within max(20, 10 %), the bounds
  of tests/test_parallel.py (an F-RANSAC inlier on the epipolar threshold
  can flip a frame's keyframe decision, tests/test_torch_tracker.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fleet import CFG, N, PCFG, frames  # noqa: F401
from torch_parity import JaxFleetSampler

from dynamic_visual_slam_tpu.config import CameraConfig, SLAMConfig
from dynamic_visual_slam_tpu.io import synthetic
from dynamic_visual_slam_tpu.parallel import mesh as jmesh
from dynamic_visual_slam_tpu_torch.config import SLAMConfig as PSLAMConfig
from dynamic_visual_slam_tpu_torch.parallel.mesh import SLAMFleet

torch.set_num_threads(2)
T_SLOTS, K_SLOTS = 8, 3
CYCLE_CFG = SLAMConfig().replace(
    camera=CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                        cx=79.5, cy=59.5),
    ba=dataclasses.replace(SLAMConfig().ba, period_s=0.7))
CYCLE_STREAMS, CYCLE_T = 2, 24


def test_step_batch_matches_step(frames):
    """The throughput mode runs the per-frame program: T step() calls and
    one step_batch give the same poses and flags."""
    grays, depths, stamps = frames
    f1 = SLAMFleet(PCFG, 2, kf_slots=N, device="cpu")
    telems = f1.step_batch(grays, depths, stamps, auto_ba=False).numpy()
    assert telems.shape == (N, 2, 10)
    f2 = SLAMFleet(PCFG, 2, device="cpu")
    outs = [f2.step(grays[i], depths[i], stamps[i], auto_ba=False)
            for i in range(N)]
    t_step = np.stack([o.t_wc.numpy() for o in outs])
    kf_step = np.stack([o.is_keyframe.numpy() for o in outs])
    assert np.linalg.norm(t_step - telems[..., 4:7], axis=-1).max() < 1e-6
    np.testing.assert_array_equal(kf_step, telems[..., 8] > 0.5)
    s1, s2 = f1.stats(), f2.stats()
    assert s1["keyframes_dropped"] == [0, 0]
    assert s1["keyframes"] == s2["keyframes"]
    assert s1["landmarks_active"] == s2["landmarks_active"]


def test_kf_slots_drop_newest_like_the_reference(frames):
    """Every frame keyframes here, so 3 slots over 8 frames keep the first
    3 and drop 5 a stream, in both packages."""
    grays, depths, stamps = (a[:T_SLOTS] for a in frames)
    ref = jmesh.SLAMFleet(CFG, batch=2, mesh=jmesh.make_mesh(1),
                          kf_slots=K_SLOTS)
    jt = np.asarray(ref.step_batch(jnp.asarray(grays), jnp.asarray(depths),
                                   jnp.asarray(stamps), auto_ba=False))
    port = SLAMFleet(PCFG, 2, kf_slots=K_SLOTS, device="cpu",
                     sampler=JaxFleetSampler(2, T_SLOTS))
    pt = port.step_batch(grays, depths, stamps, auto_ba=False).numpy()
    np.testing.assert_array_equal(pt[..., 7:9], jt[..., 7:9])
    jst, pst = ref.stats(), port.stats()
    print(f"K-slot insert: reference {jst}, port {pst}")
    assert pst["keyframes_dropped"] == jst["keyframes_dropped"] == [5, 5]
    assert pst["keyframes"] == jst["keyframes"] == [K_SLOTS, K_SLOTS]
    assert pst["landmarks_active"] == jst["landmarks_active"]


def cycle_fleet_batch(cycle, i0: int):
    """CYCLE_T scan steps of the cycle, stream s offset by s frames:
    (T, B) uint8 grays, uint16 depths and float32 stamps (i0 + t) / 30."""
    idx = [[(i0 + t + s) % len(cycle) for s in range(CYCLE_STREAMS)]
           for t in range(CYCLE_T)]
    return (np.stack([[cycle[i][0] for i in r] for r in idx]),
            np.stack([[cycle[i][1] for i in r] for r in idx]),
            np.repeat(((i0 + np.arange(CYCLE_T)) / 30.0)[:, None],
                      CYCLE_STREAMS, 1).astype(np.float32))


@pytest.fixture(scope="module")
def cycle_fleets():
    """Each fleet's telemetry rows over both calls and its stats."""
    cycle = [(g.astype(np.uint8), (d * 1000.0).astype(np.uint16))
             for g, d, _, _, _ in synthetic.generate_sequence(
                 CYCLE_CFG.camera, 6, seed=3)]
    ref = jmesh.SLAMFleet(CYCLE_CFG, batch=CYCLE_STREAMS,
                          mesh=jmesh.make_mesh(1))
    port = SLAMFleet(PSLAMConfig.from_dict(CYCLE_CFG.to_dict()),
                     CYCLE_STREAMS, device="cpu",
                     sampler=JaxFleetSampler(CYCLE_STREAMS, 2 * CYCLE_T))
    out = {}
    for name, fleet, wrap in (("reference", ref, jnp.asarray),
                              ("port", port, torch.from_numpy)):
        rows = []
        for k, i0 in enumerate((0, CYCLE_T)):
            gs, ds, ts = cycle_fleet_batch(cycle, i0)
            rows.append(np.asarray(fleet.step_batch(wrap(gs), wrap(ds),
                                                    wrap(ts))))
            if k == 0:
                fleet.run_ba(now=CYCLE_T / 30.0)
        out[name] = dict(rows=np.concatenate(rows), stats=fleet.stats())
    print(f"cycle fleets: {({k: v['stats'] for k, v in out.items()})}")
    return out


def test_cycle_fleet_frames_and_ba_rounds_equal(cycle_fleets):
    ref, port = cycle_fleets["reference"], cycle_fleets["port"]
    assert port["rows"].shape == ref["rows"].shape \
        == (2 * CYCLE_T, CYCLE_STREAMS, 10)
    assert np.isfinite(port["rows"]).all()
    # the explicit run_ba and the second call's tick, 0.8 s after the first
    assert port["stats"]["ba_runs"] == ref["stats"]["ba_runs"] == 2


def test_cycle_fleet_maps_within_test_parallels_bounds(cycle_fleets):
    ref = cycle_fleets["reference"]["stats"]
    port = cycle_fleets["port"]["stats"]
    for s in range(CYCLE_STREAMS):
        assert abs(port["keyframes"][s] - ref["keyframes"][s]) <= 1, s
        lm_p, lm_r = port["landmarks_active"][s], ref["landmarks_active"][s]
        assert abs(lm_p - lm_r) <= max(20, lm_r // 10), (s, lm_p, lm_r)
