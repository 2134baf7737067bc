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
"""

import jax.numpy as jnp
import numpy as np
import torch

from test_torch_fleet import CFG, N, PCFG, frames  # noqa: F401
from torch_parity import JaxFleetSampler

from dynamic_visual_slam_tpu.parallel import mesh as jmesh
from dynamic_visual_slam_tpu_torch.parallel.mesh import SLAMFleet

torch.set_num_threads(2)
T_SLOTS, K_SLOTS = 8, 3


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
