"""PyTorch port vs the JAX reference: the dynamic scene (io/synthetic's
walkers) and the dynamic per-frame slice — SLAMSystem.process with
ground-truth person boxes culling the walkers' keypoints.

Tolerances, and why:
- the walker scene (frames, depth, ground-truth boxes, the swept-volume
  oracle, both walker sets): bit-equal; the port's io/synthetic is a numpy
  copy of the reference's.
- the slice (320x240, 64 frames of default_walkers, 0.4 % depth noise,
  GT boxes through boxes_to_detections, synchronous BA firing at 2 s,
  place recognition off): the port is fed the reference's keypoints and
  RANSAC draws (as tests/test_torch_perframe.py).  Keyframe and tracking
  flags, depth-valid keypoint counts after culling, match counts,
  keyframes and BA rounds equal; no landmark carries the person category
  in either; landmark counts within 2 % (measured equal, 2,307).
  F-RANSAC inlier counts within 2 % (threshold cases,
  tests/test_torch_tracker.py).
  Positions: RMS within 1 mm and every frame within 6 mm.  Measured on an
  AVX-512 host, the test run alone under MKL_CBWR AVX2, AVX512 and
  COMPATIBLE, each with ATEN_CPU_CAPABILITY default and avx2: RMS 0.649 to
  0.650 mm and worst 4.296 to 4.297 mm (frame 4) under every one of
  them; bounds about 1.5 and 1.4 times that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import JaxSampler, to_numpy_tree

from dynamic_visual_slam_tpu.config import CameraConfig, SLAMConfig
from dynamic_visual_slam_tpu.frontend import orb as jorb
from dynamic_visual_slam_tpu.io import synthetic as jsyn
from dynamic_visual_slam_tpu.pipeline.slam import SLAMSystem as JaxSLAM
from dynamic_visual_slam_tpu.semantic.detector import \
    boxes_to_detections as jboxes
from dynamic_visual_slam_tpu_torch import convert
from dynamic_visual_slam_tpu_torch.config import CameraConfig as PCam
from dynamic_visual_slam_tpu_torch.config import SLAMConfig as PSLAMConfig
from dynamic_visual_slam_tpu_torch.frontend import tracker as ptr
from dynamic_visual_slam_tpu_torch.io import synthetic as psyn
from dynamic_visual_slam_tpu_torch.pipeline.slam import SLAMSystem
from dynamic_visual_slam_tpu_torch.semantic.detector import \
    boxes_to_detections as pboxes

torch.set_num_threads(2)
SMALL = dict(width=160, height=120, fx=130.0, fy=130.0, cx=79.5, cy=59.5)


@pytest.mark.parametrize("walkers", ["default", "hard"])
def test_dynamic_sequence_bit_equal(walkers):
    n = 6
    jobj = (jsyn.default_walkers if walkers == "default"
            else jsyn.hard_walkers)(n)
    pobj = (psyn.default_walkers if walkers == "default"
            else psyn.hard_walkers)(n)
    assert [vars(o) for o in pobj] == [vars(o) for o in jobj]
    want = list(jsyn.generate_dynamic_sequence(
        CameraConfig(**SMALL), n, seed=2, objects=jobj, depth_noise=0.004))
    got = list(psyn.generate_dynamic_sequence(
        PCam(**SMALL), n, seed=2, objects=pobj, depth_noise=0.004))
    n_boxes = 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        n_boxes += len(g[5])
    assert n_boxes >= n
    xyz = np.random.default_rng(0).uniform([-1, -0.6, 0.8], [1, 0.6, 2.4],
                                           (4000, 3))
    hits = psyn.walker_swept_hits(xyz, pobj, 4.0)
    np.testing.assert_array_equal(hits,
                                  jsyn.walker_swept_hits(xyz, jobj, 4.0))
    assert 0 < hits.sum() < len(xyz)


def test_moving_object_kinematics_equal():
    kw = dict(z=2.0, vz=-0.2, velocity=(0.3, 0.0), stop_go=(1.0, 0.5))
    j, p = jsyn.MovingObject(**kw), psyn.MovingObject(**kw)
    for t in (0.0, 0.25, 0.75, 1.25, 4.0):
        assert p.travel_time(t) == j.travel_time(t)
        np.testing.assert_array_equal(p.center(t), j.center(t))
        assert p.z_at(t) == j.z_at(t)


CAM = CameraConfig(width=320, height=240, fx=260.0, fy=260.0,
                   cx=159.5, cy=119.5)
CFG = SLAMConfig().replace(camera=CAM)
PCFG = PSLAMConfig.from_dict(CFG.to_dict())
N_FRAMES = 64
SYS_KW = dict(ba_async=False, enable_place_recognition=False)


@pytest.fixture(scope="module")
def slice_runs():
    frames = list(jsyn.generate_dynamic_sequence(CAM, N_FRAMES, seed=0,
                                                 depth_noise=0.004))
    cap = CFG.semantic.max_detections
    ref = JaxSLAM(CFG, **SYS_KW)
    for g, d, _, _, ts, boxes in frames:
        ref.process(g, d, ts, detections=jboxes(boxes, cap))
    ref.finalize()

    extract = jax.jit(lambda g: jorb.extract(g, CFG.orb))

    def reference_keypoints(gray, cfg):
        return convert.keypoints(to_numpy_tree(
            extract(jnp.asarray(gray.numpy(), jnp.float32))))

    mp = pytest.MonkeyPatch()
    mp.setattr(ptr, "extract", reference_keypoints)
    try:
        port = SLAMSystem(PCFG, device="cpu", sampler=JaxSampler(N_FRAMES),
                          **SYS_KW)
        for g, d, _, _, ts, boxes in frames:
            port.process(g, d, ts,
                         detections=pboxes(boxes, cap, device="cpu"))
        port.finalize()
    finally:
        mp.undo()
    return frames, ref, port


def test_dynamic_slice_flags_and_counts_match_reference(slice_runs):
    frames, ref, port = slice_runs
    for name in ("is_keyframe", "tracking_ok", "n_features", "n_matches"):
        assert [getattr(f, name) for f in port.trajectory] == \
            [getattr(f, name) for f in ref.trajectory], name
    for key in ("frames", "keyframes", "ba_runs"):
        assert port.stats[key] == ref.stats[key], key
    assert port.stats["keyframes"] >= 3 and port.stats["ba_runs"] >= 1
    for p, j in zip(port.trajectory, ref.trajectory):
        assert abs(p.n_inliers - j.n_inliers) <= 0.02 * max(j.n_inliers, 1)
    # the boxes cull keypoints: fewer depth-valid ones than without them
    step = jax.jit(lambda g: jorb.extract(g, CFG.orb))
    culled = 0
    for (g, d, *_), fr in zip(frames, port.trajectory):
        kp = step(jnp.asarray(g))
        uv, m = np.asarray(kp.uv), np.asarray(kp.mask)
        z = d[np.clip(np.round(uv[:, 1]).astype(int), 0, CAM.height - 1),
              np.clip(np.round(uv[:, 0]).astype(int), 0, CAM.width - 1)]
        ok = m & (z > CFG.depth.min_depth) & (z < CFG.depth.max_depth)
        culled += int(ok.sum()) - fr.n_features
    print(f"dynamic slice: {culled} keypoints culled by the person boxes "
          f"over {N_FRAMES} frames")
    assert culled > 100


def test_dynamic_slice_map_has_no_person_landmarks(slice_runs):
    _, ref, port = slice_runs
    pl, jl = port.landmarks_world(), ref.landmarks_world()
    assert not np.any(pl["category"] == 1)
    assert not np.any(np.asarray(jl["category"]) == 1)
    assert len(pl["xyz"]) > 100
    print(f"dynamic slice: landmarks port {len(pl['xyz'])}, reference "
          f"{len(jl['xyz'])}")
    assert abs(len(pl["xyz"]) - len(jl["xyz"])) <= 0.02 * len(jl["xyz"])


def test_dynamic_slice_positions_match_reference(slice_runs):
    frames, ref, port = slice_runs
    pt = np.stack([f.t_wc for f in port.trajectory])
    jt = np.stack([f.t_wc for f in ref.trajectory])
    d = np.linalg.norm(pt - jt, axis=1)
    rms = float(np.sqrt(np.mean(d ** 2)))
    print(f"dynamic slice: position difference RMS {rms * 1e3:.3f} mm, max "
          f"{d.max() * 1e3:.3f} mm (frame {int(d.argmax())})")
    assert rms < 1e-3
    assert d.max() < 6e-3
