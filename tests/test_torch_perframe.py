"""PyTorch port vs the JAX reference: the per-frame path —
``tracker.track_step`` and ``SLAMSystem.process`` with place recognition,
geometric loop verification and relocalization on.

Both packages see the same frames and the same RANSAC draws (the port gets
the reference's own threefry samples through ``sampler=``, loop and
relocalization verification included), and the port is fed the reference's
own keypoints: the online vocabulary is a k-medians tree, which one flipped
descriptor bit reshapes, and the port's extraction is held to the
reference's in tests/test_torch_image_orb.py.

Tolerances, and why:
- track_step, 12 frames at 320x240: keyframe and tracking flags, feature
  and match counts exact; positions 1.5e-3 m and quaternions 1e-3 on
  frames whose emitted pose has the same PnP support in both packages,
  1e-2 elsewhere (at most half the frames).  F-RANSAC inlier counts within
  2 %: epipolar errors on the threshold fall on the other side in float32
  evaluated in another order (tests/test_torch_tracker.py).  The position
  bound is measured: frame 5 keeps the reference's PnP support and lands
  0.51 to 0.86 mm from its pose with the port's RANSAC sums all in
  float32, varying with the CPU path (an AVX-512 host under MKL_CBWR AVX2
  and COMPATIBLE and ATEN_CPU_CAPABILITY default, avx2 and avx512).  The
  8-point Gram summed in float64 (frontend/ransac.py) moves it: it lands
  1.13 mm away, one coordinate 1.071 mm, the same under all of those and
  MKL_CBWR AVX512, with the Gauss-Newton sums in float32 or float64, while
  frame 7 comes to the reference's support and pose.  The bound is 1.4
  times that coordinate.
- the slice on the relocalization fixture of tests/test_reloc.py (160x120,
  116 frames): keyframe and tracking flags equal; loop-candidate records
  equal in keyframe, candidate and applied flag, F-RANSAC and PnP inliers
  within 2 each (the same threshold cases); relocalization records equal.
  Positions within 30 mm up to frame 90, 60 mm on every frame, 25 mm RMS.
  Measured on an AVX-512 host under MKL_CBWR AVX2, AVX512 and COMPATIBLE
  and ATEN_CPU_CAPABILITY default and avx2, with the port's sums as
  shipped (frontend/ransac.py: 8-point Gram and Gauss-Newton normal
  equations in float64, the rest float32).  At frame 22, a keyframe,
  F-RANSAC keeps 214 inliers where the reference keeps 216 from the same
  draws and inputs, the PnP support differs by one (117 against 118) and
  the pose by 13.8 mm, which the chain carries; frame 59 adds 1.1 mm, the
  blank frames from 60 on extrapolate the offset to 24.8 mm, and the
  relocalization brings the chain back to 0.0 mm at frame 68; at frame 98
  a one-inlier difference in PnP support moves the pose by 45 mm (the
  replayed segment is tracked in a
  weakly conditioned view, where the reference's own pose error to the
  truth is about 5 cm).  Worst up to frame 90: 24.87 mm under every
  setting, bound 30 mm (1.2 times); whole run 45.1 to 54.2 mm at worst
  and 16.3 to 20.3 mm RMS by setting, within 60 and 25 mm.  The port's
  own summation moves these figures.  With every sum in float32, as in
  the reference, the worst up to frame 90 was 13.71 mm on that host and
  3.1 mm on another x86 host.  With only the 8-point Gram in float64 it is 24.8 mm
  under four settings but 47.3 mm under ATEN_CPU_CAPABILITY default and
  MKL_CBWR AVX2.  With the DLT's Gram in float64 as well it is 47.0 to
  50.2 mm.  The Gauss-Newton sums in float64 are what make it one figure
  under every setting.
- the port alone, with its own extraction, meets tests/test_reloc.py's
  bounds: at least one relocalization, and the replayed segment's ATE
  below 0.15 m."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import JaxSampler, to_numpy_tree

from dynamic_visual_slam_tpu.config import CameraConfig, MapConfig, SLAMConfig
from dynamic_visual_slam_tpu.frontend import orb as jorb
from dynamic_visual_slam_tpu.frontend import tracker as jtr
from dynamic_visual_slam_tpu.io import synthetic
from dynamic_visual_slam_tpu.pipeline.slam import SLAMSystem as JaxSLAM
from dynamic_visual_slam_tpu_torch import convert
from dynamic_visual_slam_tpu_torch.config import SLAMConfig as PSLAMConfig
from dynamic_visual_slam_tpu_torch.frontend import tracker as ptr
from dynamic_visual_slam_tpu_torch.pipeline.slam import SLAMSystem

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# track_step

CAM = CameraConfig(width=320, height=240, fx=260.0, fy=260.0,
                   cx=159.5, cy=119.5)
CFG = SLAMConfig().replace(camera=CAM)
PCFG = PSLAMConfig.from_dict(CFG.to_dict())
N_STEP = 12


@pytest.fixture(scope="module")
def steps():
    seq = list(synthetic.generate_sequence(CAM, N_STEP, seed=11,
                                           depth_noise=0.004))
    extract = jax.jit(lambda g: jorb.extract(g, CFG.orb))
    step = jax.jit(lambda s, g, d, t, k: jtr.track_step(CFG, s, g, d, t,
                                                        kps=k))
    sampler = JaxSampler(N_STEP)
    jstate, pstate = jtr.init_state(CFG), ptr.init_state(PCFG, "cpu")
    outs = []
    for gray, depth, _, _, ts in seq:
        depth_mm = (depth * 1000.0).astype(np.uint16)
        kps = extract(jnp.asarray(gray, jnp.float32))
        jstate, jout = step(jstate, jnp.asarray(gray), jnp.asarray(depth_mm),
                            jnp.asarray(ts, jnp.float32), kps)
        pstate, pout = ptr.track_step(
            PCFG, pstate, None, torch.from_numpy(depth_mm),
            torch.tensor(ts, dtype=torch.float32), sampler,
            kps=convert.keypoints(to_numpy_tree(kps)))
        outs.append((jout, pout))
    return outs, jstate, pstate


def test_track_step_matches_reference(steps):
    outs, jstate, pstate = steps
    get = lambda o, name: np.stack([np.asarray(getattr(x, name))  # noqa
                                    for x in o])
    jo, po = [o[0] for o in outs], [o[1] for o in outs]
    same = get(po, "n_pnp_inliers") == get(jo, "n_pnp_inliers")
    d = np.linalg.norm(get(po, "t_wc") - get(jo, "t_wc"), axis=1)
    print(f"track_step: per-frame position difference (mm) "
          f"{np.round(d * 1e3, 2).tolist()}; frames with another pose "
          f"support {np.nonzero(~same)[0].tolist()}")
    assert (~same).sum() <= N_STEP // 2
    for sel, t_tol, q_tol in ((same, 1.5e-3, 1e-3), (~same, 1e-2, 1e-2)):
        np.testing.assert_allclose(get(po, "t_wc")[sel], get(jo, "t_wc")[sel],
                                   atol=t_tol)
        np.testing.assert_allclose(get(po, "q_wc")[sel], get(jo, "q_wc")[sel],
                                   atol=q_tol)
    for name in ("is_keyframe", "tracking_ok", "n_features", "n_matches"):
        np.testing.assert_array_equal(get(po, name), get(jo, name), name)
    jn, pn = get(jo, "n_inliers"), get(po, "n_inliers")
    assert (np.abs(jn - pn) <= 0.02 * np.maximum(jn, 1)).all(), (jn, pn)
    assert get(po, "tracking_ok")[1:].all()
    assert int(pstate.frame_idx) == int(jstate.frame_idx) == N_STEP
    assert int(pstate.frames_since_kf) == int(jstate.frames_since_kf)


def test_track_step_payload_matches_reference(steps):
    jout, pout = steps[0][2]
    jk, pk = jout.keyframe, pout.keyframe
    np.testing.assert_array_equal(pk.mask.numpy(), np.asarray(jk.mask))
    m = np.asarray(jk.mask)
    np.testing.assert_array_equal(pk.desc_bits.numpy()[m],
                                  np.asarray(jk.desc_bits)[m])
    np.testing.assert_allclose(pk.xyz_w.numpy()[m], np.asarray(jk.xyz_w)[m],
                               atol=2e-3)
    assert int(pk.frame_idx) == int(jk.frame_idx) == 2


# ---------------------------------------------------------------------------
# the slice: SLAMSystem.process on the relocalization fixture

RCAM = CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                    cx=79.5, cy=59.5)
_base = SLAMConfig()
RCFG = _base.replace(
    camera=RCAM,
    keyframe=dataclasses.replace(_base.keyframe, max_frames_between_kf=6),
    map=MapConfig(max_landmarks=1024, max_keyframes=8,
                  max_obs_per_landmark=6, max_obs_per_keyframe=256))
PRCFG = PSLAMConfig.from_dict(RCFG.to_dict())
SYS_KW = dict(vocab_train_keyframes=3, loop_min_gap=4, loop_min_score=0.08,
              loop_min_inliers=20, loop_correction=False)
N_A, N_BLACK, B_START = 60, 6, 10


def _reloc_frames():
    seg_a = list(synthetic.generate_sequence(RCAM, N_A, seed=5,
                                             depth_noise=0.004))
    blank = np.zeros((RCAM.height, RCAM.width), np.float32)
    frames = [(g, d, t) for g, d, _, t, _ in seg_a]
    frames += [(blank, np.ones_like(blank), None)] * N_BLACK
    frames += [(g, d, t) for g, d, _, t, _ in seg_a[B_START:]]
    return frames


def _replay_ate(slam, frames):
    est = np.stack([f.t_wc for f in slam.trajectory])[N_A + N_BLACK:]
    gt = np.stack([t for _, _, t in frames[N_A + N_BLACK:]])
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1))))


@pytest.fixture(scope="module")
def reloc_runs():
    frames = _reloc_frames()
    ref = JaxSLAM(RCFG, **SYS_KW)
    for i, (g, d, _) in enumerate(frames):
        ref.process(g, d, i / 30.0)
    ref.finalize()

    extract = jax.jit(lambda g: jorb.extract(g, RCFG.orb))

    def reference_keypoints(gray, cfg):
        return convert.keypoints(to_numpy_tree(
            extract(jnp.asarray(gray.numpy(), jnp.float32))))

    mp = pytest.MonkeyPatch()
    mp.setattr(ptr, "extract", reference_keypoints)
    try:
        port = SLAMSystem(PRCFG, device="cpu",
                          sampler=JaxSampler(len(frames)), **SYS_KW)
        for i, (g, d, _) in enumerate(frames):
            port.process(g, d, i / 30.0)
        port.finalize()
    finally:
        mp.undo()
    return frames, ref, port


def test_process_flags_and_records_match_reference(reloc_runs):
    _, ref, port = reloc_runs
    for name in ("is_keyframe", "tracking_ok"):
        assert [getattr(f, name) for f in port.trajectory] == \
            [getattr(f, name) for f in ref.trajectory], name
    for key in ("frames", "keyframes", "loop_candidates", "relocalizations"):
        assert port.stats[key] == ref.stats[key], key
    assert port.stats["relocalizations"] >= 1
    assert len(port.loop_candidates) == len(ref.loop_candidates) > 10
    for p, j in zip(port.loop_candidates, ref.loop_candidates):
        for key in ("keyframe", "candidate", "timestamp"):
            assert p[key] == j[key], (key, p, j)
        assert p.get("applied") == j.get("applied")
        assert abs(p["inliers"] - j["inliers"]) <= 2, (p, j)
        assert abs(p["pnp_inliers"] - j["pnp_inliers"]) <= 2, (p, j)
    assert port.reloc_log == ref.reloc_log


def test_process_positions_match_reference(reloc_runs):
    frames, ref, port = reloc_runs
    pt = np.stack([f.t_wc for f in port.trajectory])
    jt = np.stack([f.t_wc for f in ref.trajectory])
    d = np.linalg.norm(pt - jt, axis=1)
    print(f"process: position difference RMS {np.sqrt(np.mean(d ** 2)):.5f} "
          f"m, max {d.max():.5f} m (frame {int(d.argmax())}); up to frame "
          f"90 max {d[:91].max():.5f} m (frame {int(d[:91].argmax())}); "
          f"replay ATE port "
          f"{_replay_ate(port, frames):.4f} m, reference "
          f"{_replay_ate(ref, frames):.4f} m")
    assert d[:91].max() < 3e-2
    assert d.max() < 6e-2
    assert np.sqrt(np.mean(d ** 2)) < 2.5e-2


def test_port_relocalizes_with_its_own_extraction():
    frames = _reloc_frames()
    port = SLAMSystem(PRCFG, device="cpu", **SYS_KW)
    for i, (g, d, _) in enumerate(frames):
        port.process(g, d, i / 30.0)
    port.finalize()
    assert port.stats["relocalizations"] >= 1, port.reloc_log
    assert _replay_ate(port, frames) < 0.15


def test_defaults_are_the_reference_defaults():
    """SLAMSystem(SLAMConfig()) has every field of the reference with its
    default: place recognition, loop correction through the pose graph and
    relocalization on."""
    ref = {f.name: f.default for f in dataclasses.fields(JaxSLAM)
           if f.init}
    port = {f.name: f.default for f in dataclasses.fields(SLAMSystem)
            if f.init}
    for name, default in ref.items():
        assert port[name] == default, name
    assert set(port) - set(ref) == {"device", "sampler"}
    slam = SLAMSystem(PSLAMConfig(), device="cpu")
    assert slam.enable_place_recognition and slam.loop_pgo
    assert slam.enable_relocalization and slam.sync_every == 1


def test_default_system_runs_both_paths():
    cfg = PSLAMConfig().replace(camera=PSLAMConfig().camera.scaled(160, 120))
    seq = list(synthetic.generate_sequence(RCAM, 16, seed=3))
    g = np.stack([f[0] for f in seq]).astype(np.uint8)
    d = (np.stack([f[1] for f in seq]) * 1000.0).astype(np.uint16)
    slam = SLAMSystem(cfg, device="cpu")
    got = [slam.process(g[i], d[i], i / 30.0) for i in range(8)]
    assert all(fr is not None and fr.timestamp == i / 30.0
               for i, fr in enumerate(got))
    slam.process_batch(g[8:12], d[8:12], np.arange(8, 12) / 30.0)
    slam.process_batch(g[12:], d[12:], np.arange(12, 16) / 30.0)
    slam.finalize()
    assert len(slam.trajectory) == 16
    assert slam.stats["keyframes"] >= slam.vocab_train_keyframes
    assert slam._bow_db is not None and slam._bow_db.count >= 1
