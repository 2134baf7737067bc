"""PyTorch port vs the JAX reference: frontend/tracker.track_batch over two
batches of 6 synthetic 320x240 frames, fed the reference's own keypoints and
RANSAC draws (torch_parity.JaxSampler), with the second batch started from
the reference's state carried across by convert.py.

Tolerances: keyframe flags, tracking flags, feature and match counts exact.
Per-frame positions 1e-3 m and rotations 1e-3 (quaternion components) on
every frame whose emitted pose has the same support (PnP inlier count) in
both packages.  An epipolar or reprojection error that sits on its
threshold can fall on the other side in float32 evaluated in another order;
F-RANSAC inlier counts then differ by a few (at most 2 % per frame), and
where that changes the emitted pose's support the frame is counted and
printed: at most half the batch, within 1e-2 m / 1e-2.  (On this fixture
2 of the 12 frames; a quarter of all epipolar errors differ from the
reference's in the last bit, which no evaluation order here removes.)

An equal count is not an equal set.  Fed the same inputs and keys, frame 7's
F-RANSAC kept 546 inliers against the reference's 545 with 39 members
different (another hypothesis won), while its PnP sets were equal; the
changed F inliers moved the constant-velocity prior of the anchored PnP,
whose refinement then stopped 3.58 mm from the reference's pose.  With
the weighted 8-point Gram accumulated in float64 (frontend/ransac.py) the
F inlier sets differ by at most 2 and that frame by 0.32 mm, the same
under MKL_CBWR AVX2, AVX512 and COMPATIBLE and ATEN_CPU_CAPABILITY default
and avx2 (AVX-512 host), with the Gauss-Newton normal equations in
float32 or in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import JaxSampler, to_numpy_tree

from dynamic_visual_slam_tpu.config import CameraConfig, SLAMConfig
from dynamic_visual_slam_tpu.frontend import orb as jorb
from dynamic_visual_slam_tpu.frontend import tracker as jtr
from dynamic_visual_slam_tpu.io import synthetic
from dynamic_visual_slam_tpu_torch import convert
from dynamic_visual_slam_tpu_torch.config import SLAMConfig as PSLAMConfig
from dynamic_visual_slam_tpu_torch.frontend import tracker as ptr

torch.set_num_threads(2)
CAM = CameraConfig(width=320, height=240, fx=260.0, fy=260.0,
                   cx=159.5, cy=119.5)
CFG = SLAMConfig().replace(camera=CAM)
PCFG = PSLAMConfig.from_dict(CFG.to_dict())
B = 6


@pytest.fixture(scope="module")
def runs():
    seq = list(synthetic.generate_sequence(CAM, 2 * B, seed=11,
                                           depth_noise=0.004))
    grays = np.stack([f[0] for f in seq]).astype(np.float32)
    depths = (np.stack([f[1] for f in seq]) * 1000.0).astype(np.uint16)
    ts = np.asarray([f[4] for f in seq], np.float32)
    extract = jax.jit(lambda x: jorb.extract_batch(x, CFG.orb))
    track = jax.jit(lambda s, k, d, t: jtr.track_batch(CFG, s, k, d, t))
    sampler = JaxSampler(2 * B)
    out = []
    jstate = jtr.init_state(CFG)
    pstate = ptr.init_state(PCFG, "cpu")
    for i in range(2):
        sl = slice(i * B, (i + 1) * B)
        kps = extract(jnp.asarray(grays[sl]))
        if i == 1:      # carry the reference's state across
            pstate = convert.tracker_state(to_numpy_tree(jstate))
        jstate, jout = track(jstate, kps, jnp.asarray(depths[sl]),
                             jnp.asarray(ts[sl]))
        pstate, pout = ptr.track_batch(
            PCFG, pstate, convert.keypoints(to_numpy_tree(kps)),
            torch.from_numpy(depths[sl]), torch.from_numpy(ts[sl]), sampler)
        out.append((jout, pout))
    return out, jstate, pstate, sampler


@pytest.mark.parametrize("batch", [0, 1])
def test_poses_and_flags_match(runs, batch):
    jout, pout = runs[0][batch]
    same = pout.n_pnp_inliers.numpy() == np.asarray(jout.n_pnp_inliers)
    print(f"batch {batch}: {int((~same).sum())} frame(s) with a different "
          f"pose support: {np.nonzero(~same)[0].tolist()}")
    dt = np.abs(pout.t_wc.numpy() - np.asarray(jout.t_wc)).max(-1)
    dq = np.abs(pout.q_wc.numpy() - np.asarray(jout.q_wc)).max(-1)
    print(f"batch {batch}: same support: max position {dt[same].max():.3e} m, "
          f"max quaternion {dq[same].max():.3e}; per frame {dt.tolist()}")
    assert (~same).sum() <= B // 2
    for sel, tol in ((same, 1e-3), (~same, 1e-2)):
        np.testing.assert_allclose(pout.t_wc.numpy()[sel],
                                   np.asarray(jout.t_wc)[sel], atol=tol)
        np.testing.assert_allclose(pout.q_wc.numpy()[sel],
                                   np.asarray(jout.q_wc)[sel], atol=tol)
    for name in ("is_keyframe", "tracking_ok", "n_features", "n_matches"):
        np.testing.assert_array_equal(getattr(pout, name).numpy(),
                                      np.asarray(getattr(jout, name)), name)
    jn, pn = np.asarray(jout.n_inliers), pout.n_inliers.numpy()
    print(f"batch {batch}: F-RANSAC inlier counts {jn.tolist()} vs "
          f"{pn.tolist()}")
    assert (np.abs(jn - pn) <= 0.02 * np.maximum(jn, 1)).all()


def test_keyframe_payload_matches(runs):
    jout, pout = runs[0][0]
    jk, pk = jout.keyframe, pout.keyframe
    np.testing.assert_array_equal(pk.mask.numpy(), np.asarray(jk.mask))
    m = np.asarray(jk.mask)
    np.testing.assert_array_equal(pk.uv.numpy()[m], np.asarray(jk.uv)[m])
    np.testing.assert_array_equal(pk.desc_bits.numpy()[m],
                                  np.asarray(jk.desc_bits)[m])
    np.testing.assert_allclose(pk.xyz_w.numpy()[m], np.asarray(jk.xyz_w)[m],
                               atol=2e-3)
    np.testing.assert_array_equal(pk.frame_idx.numpy(),
                                  np.asarray(jk.frame_idx))


def test_final_state_matches(runs):
    _, jstate, pstate, sampler = runs
    assert int(pstate.frame_idx) == int(jstate.frame_idx) == 2 * B
    assert bool(pstate.has_kf) == bool(jstate.has_kf)
    assert int(pstate.frames_since_kf) == int(jstate.frames_since_kf)
    np.testing.assert_array_equal(pstate.kf_mask.numpy(),
                                  np.asarray(jstate.kf_mask))
    # the last frame is one whose support differs (see module docstring)
    np.testing.assert_allclose(pstate.t_wc.numpy(), np.asarray(jstate.t_wc),
                               atol=1e-2)
    assert sampler.calls > 0
    back = convert.to_numpy(pstate)
    assert back["prev"]["desc_bits"].shape == (PCFG.orb.max_keypoints, 256)


def test_lost_frames_reset_without_host_reads():
    """All-black frames: nothing extracted, tracking lost, no keyframe."""
    grays = torch.zeros((3, 120, 160))
    depths = torch.zeros((3, 120, 160))
    cfg = PSLAMConfig().replace(camera=PSLAMConfig().camera.scaled(160, 120))
    from dynamic_visual_slam_tpu_torch.frontend import orb as porb
    kps = porb.extract_batch(grays, cfg.orb)
    state, out = ptr.track_batch(
        cfg, ptr.init_state(cfg, "cpu"), kps, depths,
        torch.tensor([0.0, 0.033, 0.066]),
        ptr.generator_sampler(torch.Generator().manual_seed(0)))
    assert not out.tracking_ok.any() and not out.is_keyframe.any()
    assert not bool(state.has_prev)
