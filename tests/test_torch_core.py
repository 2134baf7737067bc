"""PyTorch port vs the JAX reference: core/lie, core/camera,
core/containers on the same random batches (made with numpy from a seed).

Tolerances: indices and masks exact; floats within 1e-5 (float32 rounding
of the same formulas in another evaluation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_visual_slam_tpu.config import CameraConfig as JCam
from dynamic_visual_slam_tpu.core import camera as jcam
from dynamic_visual_slam_tpu.core import containers as jcont
from dynamic_visual_slam_tpu.core import lie as jlie
from dynamic_visual_slam_tpu_torch.config import CameraConfig as PCam
from dynamic_visual_slam_tpu_torch.config import SLAMConfig as PSLAMConfig
from dynamic_visual_slam_tpu_torch.core import camera as pcam
from dynamic_visual_slam_tpu_torch.core import containers as pcont
from dynamic_visual_slam_tpu_torch.core import lie as plie

torch.set_num_threads(2)
TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.mark.parametrize("fn", ["quat_normalize", "quat_conj", "quat_to_mat",
                                "so3_log"])
def test_lie_unary_quat(fn):
    q = _rand_quats(np.random.default_rng(0), 64) * 1.7
    want = np.asarray(getattr(jlie, fn)(jnp.asarray(q)))
    got = getattr(plie, fn)(_t(q)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


def test_lie_binary_and_maps():
    rng = np.random.default_rng(1)
    qa, qb = _rand_quats(rng, 64), _rand_quats(rng, 64)
    ta, tb = rng.normal(size=(2, 64, 3)).astype(np.float32)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    phi = (rng.normal(size=(64, 3)) * 0.5).astype(np.float32)
    np.testing.assert_allclose(plie.quat_mul(_t(qa), _t(qb)).numpy(),
                               np.asarray(jlie.quat_mul(qa, qb)), atol=TOL)
    np.testing.assert_allclose(plie.quat_rotate(_t(qa), _t(v)).numpy(),
                               np.asarray(jlie.quat_rotate(qa, v)), atol=TOL)
    np.testing.assert_allclose(plie.so3_exp(_t(phi)).numpy(),
                               np.asarray(jlie.so3_exp(phi)), atol=TOL)
    m = np.asarray(jlie.quat_to_mat(qa))
    np.testing.assert_allclose(plie.mat_to_quat(_t(m)).numpy(),
                               np.asarray(jlie.mat_to_quat(m)), atol=TOL)
    for got, want in zip(plie.se3_compose(_t(qa), _t(ta), _t(qb), _t(tb)),
                         jlie.se3_compose(qa, ta, qb, tb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    for got, want in zip(plie.se3_inverse(_t(qa), _t(ta)),
                         jlie.se3_inverse(qa, ta)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    np.testing.assert_allclose(plie.det3x3(_t(m)).numpy(),
                               np.linalg.det(m), atol=TOL)


def test_camera_project_backproject():
    rng = np.random.default_rng(2)
    kw = dict(width=320, height=240, fx=260.0, fy=261.0, cx=159.5, cy=119.5)
    kj = jcam.Intrinsics.from_config(JCam(**kw))
    kp = pcam.Intrinsics.from_config(PCam(**kw))
    uv = rng.uniform(0, 300, (128, 2)).astype(np.float32)
    d = rng.uniform(0.3, 3.0, 128).astype(np.float32)
    xyz = np.asarray(jcam.backproject(kj, uv, d))
    np.testing.assert_allclose(pcam.backproject(kp, _t(uv), _t(d)).numpy(),
                               xyz, atol=TOL)
    np.testing.assert_allclose(pcam.project(kp, _t(xyz)).numpy(),
                               np.asarray(jcam.project(kj, xyz)), atol=1e-3)
    q, t = _rand_quats(rng, 1)[0], rng.normal(size=3).astype(np.float32)
    np.testing.assert_allclose(
        pcam.world_to_camera(_t(q), _t(t), _t(xyz)).numpy(),
        np.asarray(jcam.world_to_camera(q, t, xyz)), atol=TOL)
    np.testing.assert_array_equal(
        pcam.in_bounds(_t(uv), 320, 240, 2.0).numpy(),
        np.asarray(jcam.in_bounds(uv, 320, 240, 2.0)))


def test_masked_topk_ties_at_lower_index():
    rng = np.random.default_rng(3)
    s = rng.integers(0, 6, 200).astype(np.float32)    # many ties
    m = rng.random(200) < 0.7
    ji, jv = jcont.masked_topk(jnp.asarray(s), jnp.asarray(m), 40)
    pi, pv = pcont.masked_topk(_t(s), _t(m), 40)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("k", [1, 37, 200, 512])
def test_topk_mask_int(k):
    rng = np.random.default_rng(4 + k)
    s = rng.integers(0, 256, (3, 1024)).astype(np.float32)
    v = rng.random((3, 1024)) < 0.6
    want = np.stack([np.asarray(jcont.topk_mask_int(jnp.asarray(s[i]),
                                                    jnp.asarray(v[i]), k))
                     for i in range(3)])
    np.testing.assert_array_equal(pcont.topk_mask_int(_t(s), _t(v), k).numpy(),
                                  want)


def test_stable_partition_and_compress():
    rng = np.random.default_rng(5)
    m = rng.random(300) < 0.4
    np.testing.assert_array_equal(
        pcont.stable_partition(_t(m)).numpy(),
        np.asarray(jcont.stable_partition(jnp.asarray(m))))
    vals = rng.normal(size=(300, 3)).astype(np.float32)
    for cap in (64, 400):
        jo, jm = jcont.compress_to_capacity(jnp.asarray(vals), jnp.asarray(m),
                                            cap)
        po, pm = pcont.compress_to_capacity({"v": _t(vals)}, _t(m), cap)
        np.testing.assert_array_equal(po["v"].numpy(), np.asarray(jo))
        np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))


def test_masked_argmin_and_scatter_set():
    rng = np.random.default_rng(6)
    c = rng.integers(0, 5, (16, 40)).astype(np.float32)
    m = rng.random((16, 40)) < 0.5
    m[3] = False
    for got, want in zip(pcont.masked_argmin(_t(c), _t(m), dim=1),
                         jcont.masked_argmin(jnp.asarray(c), jnp.asarray(m),
                                             axis=1)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    arr = rng.normal(size=(10, 2)).astype(np.float32)
    idx = np.array([1, 4, 7, 9], np.int32)
    upd = rng.normal(size=(4, 2)).astype(np.float32)
    valid = np.array([True, False, True, True])
    want = jcont.scatter_set(jnp.asarray(arr), jnp.asarray(idx),
                             jnp.asarray(upd), jnp.asarray(valid))
    got = pcont.scatter_set(_t(arr), _t(idx).long(), _t(upd), _t(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_config_copy_round_trips_and_matches_reference():
    from dynamic_visual_slam_tpu.config import SLAMConfig as JSLAMConfig
    assert PSLAMConfig().to_dict() == JSLAMConfig().to_dict()
    cfg = PSLAMConfig.preset("tum_fr3")
    assert PSLAMConfig.from_json(cfg.to_json()) == cfg
    assert jax.default_backend() == "cpu"


def test_io_copies_match_reference():
    """The port's own copies of io/synthetic and io/trajectory: frames,
    depths and poses identical; ATE equal to 1e-12 (float64 numpy)."""
    from dynamic_visual_slam_tpu.io import synthetic as jsyn
    from dynamic_visual_slam_tpu.io import trajectory as jtraj
    from dynamic_visual_slam_tpu_torch.io import synthetic as psyn
    from dynamic_visual_slam_tpu_torch.io import trajectory as ptraj
    kw = dict(width=160, height=120, fx=130.0, fy=130.0, cx=79.5, cy=59.5)
    want = list(jsyn.generate_sequence(JCam(**kw), 3, seed=5,
                                       depth_noise=0.004))
    got = list(psyn.generate_sequence(PCam(**kw), 3, seed=5,
                                      depth_noise=0.004))
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(3)
    gt = rng.normal(size=(40, 3))
    est = gt @ _rot_z(0.3).T + 0.2 + rng.normal(size=(40, 3)) * 0.01
    assert ptraj.ate_rmse(est, gt) == pytest.approx(
        jtraj.ate_rmse(est, gt), abs=1e-12)


def _rot_z(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
