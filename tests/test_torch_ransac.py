"""PyTorch port vs the JAX reference: ops/linalg_small and
frontend/ransac, on synthetic two-view scenes made with numpy from a seed.

RANSAC is held on EQUAL samples: the reference's own threefry draws
(``_sample_indices``) are passed to the port through ``samples=``.  Then
F (up to scale and sign), poses and inlier masks agree to 1e-4 — float32
evaluation-order differences only.  The small solvers are held at 1e-4 on
well-conditioned random systems."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_visual_slam_tpu.config import SLAMConfig
from dynamic_visual_slam_tpu.core import lie as jlie
from dynamic_visual_slam_tpu.core.camera import Intrinsics as JK
from dynamic_visual_slam_tpu.frontend import ransac as jr
from dynamic_visual_slam_tpu.ops import linalg_small as jls
from dynamic_visual_slam_tpu_torch.config import SLAMConfig as PSLAMConfig
from dynamic_visual_slam_tpu_torch.core.camera import Intrinsics as PK
from dynamic_visual_slam_tpu_torch.frontend import ransac as pr
from dynamic_visual_slam_tpu_torch.ops import linalg_small as pls

torch.set_num_threads(2)
CFG = SLAMConfig.preset("tum_fr3")
KJ = JK.from_config(CFG.camera)
KP = PK.from_config(PSLAMConfig.preset("tum_fr3").camera)
K_NP = np.asarray(KJ.matrix())
TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def make_scene(seed, n=256, outlier_frac=0.3, noise_px=0.5):
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-2, -1.5, 2.0], [2, 1.5, 6.0], (n, 3)).astype(np.float32)
    r = np.asarray(jlie.rodrigues(jnp.asarray(rng.normal(size=3) * 0.1,
                                              jnp.float32)))
    tvec = (rng.normal(size=3) * 0.3).astype(np.float32)
    cam2 = pts @ r.T + tvec
    uv1 = ((pts / pts[:, 2:]) @ K_NP.T)[:, :2] + rng.normal(size=(n, 2)) * noise_px
    uv2 = ((cam2 / cam2[:, 2:]) @ K_NP.T)[:, :2] + rng.normal(size=(n, 2)) * noise_px
    out = rng.random(n) < outlier_frac
    uv2[out] += rng.uniform(20, 120, size=(out.sum(), 2))
    mask = rng.random(n) < 0.9
    return (pts, uv1.astype(np.float32), uv2.astype(np.float32),
            mask)


def _samples(seed, n_hyp, size, count):
    return np.asarray(jr._sample_indices(jax.random.key(seed), n_hyp, size,
                                         jnp.asarray(count, jnp.int32)))


def _unit_f(f):
    f = f / np.linalg.norm(f, axis=(-2, -1), keepdims=True)
    return f * np.sign(f[..., 2:3, 2:3])


def test_sample_indices_stay_in_range_without_duplicates():
    g = torch.Generator().manual_seed(0)
    count = torch.tensor([5, 100, 1024, 0])
    s = pr.sample_indices(g, 64, 8, count)
    assert s.shape == (4, 64, 8)
    for i, c in enumerate(count.tolist()):
        assert int(s[i].min()) >= 0 and int(s[i].max()) < max(c, 1)
    dup = (s[1][:, :, None] == s[1][:, None, :]).sum((-1, -2)) - 8
    assert float(dup.float().mean()) < 0.5      # re-draws remove most clashes


def test_fundamental_equal_samples():
    fs, inl = [], []
    scenes = [make_scene(s) for s in range(3)]
    samples = []
    for seed, (_, uv1, uv2, m) in enumerate(scenes):
        smp = _samples(seed, 256, 8, m.sum())
        samples.append(smp)
        want = jr.fundamental_ransac(jnp.asarray(uv1), jnp.asarray(uv2),
                                     jnp.asarray(m), jax.random.key(seed),
                                     n_hyp=256, threshold=2.0)
        got = pr.fundamental_ransac(_t(uv1), _t(uv2), _t(m), n_hyp=256,
                                    threshold=2.0, samples=_t(smp))
        assert bool(got.valid) == bool(want.valid)
        np.testing.assert_array_equal(got.inliers.numpy(),
                                      np.asarray(want.inliers))
        assert int(got.n_inliers) == int(want.n_inliers)
        np.testing.assert_allclose(_unit_f(got.F.numpy()),
                                   _unit_f(np.asarray(want.F)), atol=TOL)
        fs.append(got.F)
        inl.append(got.inliers)
    # batched over the three scenes == one by one
    stack = lambda i: _t(np.stack([s[i] for s in scenes]))  # noqa: E731
    bat = pr.fundamental_ransac(stack(1), stack(2), stack(3), n_hyp=256,
                                threshold=2.0, samples=_t(np.stack(samples)))
    np.testing.assert_array_equal(bat.inliers.numpy(),
                                  torch.stack(inl).numpy())
    np.testing.assert_allclose(_unit_f(bat.F.numpy()),
                               _unit_f(torch.stack(fs).numpy()), atol=TOL)


@pytest.mark.parametrize("with_prior", [False, True])
def test_pnp_equal_samples(with_prior):
    pts, _, uv2, m = make_scene(7, outlier_frac=0.25)
    smp = _samples(3, 128, 6, m.sum())
    prior = {}
    if with_prior:
        prior = dict(prior_q=np.asarray(jlie.so3_exp(jnp.asarray(
                         [0.01, -0.02, 0.005], jnp.float32))),
                     prior_t=np.asarray([0.05, 0.0, -0.02], np.float32))
    want = jr.pnp_ransac(KJ, jnp.asarray(pts), jnp.asarray(uv2),
                         jnp.asarray(m), jax.random.key(3), n_hyp=128,
                         threshold=4.0, min_inliers=6, refine_iters=10,
                         **{k: jnp.asarray(v) for k, v in prior.items()})
    got = pr.pnp_ransac(KP, _t(pts), _t(uv2), _t(m), n_hyp=128, threshold=4.0,
                        min_inliers=6, refine_iters=10, samples=_t(smp),
                        **{k: _t(v) for k, v in prior.items()})
    assert bool(got.valid) and bool(want.valid)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers)
    np.testing.assert_allclose(got.q.numpy(), np.asarray(want.q), atol=TOL)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=TOL)


def test_pnp_degenerate_all_masked():
    pts, _, uv2, m = make_scene(8)
    got = pr.pnp_ransac(KP, _t(pts), _t(uv2), torch.zeros(len(m), dtype=bool),
                        n_hyp=32, generator=torch.Generator().manual_seed(0))
    assert not bool(got.valid)


def test_gauss_newton_refine_matches():
    pts, _, uv2, m = make_scene(9, outlier_frac=0.0)
    w = m.astype(np.float32)
    q0 = np.asarray(jlie.so3_exp(jnp.asarray([0.02, 0.0, -0.01], jnp.float32)))
    t0 = np.asarray([0.1, -0.05, 0.02], np.float32)
    want = jr._gauss_newton_refine(KJ, jnp.asarray(q0), jnp.asarray(t0),
                                   jnp.asarray(pts), jnp.asarray(uv2),
                                   jnp.asarray(w), 10)
    got = pr._gauss_newton_refine(KP, _t(q0), _t(t0), _t(pts), _t(uv2), _t(w),
                                  10)
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), atol=TOL)


def _spd(rng, n, batch):
    a = rng.normal(size=(batch, n, n)).astype(np.float32)
    return a @ np.swapaxes(a, -1, -2) + n * np.eye(n, dtype=np.float32)


def test_linalg_small_matches():
    rng = np.random.default_rng(10)
    m9 = _spd(rng, 9, 16)
    m9[:, :, 0] *= 1e-3                       # a clear smallest direction
    m9 = m9 @ np.swapaxes(m9, -1, -2)
    want = np.asarray(jls.smallest_eigvec(jnp.asarray(m9)))
    got = pls.smallest_eigvec(_t(m9)).numpy()
    sign = np.sign((got * want).sum(-1, keepdims=True))
    np.testing.assert_allclose(got * sign, want, atol=TOL)

    s3 = _spd(rng, 3, 32)
    for g, w in zip(pls.eigh3x3(_t(s3)), jls.eigh3x3(jnp.asarray(s3))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3,
                                   rtol=1e-4)
    # near-rotations, as the DLT hands them to Procrustes
    rot = np.asarray(jlie.rodrigues(jnp.asarray(rng.normal(size=(32, 3)),
                                                jnp.float32)))
    m3 = (1.5 * rot + 0.1 * rng.normal(size=(32, 3, 3))).astype(np.float32)
    np.testing.assert_allclose(pls.procrustes_rotation(_t(m3)).numpy(),
                               np.asarray(jls.procrustes_rotation(
                                   jnp.asarray(m3))), atol=TOL)
    a6 = _spd(rng, 6, 8)
    b6 = rng.normal(size=(8, 6)).astype(np.float32)
    np.testing.assert_allclose(
        pls.solve_psd(_t(a6), _t(b6), damping=1e-6, refine=1).numpy(),
        np.asarray(jls.solve_psd(jnp.asarray(a6), jnp.asarray(b6),
                                 damping=1e-6, refine=1)), atol=TOL)
