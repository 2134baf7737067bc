"""PyTorch port vs the JAX reference: ops/image, ops/fast (plain version of
kernels B1 and B3), ops/fields, ops/descriptors (plain version of kernel
B2), ops/hamming and frontend/orb, on synthetic 320x240 frames made from a
seed.

Tolerances, and why:
- pyramid levels: exact.  The reference's jitted XLA program contracts the
  bilinear resize into fused multiply-adds on an x86 host with FMA3 (every
  x86 host this test has run on has it), and the port forms the same ones
  (ops/image.resize_bilinear); before it did, 34 of the 951,040 level
  pixels of this fixture sat one off.
- rounded blurs: the reference's banded f32 matmul sums in Eigen's blocked
  order, and the rounding after it can move a pixel on a .5 boundary by
  one.  Mismatches are counted and printed; at most 1e-4 of the pixels,
  each off by exactly 1.
- FAST scores, detections, keypoint sets fed the same levels: exact;
  ``corner_score_auto`` (kernel B3's wrapper, plain path on the CPU) equals
  the reference's (its XLA path off the TPU) bit for bit on integer and
  fractional images, odd shapes included;
- ``extract`` of one frame from its own pyramid: keypoint sets exact on
  this frame; the pyramid pixels off by one (above) move some IC moments,
  so angles agree within 1e-5 rad except on at most 2 % of the keypoints
  (within 5e-3 rad there), and descriptor bits within the same 1e-3 as
  below;
- IC moments: exact (integer sums below 2^24).  Angles: 1e-5 rad (atan2 of
  the same moments in two libraries).  Descriptor bits: >= 99.9 % equal —
  the reference's CPU path rotates the pattern by cos/sin(atan2(m01, m10)),
  the port (like the reference's TPU kernel) by m10/|m|, m01/|m|, which can
  flip a rounded sample offset; the flip count is printed.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_visual_slam_tpu.config import CameraConfig, ORBConfig
from dynamic_visual_slam_tpu.frontend import orb as jorb
from dynamic_visual_slam_tpu.io import synthetic
from dynamic_visual_slam_tpu.ops import fast as jfast
from dynamic_visual_slam_tpu.ops import hamming as jham
from dynamic_visual_slam_tpu.ops import image as jim
from dynamic_visual_slam_tpu_torch.config import ORBConfig as PORBConfig
from dynamic_visual_slam_tpu_torch.frontend import orb as porb
from dynamic_visual_slam_tpu_torch.ops import descriptors as pdesc
from dynamic_visual_slam_tpu_torch.ops import fast as pfast
from dynamic_visual_slam_tpu_torch.ops import fields as pfields
from dynamic_visual_slam_tpu_torch.ops import hamming as pham
from dynamic_visual_slam_tpu_torch.ops import image as pim

torch.set_num_threads(2)
CAM = CameraConfig(width=320, height=240, fx=260.0, fy=260.0,
                   cx=159.5, cy=119.5)
CFG = ORBConfig()
PCFG = PORBConfig()


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def frames():
    seq = synthetic.generate_sequence(CAM, 4, seed=11, depth_noise=0.004)
    return np.stack([g for g, *_ in seq]).astype(np.float32)


@pytest.fixture(scope="module")
def jax_levels(frames):
    """The reference's pyramid as its jitted extract_batch builds it."""
    fn = jax.jit(jax.vmap(lambda im: jim.build_pyramid(im, CFG.n_levels,
                                                       CFG.scale_factor)))
    return [np.asarray(lv) for lv in fn(jnp.asarray(frames))]


@pytest.fixture(scope="module")
def jax_keypoints(frames):
    return jax.jit(lambda x: jorb.extract_batch(x, CFG))(jnp.asarray(frames))


def _count_off_by_one(got, want, what):
    diff = np.abs(got - want)
    n_bad = int((diff != 0).sum())
    print(f"{what}: {n_bad} of {want.size} pixels differ, max {diff.max()}")
    assert n_bad <= 1e-4 * want.size, (what, n_bad)
    assert diff.max() <= 1.0, (what, diff.max())


def test_pyramid_mismatches_counted(frames, jax_levels):
    """Every level pixel equal to the reference's jitted pyramid.  The
    reference's fused multiply-adds (ops/image.resize_bilinear) need a host
    with FMA3, as every x86 host of this suite has."""
    got = pim.build_pyramid(_t(frames), CFG.n_levels, CFG.scale_factor)
    assert [tuple(g.shape) for g in got] == [lv.shape for lv in jax_levels]
    got = np.concatenate([g.numpy().ravel() for g in got])
    want = np.concatenate([lv.ravel() for lv in jax_levels])
    n_bad = int((got != want).sum())
    print(f"pyramid: {n_bad} of {want.size} pixels differ")
    assert n_bad == 0


def test_rounded_blur_mismatches_counted(jax_levels):
    blur = jax.jit(jax.vmap(lambda im: jnp.clip(
        jnp.round(jim.gaussian_blur(im, 7, 2.0)), 0.0, 255.0)))
    got, want = [], []
    for lv in jax_levels:
        want.append(np.asarray(blur(jnp.asarray(lv))).ravel())
        got.append(torch.clamp(torch.round(pim.gaussian_blur(_t(lv), 7, 2.0)),
                               0.0, 255.0).numpy().ravel())
    _count_off_by_one(np.concatenate(got), np.concatenate(want), "blur")


def test_image_helpers_exact():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (2, 37, 53)).astype(np.float32)
    np.testing.assert_array_equal(pim.reflect_pad(_t(x), 5).numpy(),
                                  np.asarray(jax.vmap(
                                      lambda im: jim.reflect_pad(im, 5))(x)))
    np.testing.assert_array_equal(pim.maxpool_same(_t(x)).numpy(),
                                  np.asarray(jax.vmap(jim.maxpool_same)(x)))
    cells = pim.cell_reduce_max(_t(x), 7)
    np.testing.assert_array_equal(
        cells.numpy(), np.asarray(jax.vmap(lambda im: jim.cell_reduce_max(
            im, 7))(x)))
    np.testing.assert_array_equal(
        pim.cell_broadcast(cells, 7, 37, 53).numpy(),
        np.asarray(jax.vmap(lambda c: jim.cell_broadcast(c, 7, 37, 53))(
            np.asarray(cells))))
    assert pim.pyramid_shapes(720, 1280, 8, 1.2) == \
        jim.pyramid_shapes(720, 1280, 8, 1.2)


def test_corner_score_exact_on_reference_levels(jax_levels):
    scores = pfields.fast_score_batch([_t(lv) for lv in jax_levels])
    for lv, got in zip(jax_levels, scores):
        want = np.asarray(jax.vmap(jfast.corner_score)(lv))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(pfast.corner_score(_t(lv)).numpy(), want)


def test_corner_score_threshold_semantics_match_opencv(frames):
    u8 = frames[0].astype(np.uint8)
    score = pfast.corner_score(_t(u8.astype(np.float32))).numpy()
    for t in (7, 20, 40):
        det = cv2.FastFeatureDetector_create(threshold=t,
                                             nonmaxSuppression=False)
        cv_mask = np.zeros(u8.shape, bool)
        for k in det.detect(u8):
            cv_mask[int(k.pt[1]), int(k.pt[0])] = True
        agree = ((score > t) == cv_mask)[3:-3, 3:-3].mean()
        assert agree == 1.0, (t, agree)


@pytest.mark.parametrize("level", [0, 3, 7])
def test_detect_level_exact(jax_levels, level):
    quota = jorb.features_per_level(CFG)[level]
    s = jax.vmap(jfast.corner_score)(jax_levels[level])
    want = jax.jit(jax.vmap(lambda x: jorb.detect_level(
        x, quota, float(CFG.ini_th_fast), float(CFG.min_th_fast))))(s)
    got = porb.detect_level(_t(s), quota, float(CFG.ini_th_fast),
                            float(CFG.min_th_fast))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_tables_equal_reference():
    np.testing.assert_array_equal(porb.ic_umax(), jorb.ic_umax())
    np.testing.assert_array_equal(porb.brief_pattern(), jorb.brief_pattern())
    assert porb.features_per_level(PCFG) == jorb.features_per_level(CFG)


def test_extract_levels_matches_reference(jax_levels, jax_keypoints):
    """extract_batch fed the reference's own levels: keypoint sets exact."""
    got = porb.extract_levels([_t(lv) for lv in jax_levels], PCFG)
    want = jax_keypoints
    for name in ("uv", "octave", "response", "mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    m = np.asarray(want.mask)
    assert m.sum() > 3000
    np.testing.assert_allclose(got.angle.numpy()[m], np.asarray(want.angle)[m],
                               atol=1e-5)
    flips = int((got.desc_bits.numpy()[m] != np.asarray(want.desc_bits)[m]).sum())
    print(f"descriptor bit flips: {flips} of {m.sum() * 256}")
    assert flips <= 1e-3 * m.sum() * 256
    np.testing.assert_array_equal(got.desc_packed.numpy(),
                                  pham.pack_bits(got.desc_bits).numpy())


def test_descriptors_plain_vs_reference(jax_levels):
    """Plain B2 vs the reference's compute_descriptors / moment_maps on the
    same levels and keypoints."""
    levels = [_t(lv) for lv in jax_levels]
    slots, inputs = porb.detect_batch(levels, pfields.fast_score_batch(levels),
                                      PCFG)
    bits, m10, m01 = pdesc.descriptors_moments_plain(*inputs)
    b, k = slots["mask"].shape
    lvl = inputs.level.numpy().reshape(b, k)
    ys, xs = inputs.ys.numpy().reshape(b, k), inputs.xs.numpy().reshape(b, k)
    mask = slots["mask"].numpy()
    got_bits = bits.numpy().reshape(b, k, 256)
    flips = total = 0
    for f in range(b):
        for l, lv in enumerate(jax_levels):
            sel = mask[f] & (lvl[f] == l)
            if not sel.any():
                continue
            img = jnp.asarray(lv[f])
            jm10, jm01 = jorb.moment_maps(img)
            y, x = jnp.asarray(ys[f][sel]), jnp.asarray(xs[f][sel])
            np.testing.assert_array_equal(
                m10.numpy().reshape(b, k)[f][sel], np.asarray(jm10[y, x]))
            np.testing.assert_array_equal(
                m01.numpy().reshape(b, k)[f][sel], np.asarray(jm01[y, x]))
            ang = jorb.angles_from_maps(jm10, jm01, y, x)
            blurred = jnp.clip(jnp.round(jim.gaussian_blur(img, 7, 2.0)), 0, 255)
            want = np.asarray(jorb.compute_descriptors(
                jim.reflect_pad(blurred, jorb.SAMPLE_PAD), y, x, ang))
            flips += int((got_bits[f][sel] != want).sum())
            total += want.size
    print(f"plain B2 vs reference: {flips} bit flips of {total}")
    assert total > 100000
    assert flips <= 1e-3 * total


def test_descriptor_wrapper_checks_inputs(jax_levels):
    levels = [_t(lv) for lv in jax_levels]
    _, inputs = porb.detect_batch(levels, pfields.fast_score_batch(levels),
                                  PCFG)
    with pytest.raises(ValueError):
        pdesc.descriptors_moments(inputs.blur, inputs.raw,
                                  inputs.level.long(), *inputs[3:])
    with pytest.raises(ValueError):
        pdesc.descriptors_moments([t.double() for t in inputs.blur],
                                  inputs.raw, *inputs[2:])
    with pytest.raises(ValueError):
        pfields.fast_score_batch([levels[0][:, :, ::2]])


def test_hamming_exact():
    rng = np.random.default_rng(2)
    train = rng.integers(0, 2, (64, 256)).astype(np.uint8)
    query = train ^ (rng.random((64, 256)) < 0.1).astype(np.uint8)
    qm = rng.random(64) < 0.9
    tm = rng.random(64) < 0.9
    np.testing.assert_array_equal(
        pham.hamming_matrix(_t(query), _t(train)).numpy(),
        np.asarray(jham.hamming_matrix(query, train)))
    packed = np.asarray(jham.pack_bits(jnp.asarray(query)))
    np.testing.assert_array_equal(pham.pack_bits(_t(query)).numpy(), packed)
    np.testing.assert_array_equal(pham.unpack_bits(_t(packed)).numpy(), query)
    for cc in (False, True):
        want = jham.match(jnp.asarray(query), jnp.asarray(train),
                          jnp.asarray(qm), jnp.asarray(tm), 50.0,
                          cross_check=cc)
        got = pham.match(_t(query), _t(train), _t(qm), _t(tm), 50.0,
                         cross_check=cc)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("shape", [(7, 9), (120, 160), (479, 641)])
@pytest.mark.parametrize("fractional", [False, True])
def test_corner_score_auto_exact(shape, fractional):
    rng = np.random.default_rng(shape[0] + 10 * fractional)
    img = rng.integers(0, 256, shape).astype(np.float32)
    if fractional:
        img = img + rng.random(shape).astype(np.float32)
    got = pfast.corner_score_auto(_t(img))
    want = np.asarray(jfast.corner_score_auto(jnp.asarray(img)))
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_array_equal(got.numpy(), want)
    # a uint8 image is scored as float32, as in the reference
    np.testing.assert_array_equal(
        pfast.corner_score_auto(_t(img.astype(np.uint8))).numpy(),
        np.asarray(jfast.corner_score_auto(jnp.asarray(img.astype(np.uint8)))))


def test_corner_score_auto_checks_its_input():
    with pytest.raises(ValueError):
        pfast.corner_score_auto(torch.zeros((2, 8, 8)))
    with pytest.raises(ValueError, match="unsupported device"):
        pfast.corner_score_auto(torch.zeros((8, 8), device="meta"))


def test_extract_one_frame_matches_reference(frames):
    got = porb.extract(_t(frames[1]), PCFG)
    want = jax.jit(lambda x: jorb.extract(x, CFG))(jnp.asarray(frames[1]))
    for name in ("uv", "octave", "response", "mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    m = np.asarray(want.mask)
    assert m.sum() > 700
    dang = np.abs(got.angle.numpy()[m] - np.asarray(want.angle)[m])
    dang = np.minimum(dang, 2 * np.pi - dang)
    flips = int((got.desc_bits.numpy()[m]
                 != np.asarray(want.desc_bits)[m]).sum())
    print(f"extract (one frame): {int((dang > 1e-5).sum())} of {m.sum()} "
          f"angles off by up to {dang.max():.2e} rad; descriptor bit flips "
          f"{flips} of {m.sum() * 256}")
    assert (dang > 1e-5).sum() <= 0.02 * m.sum() and dang.max() < 5e-3
    assert flips <= 1e-3 * m.sum() * 256
    batch = porb.extract_batch(_t(frames[1:2]), PCFG)
    for a, b in zip(got, batch):
        assert torch.equal(a, b[0])
