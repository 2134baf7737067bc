"""The arithmetic of kernel B1's design (csrc/fast_score.cu), written here as
torch code, against the plain FAST score of the port
(``ops/fast.corner_score``) and of the JAX reference (``ops/fast.corner_score``).

The kernel cannot run on the CPU; this file proves its algebra where it can:
the arc reductions on the circle values (rounding is monotone, so
min_i fl(v_i - p) = fl(min_i v_i - p)) and OpenCV's cornerScore<16> form (one
8-window minimum serves two arcs, and the larger of their minima is
min(a, max(v[k], v[k+9]))).  Tolerance: none.  Scores are compared bit for
bit, as int32 views, after ``+ 0.0`` maps a negative zero to a positive one
(the only freedom min/max leave: IEEE min and max do not order the two
zeros).

Where every staged pixel of a tile is an integer in [0, 255] (every level of
the main path), the kernel scores two vertically adjacent pixels at once:
their circle values are packed as u16x2 words (``v + 2^23`` puts the integer
in the low bits; ``__byte_perm`` joins two), reduced with Hopper's
two-input ``min.s16x2`` / ``max.s16x2`` and the three-input DPX
``__vimin3_s16x2`` / ``__vimax3_s16x2`` (the same ``arc_extreme`` grouping,
its three-input steps issued as such), and the score is formed on the
packed words with ``max.s16x2`` and unpacked back to an exact float.
``packed_form`` repeats those bit operations in numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_visual_slam_tpu.ops import fast as jfast
from dynamic_visual_slam_tpu_torch.ops import fast as pfast
from dynamic_visual_slam_tpu_torch.ops.image import reflect_pad

torch.set_num_threads(2)


def _arc_extreme(v, lo, hi):
    """csrc/fast_score.cu ``arc_extreme``: lo = min, hi = max gives
    max_k min(arc k); lo = max, hi = min gives min_k max(arc k).  lo and hi
    take two or three arguments (the kernel's three-input steps)."""
    p = [lo(v[2 * i + 1], v[(2 * i + 2) % 16]) for i in range(8)]
    q = [lo(p[i], p[(i + 1) % 8]) for i in range(8)]        # v[2i+1 .. 2i+4]
    e = [lo(q[i], q[(i + 2) % 8], hi(v[2 * i], v[(2 * i + 9) % 16]))
         for i in range(8)]                                  # arcs 2i, 2i+1
    return hi(hi(e[0], e[1], e[2]), hi(e[3], e[4], e[5]), hi(e[6], e[7]))


def _fold(op):
    """op over two or three arguments, as two-input steps."""
    return lambda a, b, c=None: op(a, b) if c is None else op(op(a, b), c)


def kernel_form(img: torch.Tensor) -> torch.Tensor:
    """B1's score: M = max_k min(arc k), N = min_k max(arc k) on the circle
    values, score = max(fl(M - p), fl(p - N))."""
    h, w = img.shape[-2:]
    padded = reflect_pad(img, 3)
    v = [padded[..., 3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
         for dy, dx in pfast.CIRCLE_DYDX]
    lo, hi = _fold(torch.minimum), _fold(torch.maximum)
    m = _arc_extreme(v, lo, hi)
    n = _arc_extreme(v, hi, lo)
    return torch.maximum(m - img, img - n)


MAGIC = np.float32(2 ** 23)


def is_byte(v: np.ndarray) -> np.ndarray:
    """The check of csrc/fast_score.cu ``stage``, bit for bit: v + 2^23
    rounds v to an integer, and v is an integer in [0, 255] iff the bits
    exceed 2^23's by at most 255 and the rounding was exact."""
    v = v.astype(np.float32)
    bits = (v + MAGIC).view(np.uint32)
    return ((bits - np.uint32(0x4B000000)) <= np.uint32(255)) \
        & (((v + MAGIC) - MAGIC) == v)


def _byte_perm(x, y, sel):
    """CUDA ``__byte_perm``: byte i of the result is byte (sel >> 4i) & 7 of
    the 8-byte value (y << 32) | x."""
    xy = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros(np.broadcast(x, y).shape, np.uint64)
    for i in range(4):
        b = (sel >> (4 * i)) & 7
        out |= ((xy >> np.uint64(8 * b)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def _simd(op, *args):
    """``max.s16x2`` and the DPX ``__vimin3_s16x2`` / ``__vimax3_s16x2``: op
    over the arguments' signed 16-bit halves."""
    out = args[0].view(np.int16)
    for x in args[1:]:
        out = op(out, x.view(np.int16))
    return out.view(np.uint32)


def _unpack_score(w, half):
    """csrc/fast_score.cu ``unpack_score``: (score + 256) in a 16-bit half
    back to the float score."""
    f = _byte_perm(w, np.uint32(0x4B000000), 0x7632 if half else 0x7610)
    return f.view(np.float32) - np.float32(2 ** 23 + 256)


def packed_form(img: np.ndarray) -> np.ndarray:
    """B1's packed branch on a byte image (B, H, W), H even: rows y and
    y + 1 (y even) share every instruction, the score's subtractions
    included: max(M - c, c - N) + 256 in each half, from one 32-bit
    subtraction a side (the bias 256 keeps each half in [1, 511], so no
    borrow crosses between them)."""
    b, h, w = img.shape
    padded = reflect_pad(torch.from_numpy(img), 3).numpy()
    bits = (padded + MAGIC).view(np.uint32)

    def words(dy, dx):
        """rows 2j and 2j + 1 of the plane at offset (dy, dx), packed"""
        plane = bits[:, 3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
        return np.ascontiguousarray(
            _byte_perm(plane[:, 0::2], plane[:, 1::2], 0x5410))

    circle = [words(dy, dx) for dy, dx in pfast.CIRCLE_DYDX]
    lo = lambda *a: _simd(np.minimum, *a)  # noqa: E731
    hi = lambda *a: _simd(np.maximum, *a)  # noqa: E731
    m = _arc_extreme(circle, lo, hi)
    n = _arc_extreme(circle, hi, lo)
    c = words(0, 0)
    bias = np.uint32(0x01000100)
    sc = _simd(np.maximum, (m | bias) - c, (c | bias) - n)
    out = np.empty_like(img)
    for half in (0, 1):
        out[:, half::2] = _unpack_score(sc, half)
    return out


def _bits(x) -> np.ndarray:
    return (np.asarray(x, np.float32) + np.float32(0.0)).view(np.int32)


def _assert_bit_equal(img: np.ndarray) -> None:
    got = kernel_form(torch.from_numpy(img))
    want_port = pfast.corner_score(torch.from_numpy(img))
    want_ref = jax.vmap(jfast.corner_score)(jnp.asarray(img)) \
        if img.ndim == 3 else jfast.corner_score(jnp.asarray(img))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want_port.numpy()))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want_ref))


@pytest.mark.parametrize("shape", [(2, 7, 9), (3, 48, 64), (1, 120, 160)])
def test_kernel_form_on_integer_images(shape):
    rng = np.random.default_rng(shape[1])
    _assert_bit_equal(rng.integers(0, 256, shape).astype(np.float32))


@pytest.mark.parametrize("shape", [(2, 7, 9), (3, 48, 64), (1, 120, 160)])
def test_kernel_form_on_fractional_images(shape):
    rng = np.random.default_rng(shape[2])
    img = rng.integers(0, 256, shape) + rng.random(shape)
    _assert_bit_equal(img.astype(np.float32))


def test_kernel_form_on_smooth_and_flat_images():
    """Ties everywhere: a flat image (every score 0) and a slow ramp."""
    flat = np.full((1, 16, 20), 77.0, np.float32)
    yy, xx = np.mgrid[0:40, 0:50]
    ramp = ((yy + 2 * xx) // 5).astype(np.float32)[None]
    _assert_bit_equal(flat)
    _assert_bit_equal(ramp)


@pytest.mark.parametrize("magnitudes", ["ramp", "shuffled", "equal"])
def test_kernel_form_on_every_circle_pattern(magnitudes):
    """All 2^16 bright/dark patterns of the 16-circle around one centre
    pixel (value 128): circle pixel i is 128 + m_i where bit i of the
    pattern is set, else 128 - m_i; scored at the centre of a 7x7 image,
    whose circle lies inside it."""
    if magnitudes == "ramp":
        m = 5 + 7 * np.arange(16)
    elif magnitudes == "shuffled":
        m = np.random.default_rng(16).permutation(5 + 7 * np.arange(16))
    else:
        m = np.full(16, 40)
    patterns = np.arange(1 << 16)
    sign = np.where((patterns[:, None] >> np.arange(16)) & 1, 1, -1)
    img = np.full((1 << 16, 7, 7), 128.0, np.float32)
    for i, (dy, dx) in enumerate(pfast.CIRCLE_DYDX):
        img[:, 3 + dy, 3 + dx] = 128 + sign[:, i] * m[i]
    got = kernel_form(torch.from_numpy(img))[:, 3, 3]
    want = pfast.corner_score(torch.from_numpy(img))[:, 3, 3]
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))
    # the centre's score is a FAST-9 threshold: some patterns are corners
    assert int((want > 0).sum()) > 0


@pytest.mark.parametrize("shape", [(2, 8, 9), (3, 48, 64), (1, 120, 160)])
def test_packed_form_on_byte_images(shape):
    rng = np.random.default_rng(shape[1] + 1)
    img = rng.integers(0, 256, shape).astype(np.float32)
    assert is_byte(img).all()
    want = pfast.corner_score(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(_bits(packed_form(img)), _bits(want))


def test_packed_form_on_every_circle_pattern():
    """The 2^16 patterns of test_kernel_form_on_every_circle_pattern
    (ramp magnitudes) in one 8x7 image a pattern, mirrored about its
    centre rows 3 and 4: those two pixels share every packed word."""
    m = 5 + 7 * np.arange(16)
    patterns = np.arange(1 << 16)
    sign = np.where((patterns[:, None] >> np.arange(16)) & 1, 1, -1)
    img = np.full((1 << 16, 8, 7), 128.0, np.float32)
    for i, (dy, dx) in enumerate(pfast.CIRCLE_DYDX):
        img[:, 3 + dy, 3 + dx] = 128 + sign[:, i] * m[i]
        img[:, 4 + dy, 3 + dx] = 128 - sign[:, i] * m[i]
    img[:, 4, 3] = 131.0
    want = pfast.corner_score(torch.from_numpy(img)).numpy()[:, 3:5, 3]
    got = packed_form(img)[:, 3:5, 3]
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_is_byte_selects_the_packed_branch():
    v = np.array([0.0, -0.0, 1.0, 254.0, 255.0, 255.5, 256.0, -1.0, 0.5,
                  1e-30, np.nan, np.inf, 2 ** 23 + 1.0], np.float32)
    assert is_byte(v).tolist() == [True, True, True, True, True, False,
                                   False, False, False, False, False, False,
                                   False]
