"""PyTorch port vs the JAX reference: the keyframe wire format,
``pipeline/wire.py``, on the CPU.

- ``encode`` of a keyframe block from the reference's tracker (frame 2 of
  a 160x120 sequence, carried across with ``convert.keyframe_block``):
  the port's bytes equal the reference's, byte for byte;
- each side's ``decode`` reads the other's bytes: every field equal
  (the bytes carry float32 as they are);
- truncation to a smaller capacity keeps the first observations; a bad
  magic is rejected.  No tolerance: the format is bytes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import to_numpy_tree

from dynamic_visual_slam_tpu.config import CameraConfig, SLAMConfig
from dynamic_visual_slam_tpu.frontend import tracker as jtr
from dynamic_visual_slam_tpu.io import synthetic
from dynamic_visual_slam_tpu.pipeline import wire as jwire
from dynamic_visual_slam_tpu_torch import convert
from dynamic_visual_slam_tpu_torch.pipeline import wire as pwire

torch.set_num_threads(2)
CAM = CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                   cx=79.5, cy=59.5)
CFG = SLAMConfig().replace(camera=CAM)
CAP = CFG.map.max_obs_per_keyframe


@pytest.fixture(scope="module")
def blocks():
    """The reference tracker's keyframe block of frame 2 (JAX), and the
    same block carried into the port."""
    step = jax.jit(lambda s, g, d, t: jtr.track_step(CFG, s, g, d, t))
    state = jtr.init_state(CFG)
    for gray, depth, _, _, ts in synthetic.generate_sequence(CAM, 3, seed=5):
        state, out = step(state, jnp.asarray(gray), jnp.asarray(depth),
                          jnp.asarray(ts, jnp.float32))
    jkf = out.keyframe
    assert 0 < int(jkf.mask.sum()) < CAP
    return jkf, convert.keyframe_block(to_numpy_tree(jkf))


def _assert_same(pkf, jkf):
    want = to_numpy_tree(jkf)
    for name, got in convert.to_numpy(pkf).items():
        np.testing.assert_array_equal(got, want[name], err_msg=name)


def test_encode_is_the_reference_bytes(blocks):
    jkf, pkf = blocks
    assert pwire.encode(pkf) == jwire.encode(jkf)


def test_decode_reads_the_other_side(blocks):
    jkf, pkf = blocks
    ref_bytes = jwire.encode(jkf)
    got = pwire.decode(ref_bytes, CAP, device="cpu")
    _assert_same(got, jwire.decode(ref_bytes, CAP))
    _assert_same(got, jwire.decode(pwire.encode(pkf), CAP))
    m = pkf.mask.numpy()
    n = int(m.sum())
    np.testing.assert_array_equal(got.uv.numpy()[:n], pkf.uv.numpy()[m])
    np.testing.assert_array_equal(got.desc_bits.numpy()[:n],
                                  pkf.desc_bits.numpy()[m])
    assert int(got.frame_idx) == int(pkf.frame_idx)


def test_truncation_to_capacity(blocks):
    jkf, pkf = blocks
    n = int(pkf.mask.sum())
    got = pwire.decode(pwire.encode(pkf), n // 2, device="cpu")
    _assert_same(got, jwire.decode(jwire.encode(jkf), n // 2))
    assert int(got.mask.sum()) == n // 2
    np.testing.assert_array_equal(got.xyz_w.numpy(),
                                  pkf.xyz_w.numpy()[pkf.mask.numpy()][:n // 2])


def test_bad_magic_rejected():
    with pytest.raises(ValueError, match="magic"):
        pwire.decode(b"\x00" * 64, capacity=8, device="cpu")
