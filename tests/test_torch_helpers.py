"""The port's small public helpers against the reference package's on the
same inputs: ``io/trajectory.rpe_rmse`` (float64, equal), the optical↔ROS
basis change and ``se3_apply`` of ``core/lie`` (float32, within 1e-6),
``ops/image.to_gray`` (float32, within one unit in the last place: the
reference's compiled sum may contract a multiply-add),
``semantic/classes.category_name`` and ``models/yolov8.yolov8n_spec``
(equal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_visual_slam_tpu.core import lie as jlie
from dynamic_visual_slam_tpu.io import trajectory as jtraj
from dynamic_visual_slam_tpu.models import yolov8 as jyolo
from dynamic_visual_slam_tpu.ops import image as jimage
from dynamic_visual_slam_tpu.semantic import classes as jclasses
from dynamic_visual_slam_tpu_torch.core import lie
from dynamic_visual_slam_tpu_torch.io import trajectory
from dynamic_visual_slam_tpu_torch.models import yolov8
from dynamic_visual_slam_tpu_torch.ops import image
from dynamic_visual_slam_tpu_torch.semantic import classes

RNG = np.random.default_rng(12)


@pytest.mark.parametrize("delta", [1, 3])
def test_rpe_rmse(delta):
    est = RNG.normal(size=(40, 3))
    gt = est + RNG.normal(scale=0.01, size=(40, 3))
    assert trajectory.rpe_rmse(est, gt, delta) == jtraj.rpe_rmse(est, gt,
                                                                 delta)


def _rotations(n):
    q = RNG.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.mark.parametrize("name", ["se3_apply", "optical_to_ros_point",
                                  "optical_to_ros_rotation"])
def test_lie_helpers(name):
    q = _rotations(16)
    t = RNG.normal(size=(16, 3)).astype(np.float32)
    x = RNG.normal(size=(16, 3)).astype(np.float32)
    r = np.array(jlie.quat_to_mat(jnp.asarray(q)))
    args = {"se3_apply": (q, t, x), "optical_to_ros_point": (x,),
            "optical_to_ros_rotation": (r,)}[name]
    got = getattr(lie, name)(*(torch.from_numpy(a) for a in args)).numpy()
    want = np.asarray(getattr(jlie, name)(*(jnp.asarray(a) for a in args)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_to_gray(dtype):
    rgb = RNG.integers(0, 256, (48, 64, 3)).astype(dtype)
    got = image.to_gray(torch.from_numpy(rgb)).numpy()
    want = np.asarray(jimage.to_gray(jnp.asarray(rgb)))
    assert got.dtype == want.dtype == np.float32 and got.shape == (48, 64)
    np.testing.assert_allclose(got, want, rtol=1.2e-7, atol=0)


def test_category_name():
    assert [classes.category_name(i) for i in range(classes.num_categories())
            ] == [jclasses.category_name(i)
                  for i in range(jclasses.num_categories())]
    assert classes.category_name(0) == "unlabeled"
    assert classes.category_name(classes.category_id("person")) == "person"


def test_yolov8n_spec():
    assert yolov8.yolov8n_spec() == jyolo.yolov8n_spec()
    spec = yolov8.yolov8n_spec()
    assert tuple(spec["channels"]) == yolov8.CHANNELS
    assert (spec["n1"], spec["n2"]) == yolov8.DEPTHS
