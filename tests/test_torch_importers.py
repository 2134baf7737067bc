"""PyTorch port vs the JAX reference: the asset importers
(models/convert_ultralytics, place/bow.load_orbvoc_text), the YOLOv8
parameter tree (yolov8.init_params, convert.yolo_params) and the detector's
weight sources (.pt, npz, random initialisation), on the CPU.

Tolerances: none.  ``convert`` of an ultralytics-layout checkpoint built
here (tests/test_importers.py's module tree, seeded random weights and
BatchNorm statistics) equals the reference's leaf for leaf; each package
reads the other's ``save_params`` file bit for bit; a detector loaded from
the ``.pt`` equals one given the converted tree; ``load_orbvoc_text`` gives
the reference's levels, valid masks and word weights, and the same words.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_importers import _build_fake_ultralytics, _write_orbvoc

from dynamic_visual_slam_tpu.models import convert_ultralytics as jcu
from dynamic_visual_slam_tpu.models import yolov8 as jy
from dynamic_visual_slam_tpu.place import bow as jbow
from dynamic_visual_slam_tpu_torch import convert
from dynamic_visual_slam_tpu_torch.config import SLAMConfig
from dynamic_visual_slam_tpu_torch.io import synthetic
from dynamic_visual_slam_tpu_torch.models import convert_ultralytics as pcu
from dynamic_visual_slam_tpu_torch.models import yolov8 as py
from dynamic_visual_slam_tpu_torch.place import bow as pbow
from dynamic_visual_slam_tpu_torch.semantic.detector import YoloDetector

torch.set_num_threads(2)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _assert_trees_equal(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_array_equal(np.asarray(g[k], np.float32),
                                      np.asarray(w[k], np.float32), err_msg=k)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("pt") / "fake_yolov8n.pt"
    fake = _build_fake_ultralytics(jy.init_params(jax.random.key(0)))
    torch.save({"model": fake}, path)
    return str(path)


def test_convert_matches_reference(checkpoint):
    got = pcu.convert(checkpoint)
    want = jcu.convert(checkpoint)
    assert got["num_classes"] == want["num_classes"] == 80
    for _, leaf in _leaves(got):
        if isinstance(leaf, np.ndarray):
            assert leaf.dtype == np.float32
    _assert_trees_equal(got, want)
    assert np.abs(got["stem"]["b"]).max() > 0       # BatchNorm folded in


def test_save_params_crosses_both_ways(checkpoint, tmp_path):
    params = pcu.convert(checkpoint)
    pcu.save_params(dict(params, input_size=128), str(tmp_path / "p.npz"))
    jcu.save_params(jcu.convert(checkpoint), str(tmp_path / "j.npz"))
    from_port = jcu.load_params(str(tmp_path / "p.npz"))
    assert int(np.asarray(from_port["input_size"], np.float32)) == 128
    from_port.pop("input_size")
    _assert_trees_equal(from_port, params)
    _assert_trees_equal(pcu.load_params(str(tmp_path / "j.npz")), params)
    back = pcu.load_params(str(tmp_path / "p.npz"))
    assert int(back.pop("input_size")) == 128
    _assert_trees_equal(back, params)


def test_pt_detector_equals_converted_tree(checkpoint):
    base = SLAMConfig()
    cam = base.camera.scaled(320, 240)
    cfg = base.replace(camera=cam, semantic=dataclasses.replace(
        base.semantic, input_size=128))
    from_pt = YoloDetector(cfg, weights_path=checkpoint, device="cpu")
    from_tree = YoloDetector(cfg, params=pcu.convert(checkpoint),
                             device="cpu")
    assert from_pt.size == from_tree.size == 128
    n = 0
    for g, *_ in synthetic.generate_dynamic_sequence(cam, 3, seed=0):
        rgb = np.stack([g] * 3, -1).astype(np.uint8)
        a, b = from_pt(rgb), from_tree(rgb)
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
        n += int(a.mask.sum())
    print(f".pt detector: {n} detections over 3 frames")


def test_init_params_tree_and_statistics():
    want = jy.init_params(jax.random.key(0))
    got = py.init_params(torch.Generator().manual_seed(0))
    w, g = dict(_leaves(want)), dict(_leaves(got))
    assert g.keys() == w.keys() and got["num_classes"] == 80
    for k, v in w.items():
        if k == "/num_classes":
            continue
        assert g[k].shape == v.shape and g[k].dtype == np.float32, k
        np.testing.assert_array_equal(g[k], pcu.round_bf16(g[k]))
        if k.endswith("/b"):
            assert not g[k].any()
    w3 = got["heads"][0]["cls2"]["w"]         # 3x3, 80 in: fan_in 720
    assert abs(float(w3.std()) - (2.0 / 720) ** 0.5) < 0.002
    again = py.init_params(torch.Generator().manual_seed(0))
    _assert_trees_equal(again, got)
    model = py.YOLOv8()
    model.load_state_dict(convert.yolo_state_dict(got))
    _assert_trees_equal(convert.yolo_params(model.state_dict()), got)


def test_random_init_detector_runs():
    """No weights: the reference's random initialisation from ``seed``;
    the whole path runs (its boxes are meaningless)."""
    base = SLAMConfig()
    cfg = base.replace(semantic=dataclasses.replace(base.semantic,
                                                    input_size=64))
    det = YoloDetector(cfg, device="cpu")
    other = YoloDetector(cfg, seed=1, device="cpu")
    assert det.size == 64
    assert not torch.equal(det.model.stem.w, other.model.stem.w)
    rgb = np.random.default_rng(0).integers(0, 255, (120, 160, 3),
                                            dtype=np.uint8)
    d = det(rgb)
    assert d.boxes.shape == (cfg.semantic.max_detections, 4)
    assert torch.isfinite(d.boxes).all()


def test_orbvoc_text_matches_reference(tmp_path):
    path = tmp_path / "ORBvoc_tiny.txt"
    _write_orbvoc(path)
    want = jbow.load_orbvoc_text(str(path))
    got = pbow.load_orbvoc_text(str(path), device="cpu")
    assert (got.k, got.depth, got.n_words) == (want.k, want.depth, 8)
    for a, b in zip(got.levels, want.levels):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(got.valid, want.valid):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got.word_weights.numpy(),
                                  np.asarray(want.word_weights))
    assert got.word_weights.dtype == torch.float32
    desc = np.random.default_rng(0).integers(0, 2, (4096, 256),
                                             dtype=np.uint8)
    words = pbow.descend(got, torch.from_numpy(desc)).numpy()
    np.testing.assert_array_equal(
        words, np.asarray(jbow.descend(want, jax.numpy.asarray(desc))))
    assert len(np.unique(words)) >= 4


def test_orbvoc_text_defaults_to_the_card(tmp_path, monkeypatch):
    path = tmp_path / "ORBvoc_tiny.txt"
    _write_orbvoc(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        pbow.load_orbvoc_text(str(path))
