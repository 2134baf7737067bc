"""PyTorch port vs the JAX reference: semantic/detector — the letterbox,
the host post-processing (box margin, velocity-extrapolated box tracks),
boxes_to_detections and GTDetector.

Tolerances, and why:
- letterbox: 1e-5.  The port builds jax.image.resize's two antialiased
  bilinear weight matrices in float32 and contracts with them, in another
  summation order.
- post-processing and box tracks: exact (the same numpy code on the same
  scripted raw detections, 30 frames with misses, a second class and a
  track that expires).
- boxes_to_detections and GTDetector: exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_visual_slam_tpu.config import SLAMConfig
from dynamic_visual_slam_tpu.semantic import detector as jdet
from dynamic_visual_slam_tpu_torch.config import SLAMConfig as PSLAMConfig
from dynamic_visual_slam_tpu_torch.semantic import detector as pdet

torch.set_num_threads(2)


def _shim(cls, cfg, **kw):
    """A detector without its network: letterbox and the post-processing
    read only the config, the size and the state they create."""
    d = object.__new__(cls)
    d.cfg = cfg
    d._recent = []
    for k, v in kw.items():
        setattr(d, k, v)
    return d


@pytest.mark.parametrize("hw", [(240, 320), (720, 1280)])
def test_letterbox_matches_reference(hw):
    rgb = np.random.default_rng(hw[0]).integers(0, 256, hw + (3,),
                                                dtype=np.uint8)
    ref = _shim(jdet.YoloDetector, SLAMConfig(), size=640)
    want, wscale, wpad = ref.letterbox(rgb)
    got, scale, pad = pdet.letterbox(rgb, 640, "cpu")
    assert (scale, pad) == (wscale, wpad)
    assert got.shape == (640, 640, 3) and got.dtype == torch.float32
    err = np.abs(got.numpy() - np.asarray(want)).max()
    print(f"letterbox {hw} -> 640: max difference {err:.3g}")
    assert err <= 1e-5


def _script(n_frames=30, cap=32):
    """Raw detections a frame: two walkers moving apart (class 1), a car
    (class 3) seen for a while; misses of 1 to 6 frames; boxes past the
    frame edge; an invalid row between valid ones."""
    rng = np.random.default_rng(7)
    for f in range(n_frames):
        boxes = np.zeros((cap, 4), np.float32)
        cat = np.zeros(cap, np.int32)
        score = np.zeros(cap, np.float32)
        valid = np.zeros(cap, bool)
        rows = []
        if f % 7 not in (3, 4):
            rows.append(([20 + 4 * f, 30, 70 + 4 * f, 140], 1))
        if f < 8 or f > 14:
            rows.append(([300 - 3 * f, 40 + f, 360 - 3 * f, 170 + f], 1))
        if 5 <= f < 12 and f != 9:
            rows.append(([200, 150, 260, 230], 3))
        if f == 20:
            rows.append(([390, 200, 440, 260], 1))     # past the right edge
        for i, (b, c) in enumerate(rows):
            j = 2 * i                                  # invalid rows between
            boxes[j] = np.asarray(b, np.float32) + rng.normal(
                0, 0.7, 4).astype(np.float32)
            cat[j] = c
            score[j] = 0.5 + 0.4 * rng.random()
            valid[j] = True
        yield boxes, cat, score, valid


@pytest.mark.parametrize("tracks", [True, False])
def test_postprocess_and_tracks_match_reference(tracks):
    base = SLAMConfig()
    sem = dict(track_ttl_frames=12) if tracks else dict(
        track_ttl_frames=0, persist_frames=3)
    cfg = base.replace(semantic=dataclasses.replace(base.semantic, **sem))
    pcfg = PSLAMConfig.from_dict(cfg.to_dict())
    ref = _shim(jdet.YoloDetector, cfg)
    port = _shim(pdet.YoloDetector, pcfg, device=torch.device("cpu"))
    served = 0
    for boxes, cat, score, valid in _script():
        want = ref._postprocess(boxes, cat, score, valid, (240, 424))
        got = port._postprocess(boxes, cat, score, valid, (240, 424))
        for name in ("boxes", "category", "score", "mask"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)),
                                          name)
        served += int(got.mask.sum())
    assert served > 40
    if tracks:
        assert len(port._tracks) == len(ref._tracks)
        for a, b in zip(port._tracks, ref._tracks):
            np.testing.assert_array_equal(a["box"], b["box"])
            np.testing.assert_array_equal(a["vel"], b["vel"])
            assert (a["cat"], a["age"], a["score"]) == \
                (b["cat"], b["age"], b["score"])


def test_boxes_to_detections_and_gt_detector_match_reference():
    boxes = np.asarray([[1.0, 2.0, 30.0, 40.0], [5.5, 6.0, 70.25, 90.0]],
                       np.float32)
    for cap in (1, 8):
        want = jdet.boxes_to_detections(boxes, cap)
        got = pdet.boxes_to_detections(boxes, cap, device="cpu")
        for name in ("boxes", "category", "score", "mask"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))
        assert got.category.dtype == torch.int64
    cfg = SLAMConfig()
    ref, port = jdet.GTDetector(cfg), pdet.GTDetector(
        PSLAMConfig(), device="cpu")
    for d in (ref, port):
        d.record(0.5, boxes)
    rgb = np.zeros((120, 160, 3), np.uint8)
    for stamp in (0.5, 0.5000001, 0.6, None):
        want = ref(rgb, stamp)
        got = port(rgb, stamp)
        for name in ("boxes", "category", "score", "mask"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))


def test_detectors_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        pdet.GTDetector(PSLAMConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        pdet.YoloDetector(PSLAMConfig(),
                          weights_path="assets/yolov8n_synth.npz")


def test_yolo_detector_end_to_end_on_the_cpu():
    """The shipped weights embed their input size (256): the port's
    detector honours it, as the reference's, and returns Detections on its
    device with boxes inside the frame and class ids shifted by one."""
    det = pdet.YoloDetector(PSLAMConfig(), device="cpu",
                            weights_path="assets/yolov8n_synth.npz")
    assert det.size == 256
    rgb = np.random.default_rng(0).integers(0, 255, (240, 424, 3),
                                            dtype=np.uint8)
    d = det(rgb)
    cap = PSLAMConfig().semantic.max_detections
    assert d.boxes.shape == (cap, 4) and d.boxes.device.type == "cpu"
    b = d.boxes.numpy()
    assert (b >= 0).all() and (b[:, [0, 2]] <= 423).all() \
        and (b[:, [1, 3]] <= 239).all()
    assert (d.category.numpy()[d.mask.numpy()] >= 1).all()
    with pytest.raises(FileNotFoundError):
        pdet.YoloDetector(PSLAMConfig(), weights_path="x.pt", device="cpu")
    with pytest.raises(FileNotFoundError):
        pdet.YoloDetector(PSLAMConfig(), weights_path="missing.npz",
                          device="cpu")
