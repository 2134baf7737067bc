"""PyTorch port vs the JAX reference: pipeline/runner (the threaded
bounded-queue / ApproximateTime transport) and pipeline/sync.

Tolerances, and why: none.  The wire format, the queue and the pairing are
the reference's host code; the threaded run feeds SLAMSystem.process the
same frames in the same order as the synchronous run, so its trajectory is
equal to it wherever the queue drops nothing.
"""

import time

import numpy as np
import pytest
import torch

from torch_parity import Pacer

from dynamic_visual_slam_tpu.pipeline import runner as jrunner
from dynamic_visual_slam_tpu.pipeline import sync as jsync
from dynamic_visual_slam_tpu_torch.backend import mapping
from dynamic_visual_slam_tpu_torch.config import (CameraConfig, MapConfig,
                                                  SLAMConfig)
from dynamic_visual_slam_tpu_torch.io import synthetic
from dynamic_visual_slam_tpu_torch.pipeline import sync as psync
from dynamic_visual_slam_tpu_torch.pipeline.runner import (ThreadedPipeline,
                                                           _pack_frame,
                                                           _unpack_frame)
from dynamic_visual_slam_tpu_torch.pipeline.slam import SLAMSystem
from dynamic_visual_slam_tpu_torch.semantic.detector import GTDetector

torch.set_num_threads(2)
CAM = CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                   cx=79.5, cy=59.5)
CFG = SLAMConfig().replace(
    camera=CAM,
    map=MapConfig(max_landmarks=512, max_keyframes=8,
                  max_obs_per_landmark=4, max_obs_per_keyframe=128))
SYS_KW = dict(ba_async=False, enable_place_recognition=False, device="cpu")


def _frames(n=16, seed=1):
    return [(g, d, float(ts)) for g, d, _, _, ts in
            synthetic.generate_sequence(CAM, n, seed=seed)]


def test_pack_roundtrip_matches_reference():
    rng = np.random.default_rng(0)
    g = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    d = rng.uniform(0.3, 3.0, (120, 160)).astype(np.float32)
    payload = _pack_frame(g, d)
    assert payload == jrunner._pack_frame(g, d)
    g8, d16 = _unpack_frame(payload, 120, 160)
    jg8, jd16 = jrunner._unpack_frame(payload, 120, 160)
    np.testing.assert_array_equal(g8, jg8)
    np.testing.assert_array_equal(d16, jd16)
    np.testing.assert_array_equal(g8, g.astype(np.uint8))
    np.testing.assert_allclose(d16.astype(np.float32) * 1e-3, d, atol=1e-3)


def _synchronous(frames, detections=None):
    slam = SLAMSystem(CFG, **SYS_KW)
    for i, (g, d, ts) in enumerate(frames):
        g8, d16 = _unpack_frame(_pack_frame(g, d), CAM.height, CAM.width)
        slam.process(g8, d16, ts,
                     detections=None if detections is None
                     else detections(ts))
    slam.finalize()
    return slam


def _assert_same_trajectory(a, b):
    assert len(a.trajectory) == len(b.trajectory)
    for fa, fb in zip(a.trajectory, b.trajectory):
        assert fa.timestamp == fb.timestamp
        assert fa.is_keyframe == fb.is_keyframe
        np.testing.assert_array_equal(fa.t_wc, fb.t_wc)
        np.testing.assert_array_equal(fa.q_wc, fb.q_wc)


def test_threaded_equals_synchronous():
    frames = _frames(16)
    want = _synchronous(frames)
    slam = SLAMSystem(CFG, **SYS_KW)
    stats = ThreadedPipeline(slam).run(iter(frames))
    assert stats["frames_processed"] == len(frames)
    assert stats["queue_dropped"] == 0
    _assert_same_trajectory(slam, want)


def test_threaded_with_a_detector(monkeypatch):
    """A stamp-aware detector (GTDetector) in the detector thread: its
    Detections pair with their frames through ApproximateTime and reach
    the tracker and the map as in the synchronous run.  The frames are
    paced (torch_parity.Pacer): a detector thread scheduled late would
    otherwise let frames time out of the pairing, by design, and the runs
    differ."""
    seq = list(synthetic.generate_dynamic_sequence(CAM, 12, seed=1))
    frames = [(g, d, float(ts)) for g, d, _, _, ts, _ in seq]
    det = GTDetector(CFG, device="cpu")
    for *_, ts, boxes in seq:
        det.record(ts, boxes)
    assert sum(len(f[5]) for f in seq) >= 12
    want = _synchronous(frames, lambda ts: det(None, ts))
    pacer = Pacer()
    monkeypatch.setattr(GTDetector, "__call__",
                        pacer.wrap(GTDetector.__call__))
    slam = SLAMSystem(CFG, **SYS_KW)
    stats = ThreadedPipeline(slam, detector=det).run(pacer.frames(frames))
    assert pacer.answered == len(frames)
    assert stats["frames_processed"] == len(frames)
    assert stats["frames_without_detections"] == 0
    _assert_same_trajectory(slam, want)
    assert not np.any(slam.landmarks_world()["category"] == 1)


def test_threaded_detector_failure_ends_the_run():
    """A detector that raises in its thread fails the run with its error:
    the frames do not go on without detections."""
    frames = _frames(12)

    def detector(rgb):
        raise ValueError("detector down")

    slam = SLAMSystem(CFG, **SYS_KW)
    with pytest.raises(ValueError, match="detector down"):
        ThreadedPipeline(slam, detector=detector).run(iter(frames))


def test_threaded_with_a_plain_detector():
    frames = _frames(12)
    calls = []

    def detector(rgb):
        calls.append(rgb.shape)
        return mapping.Detections.empty(CFG.semantic.max_detections, "cpu")

    slam = SLAMSystem(CFG, **SYS_KW)
    stats = ThreadedPipeline(slam, detector=detector).run(iter(frames))
    assert stats["frames_processed"] == len(frames)
    assert len(calls) >= len(frames) - 2
    assert calls[0] == (CAM.height, CAM.width, 3)


def test_queue_drops_oldest_under_pressure():
    """A throttled consumer against an instant producer with a queue of
    depth 2: the oldest frames go, the newest survives, and every input
    frame is either processed or counted as dropped."""
    frames = _frames(20)
    inner = SLAMSystem(CFG, **SYS_KW)

    class SlowConsumer:
        config = CFG

        def process(self, *a, **k):
            time.sleep(0.08)
            return inner.process(*a, **k)

        def finalize(self):
            inner.finalize()

    stats = ThreadedPipeline(SlowConsumer(), queue_depth=2).run(iter(frames))
    assert stats["frames_in"] == len(frames)
    assert stats["queue_dropped"] > 0
    assert stats["frames_processed"] + stats["queue_dropped"] == \
        stats["frames_in"]
    processed = [f.timestamp for f in inner.trajectory]
    assert frames[-1][2] in processed
    assert processed == sorted(processed)


@pytest.mark.parametrize("b_optional", [False, True])
def test_approximate_time_pairs_match_reference(b_optional):
    rng = np.random.default_rng(5)
    ta = np.cumsum(rng.uniform(0.02, 0.05, 60))
    keep = rng.random(60) > 0.2
    tb = ta[keep] + rng.normal(0, 0.02, keep.sum())
    events = sorted([(t, "a", i) for i, t in enumerate(ta)]
                    + [(t + 0.01, "b", i) for i, t in enumerate(tb)])
    ref = jsync.ApproximateTimeSync(queue_size=10, slop=0.03,
                                    b_optional=b_optional)
    port = psync.ApproximateTimeSync(queue_size=10, slop=0.03,
                                     b_optional=b_optional)
    got, want = [], []
    for t, kind, i in events:
        stamp = float(ta[i] if kind == "a" else tb[i])
        for s in (ref, port):
            (s.push_a if kind == "a" else s.push_b)(stamp, (kind, i))
        want += ref.poll()
        got += port.poll()
    want += ref.poll(flush=True)
    got += port.poll(flush=True)
    assert got == want
    assert sum(p[2] is not None for p in got) > 20


def test_bounded_queue_matches_reference():
    ref, port = jsync.BoundedQueue(3), psync.BoundedQueue(3)
    for i in range(7):
        ref.push(i)
        port.push(i)
    assert port.dropped == ref.dropped == 4
    assert [port.pop() for _ in range(4)] == [ref.pop() for _ in range(4)]
