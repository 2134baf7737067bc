"""The yardstick's arithmetic: window statistics, the kernels' operations
and bytes, YOLOv8n's FLOPs and the trace reduction, against values worked
by hand."""

from __future__ import annotations

import statistics

import pytest

from benchlib import roofline, stats, trace


def test_rate_is_every_result_over_the_whole_window():
    assert stats.rate(120, 40.0) == 3.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_tail_of_every_frame_sees_a_stall_that_chunk_medians_hide():
    # 200 frames at 200 ms and, in a burst, 12 frames stalled at 900 ms
    lat = [0.2] * 188 + [0.9] * 12
    assert stats.percentile(lat, 95) == 0.9       # rank 190 of 200
    chunks = [lat[i:i + 20] for i in range(0, 200, 20)]
    assert statistics.median(statistics.median(c) for c in chunks) == 0.2
    # and the rate over the window counts the stall's time
    assert stats.rate(len(lat), sum(lat)) == pytest.approx(200 / 48.4)


def test_nearest_rank_percentile():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([3, 1, 2, 4], 50) == 2


class _Cfg:
    class camera:
        width, height = 20, 10

    class orb:
        n_levels, scale_factor, max_keypoints = 2, 2.0, 8


def test_b1_work_at_a_small_shape():
    # levels 10x20 and 5x10: 250 pixels a frame, 3 frames
    ops, nbytes = roofline.b1_work(_Cfg, 3)
    assert ops == 97 * 750 and nbytes == 8 * 750


def test_b2_work_at_a_small_shape():
    d = roofline.disc_pixels()
    assert d == 749        # the radius-15 IC disc of ORB-SLAM
    ops, nbytes = roofline.b2_work(_Cfg, 2)
    assert nbytes == 16 * (4 * 749 + 4 * 512 + 16 + 256 + 8)
    assert ops == 16 * (4 * 749 + 8 * 512 + 256)


def test_least_time_is_the_larger_bound():
    assert roofline.least_seconds(33.5e12, 0.0) == pytest.approx(1.0)
    assert roofline.least_seconds(67e12, 0.0, roofline.F32_PEAK) == \
        pytest.approx(1.0)
    assert roofline.least_seconds(1.0, 3.35e12) == pytest.approx(1.0)


def test_yolov8n_flops():
    # 8.7 GFLOPs at 640 (ultralytics' figure for YOLOv8n, 80 classes);
    # a fully convolutional net scales with the pixel count
    assert roofline.yolo_flops(640) == pytest.approx(8.7e9, rel=0.01)
    assert roofline.yolo_flops(256) == pytest.approx(
        roofline.yolo_flops(640) * (256 / 640) ** 2, rel=1e-9)
    # the stem alone at 32: 3 -> 16 channels, 3x3, stride 2: 16x16 outputs
    from slamref.models import yolov8
    assert 2 * 16 * 16 * 16 * 3 * 9 < roofline.yolo_flops(32)
    assert yolov8.CHANNELS[0] == 16


def test_trace_reduction():
    ev = [
        ("user_annotation", "layer:pipeline", 0, 100),
        ("user_annotation", "layer:track", 10, 50),
        ("kernel", "fast_score_kernel(T)", 5, 10),
        ("kernel", "k2", 30, 10),
        ("gpu_memcpy", "copy", 35, 10),
        ("kernel", "fast_score_kernel(T)", 70, 20),
    ]
    r = trace.read(ev)
    assert r["launches"] == 3
    assert r["busy_s"] == pytest.approx(45e-6)
    assert r["window_s"] == pytest.approx(100e-6)
    # gaps: 0-5 and 90-100 in pipeline, 15-30 and 45-70 in track
    assert dict(r["idle_gaps"]) == pytest.approx(
        {"track": 40e-6, "pipeline": 15e-6})
    assert roofline.kernel_time(r, "fast_score") == (2, pytest.approx(30e-6))


@pytest.mark.parametrize("events_typed", [True, False])
def test_trace_read_from_the_profilers_raw_events(events_typed, monkeypatch,
                                                   tmp_path):
    """The raw events, or the Chrome trace where they carry no activity
    type, give each event's category: a layer range and the operations
    inside it."""
    import torch
    if not events_typed:
        monkeypatch.delattr(torch._C._autograd._KinetoEvent, "activity_type")
    prof = trace.start(cuda=False)
    with torch.profiler.record_function("layer:track"):
        torch.ones(8).add_(1)
    from torch.autograd.profiler import _disable_profiler
    ev = list(trace._events(_disable_profiler(), tmp_path / "t.json"))
    cats = {(c, n) for c, n, _, _ in ev}
    assert ("user_annotation", "layer:track") in cats
    assert any(c == "cpu_op" for c, _ in cats)
    assert not (tmp_path / "t.json").exists()
    prof = trace.start(cuda=False)
    torch.ones(8).add_(1)
    r = trace.stop(prof, tmp_path / "t.json")
    assert r["launches"] == 0 and r["window_s"] > 0


def test_span_self_time_leaves_out_the_spans_inside():
    import time as _t

    import torch

    from benchlib.probes import Probes
    p = Probes(torch.device("cpu"))
    inner = p._wrap(lambda: _t.sleep(0.05), "extract", None)

    def outer_fn():
        _t.sleep(0.02)
        inner()
    outer = p._wrap(outer_fn, "track", None)
    p.tracing = True
    outer()
    outer()
    assert p.calls == {"track": 2, "extract": 2}
    assert p.self_s["extract"] == pytest.approx(0.10, abs=0.02)
    assert p.self_s["track"] == pytest.approx(0.04, abs=0.02)
    assert p.total_s["track"] == pytest.approx(0.14, abs=0.03)


def test_capture_copies_arguments_and_result():
    import torch

    from benchlib.probes import Probes
    p = Probes(torch.device("cpu"))
    f = p._wrap(lambda x: x.add_(1), None, "track")
    x = torch.zeros(2)
    f(x)                       # not armed: nothing kept
    p.arm("track", 1)
    p.tag = 7
    f(x)
    f(x)                       # the one armed call is spent
    (rec,) = p.captured["track"]
    assert rec["tag"] == 7
    assert rec["args"][0].tolist() == [1.0, 1.0]
    assert rec["out"].tolist() == [2.0, 2.0]


def test_a_pingpong_cycle_never_jumps():
    from benchlib.drivers import frame_at
    got = [frame_at(p, 4, "pingpong") for p in range(10)]
    assert got == [0, 1, 2, 3, 2, 1, 0, 1, 2, 3]
    assert [frame_at(p, 4) for p in range(6)] == [0, 1, 2, 3, 0, 1]
    # 49 frames: a period of 96 positions, 4 batches of 24
    assert all(frame_at(p + 96, 49, "pingpong") == frame_at(p, 49, "pingpong")
               for p in range(200))
