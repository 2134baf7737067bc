"""The port's tracer (``utils/profiling.TRACER``) and the benchmark's
readers of it, on the CPU.

- Off: no records, and ``span()`` / ``entry()`` hand back the shared
  no-op; counters go nowhere.
- Spans nest per thread (two threads), self times on a scripted clock;
  counters are charged to the innermost open span and to their totals;
  16 threads lose no count and no span.
- ``last_session()`` after a ``torch.profiler`` CPU session: the spans of
  the entry calls made inside it and no others; a second session does not
  carry the first's records.  Each span lies within 50 µs of the
  ``layer:`` range it opened, on the profiler's timeline.
- ``SLAMSystem.process`` and ``process_batch`` on 160x120 frames with the
  tracer on name every layer's stage spans, and give the trajectory and
  ``stats`` bit for bit as with it off; ``SLAMFleet.step_batch`` on a
  two-shard mesh records each shard's spans in its own thread.
- ``host.syncs``: the plumbing, with the sync debug mode's warning raised
  by a stub (the mode itself is CUDA-only); the warnings state is put
  back.
- The threaded runner's ``queue.wait`` spans and ``queue.dropped``.
- Each of the six readers under ``benchmark/metrics/`` on hand-made
  sessions, and None where its span or counter never fired.
- uint16 depth at TUM's 1/5000 m comes out in metres (tracker and the
  runner's wire).
"""

import importlib.util
import threading
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from dynamic_visual_slam_tpu_torch.config import CameraConfig, SLAMConfig
from dynamic_visual_slam_tpu_torch.io import synthetic
from dynamic_visual_slam_tpu_torch.utils import profiling
from dynamic_visual_slam_tpu_torch.utils.profiling import (NO_SPAN, TRACER,
                                                           Session)

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
CAM = CameraConfig(width=160, height=120, fx=130.0, fy=130.0, cx=79.5,
                   cy=59.5)
CFG = SLAMConfig().replace(camera=CAM)


@pytest.fixture(autouse=True)
def tracer_off():
    TRACER.disable()
    yield
    TRACER.disable()


def _names(session, thread=None):
    return {r.name for r in session.records
            if thread is None or r.thread == thread}


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


# --- off, nesting, counters -------------------------------------------------

def test_off_records_nothing():
    assert not TRACER.on
    before = TRACER.last_session()
    assert TRACER.span("x") is NO_SPAN
    assert TRACER.entry("process", 1, "cpu") is NO_SPAN
    with TRACER.span("x"):
        TRACER.count("c", 3)
    assert TRACER.now() is None
    TRACER.add_span("queue.wait", 0)
    assert TRACER.last_session() is before
    assert TRACER.disable() is None


def test_spans_nest_per_thread_on_a_scripted_clock(monkeypatch):
    ticks = iter(range(0, 10 ** 6, 10))
    lock = threading.Lock()

    def stamp():
        with lock:
            return next(ticks)
    monkeypatch.setattr(profiling, "_clock", lambda: (stamp, None, "test"))
    TRACER.enable(syncs=False)
    go = threading.Event()

    def other():
        go.wait()
        with TRACER.span("b"):
            with TRACER.span("b.in"):
                TRACER.count("n", 2)
    t = threading.Thread(target=other, name="worker")
    t.start()
    with TRACER.span("a"):                       # stamps 0 ..
        with TRACER.span("a.1"):
            TRACER.count("n")
        go.set()
        t.join()
        with TRACER.span("a.2"):
            pass
    s = TRACER.disable()
    assert s.clock == "test" and s.frames == 0
    by = {r.name: r for r in s.records}
    assert set(by) == {"a", "a.1", "a.2", "b", "b.in"}
    assert by["a"].thread == "MainThread" and by["b"].thread == "worker"
    assert s.records[by["a.1"].parent].name == "a"
    assert s.records[by["a.2"].parent].name == "a"
    assert by["a"].parent == -1 and by["b"].parent == -1      # apart
    assert s.records[by["b.in"].parent].name == "b"
    # the scripted clock: each stamp 10 ns after the last
    dur = {n: r.end_ns - r.start_ns for n, r in by.items()}
    assert dur["a.1"] == 10 and dur["a.2"] == 10 and dur["b.in"] == 10
    assert dur["b"] == 30 and dur["a"] == 90
    assert s.spans["a"]["self_s"] == pytest.approx(70e-9)
    assert s.spans["b"]["self_s"] == pytest.approx(20e-9)
    assert s.spans["a"]["total_s"] == pytest.approx(90e-9)
    assert s.spans["a.1"]["calls"] == 1
    assert s.counters == {"n": 3}
    assert by["a.1"].counts == {"n": 1} and by["b.in"].counts == {"n": 2}
    assert by["a"].counts == {}


def test_counters_and_spans_lose_nothing_across_threads():
    """16 threads (more than the cores) under a short switch interval:
    every count and every span arrives."""
    import sys
    interval = sys.getswitchinterval()
    TRACER.enable(syncs=False)
    try:
        sys.setswitchinterval(1e-6)

        def work():
            for _ in range(500):
                with TRACER.span("s"):
                    TRACER.count("n")
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
        s = TRACER.disable()
    assert not any(t.is_alive() for t in threads)
    assert s.counters["n"] == 16 * 500
    assert s.spans["s"]["calls"] == 16 * 500
    assert sum(r.counts["n"] for r in s.records) == 16 * 500


def test_a_profiler_session_is_one_session():
    def step(k):
        with TRACER.entry("process", 1, "cpu"):
            with TRACER.span(f"stage{k}"):
                TRACER.count("c")

    step(0)                          # before: nothing
    assert TRACER.last_session() is None or \
        "stage0" not in _names(TRACER.last_session())
    with _profile():
        step(1)
        step(2)
    step(3)                          # after: closes the session, records no
    s = TRACER.last_session()
    assert not TRACER.on
    assert _names(s) == {"process", "stage1", "stage2"}
    assert s.frames == 2 and s.counters == {"frames": 2, "c": 2}
    assert s.spans["process"]["calls"] == 2
    with _profile():
        step(4)
    s2 = TRACER.last_session()       # closes the second session
    assert s2 is not s and _names(s2) == {"process", "stage4"}
    assert s2.frames == 1


def test_spans_sit_on_the_profiler_clock():
    with _profile() as prof:
        for i in range(20):
            with TRACER.entry("process", 1, "cpu"):
                with TRACER.span("work"):
                    torch.ones(1000).cumsum(0)
    s = TRACER.last_session()
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("layer:"))
    spans = sorted((r.start_ns, r.end_ns, "layer:" + r.name)
                   for r in s.records)
    assert len(ranges) == len(spans) == 40
    for (a0, a1, an), (b0, b1, bn) in zip(ranges, spans):
        assert an == bn
        assert abs(a0 - b0) < 50_000 and abs(a1 - b1) < 50_000, \
            (an, a0 - b0, a1 - b1)


# --- the program's spans ----------------------------------------------------

@pytest.fixture(scope="module")
def frames():
    seq = list(synthetic.generate_sequence(CAM, 16, seed=11,
                                           depth_noise=0.004))
    grays = np.stack([f[0] for f in seq]).astype(np.uint8)
    depths = (np.stack([f[1] for f in seq]) * 1000.0).astype(np.uint16)
    # ten times the input time, so that BA fires within 16 frames
    stamps = np.asarray([f[4] for f in seq]) * 10.0
    return grays, depths, stamps


def _system(**kw):
    from dynamic_visual_slam_tpu_torch.pipeline.slam import SLAMSystem
    return SLAMSystem(CFG, ba_async=False, device="cpu", **kw)


def _same(a, b):
    assert a.stats == b.stats
    assert len(a.trajectory) == len(b.trajectory) > 0
    for x, y in zip(a.trajectory, b.trajectory):
        assert x.timestamp == y.timestamp
        assert np.array_equal(x.q_wc, y.q_wc)
        assert np.array_equal(x.t_wc, y.t_wc)
        assert (x.tracking_ok, x.is_keyframe, x.n_inliers) == \
            (y.tracking_ok, y.is_keyframe, y.n_inliers)


TRACKER = {"track", "track.prep", "track.match", "track.ransac.fm",
           "track.ransac.pnp", "track.ransac.anchor"}
EXTRACT = {"extract", "extract.pyramid", "extract.b1", "extract.detect",
           "extract.b2"}
BA = {"ba", "ba.window", "ba.optimize", "ba.apply", "ba.prune"}


def test_process_batch_spans_and_results_bit_equal(frames):
    grays, depths, stamps = frames
    runs = []
    for on in (False, True):
        slam = _system(enable_place_recognition=False, sync_every=2)
        if on:
            TRACER.enable(syncs=False)
        for i in range(0, 16, 4):
            slam.process_batch(grays[i:i + 4], depths[i:i + 4],
                               stamps[i:i + 4])
        slam.finalize()
        runs.append((slam, TRACER.disable()))
    (off, none), (on, s) = runs
    assert none is None
    _same(off, on)
    assert _names(s) == {"process_batch", "track.core", "insert",
                         "pipeline.read", "pipeline.emit"} | TRACKER \
        | EXTRACT | BA
    assert s.frames == 16 and s.spans["process_batch"]["calls"] == 4
    assert s.spans["track.core"]["calls"] == 4
    # the core's re-anchor: a match and a PnP a frame after the first
    assert s.spans["track.match"]["calls"] == 4 * (2 + 3)
    roots = [r for r in s.records if r.parent == -1]
    # the entry calls, and finalize's flush
    assert {r.name for r in roots} == {"process_batch", "pipeline.emit"}
    parent = {r.name: s.records[r.parent].name for r in s.records
              if r.parent >= 0}
    assert parent["track.core"] == "track" == parent["track.prep"]
    assert parent["extract.b2"] == "extract"
    assert parent["ba.optimize"] == "ba" == parent["ba.prune"]
    assert s.counters["ransac.hypotheses.fm"] == 16 * \
        CFG.ransac.fm_iterations
    assert s.counters["ransac.hypotheses.pnp"] > 0
    # self times add up to the roots' totals
    assert sum(v["self_s"] for v in s.spans.values()) == pytest.approx(
        sum(r.end_ns - r.start_ns for r in roots) * 1e-9)


def test_process_spans_and_results_bit_equal(frames):
    grays, depths, stamps = frames
    runs = []
    for on in (False, True):
        slam = _system(vocab_train_keyframes=2, loop_min_gap=1,
                       loop_min_score=0.0)
        if on:
            TRACER.enable(syncs=False)
        for i in range(12):
            slam.process(grays[i], depths[i], stamps[i])
        slam.finalize()
        runs.append((slam, TRACER.disable()))
    (off, _), (on, s) = runs
    _same(off, on)
    names = _names(s)
    assert {"process", "insert", "pipeline.read", "pipeline.emit",
            "place.vocab", "place.add", "place.query",
            "place.verify"} | TRACKER | EXTRACT | BA <= names
    assert "track.core" not in names         # the per-frame tracker has none
    assert s.frames == 12 and s.spans["process"]["calls"] == 12
    assert s.counters["place.queries"] == s.spans["place.query"]["calls"]
    assert s.counters["place.verify.dispatched"] == \
        s.spans["place.verify"]["calls"] > 0
    assert 0 <= s.counters.get("place.verify.passed", 0) \
        <= s.counters["place.verify.dispatched"]
    parent = {r.name: s.records[r.parent].name for r in s.records
              if r.parent >= 0}
    assert parent["extract"] == "track" and parent["track"] == "process"


def test_fleet_spans_per_shard_thread(frames):
    from dynamic_visual_slam_tpu_torch.parallel.mesh import (SLAMFleet,
                                                             make_mesh)
    grays, depths, stamps = frames
    fleet = SLAMFleet(CFG, 2, make_mesh(devices=["cpu"] * 2), device="cpu")
    t, b = 3, 2
    g = torch.from_numpy(grays[:t * b].reshape(t, b, 120, 160))
    d = torch.from_numpy(depths[:t * b].reshape(t, b, 120, 160))
    ts = stamps[:t * b].reshape(t, b)
    TRACER.enable(syncs=False)
    fleet.step_batch(g, d, ts)
    fleet.run_ba(1.0)
    s = TRACER.disable()
    assert s.frames == t * b
    for shard in ("shard-0", "shard-1"):
        got = _names(s, shard)
        assert {"track", "extract", "insert", "ba.window",
                "ba.prune"} <= got
        assert all(r.parent == -1 or s.records[r.parent].thread == shard
                   for r in s.records if r.thread == shard)
    assert {"step_batch", "ba"} <= _names(s, "MainThread")
    assert "track" not in _names(s, "MainThread")


# --- host.syncs, the runner ------------------------------------------------

def test_host_syncs_are_counted_and_the_warnings_restored():
    filters, shown = list(warnings.filters), warnings.showwarning
    TRACER.enable(syncs=True)
    with TRACER.span("read"):
        for _ in range(3):              # each one, not the first alone
            warnings.warn(profiling.SYNC_WARNING
                          + " (Triggered internally)", UserWarning)
    with pytest.warns(UserWarning, match="other"):
        warnings.warn("other", UserWarning)
    warnings.warn(profiling.SYNC_WARNING, UserWarning)
    s = TRACER.disable()
    assert s.counters["host.syncs"] == 4
    (read,) = [r for r in s.records if r.name == "read"]
    assert read.counts == {"host.syncs": 3}
    assert warnings.filters == filters and warnings.showwarning is shown


class _Stub:
    """The surface of SLAMSystem the runner drives."""

    def __init__(self, config):
        self.config = config
        self.got = []

    def process(self, gray, depth, timestamp, detections=None):
        with TRACER.entry("process", 1, "cpu"):
            self.got.append((np.array(depth), timestamp))

    def finalize(self):
        pass


def test_threaded_runner_traces_its_queue():
    from dynamic_visual_slam_tpu_torch.pipeline import runner
    cfg = CFG.replace(camera=CAM)
    sys_ = _Stub(cfg)
    frames = [(np.zeros((120, 160), np.uint8),
               np.full((120, 160), 1.5, np.float32), 0.1 * i)
              for i in range(6)]
    TRACER.enable(syncs=False)
    stats = runner.ThreadedPipeline(sys_).run(iter(frames))
    s = TRACER.disable()
    assert stats["frames_processed"] == 6
    assert s.spans["queue.wait"]["calls"] == 6
    assert s.counters["queue.dropped"] == stats["queue_dropped"] == 0
    assert s.frames == 6
    assert all(d.dtype == np.uint16 and (d == 1500).all()
               for d, _ in sys_.got)


# --- depth in the camera's units --------------------------------------------

def test_tum_uint16_depth_comes_out_in_metres():
    from dynamic_visual_slam_tpu_torch.frontend import tracker
    from dynamic_visual_slam_tpu_torch.pipeline import runner
    cfg = SLAMConfig.preset("tum_fr3").replace(camera=SLAMConfig.preset(
        "tum_fr3").camera.scaled(160, 120))
    assert cfg.camera.depth_scale == 1.0 / 5000.0
    g, d = next(iter(synthetic.generate_sequence(cfg.camera, 1, seed=2)))[:2]
    d16 = np.round(d * 5000.0).astype(np.uint16)
    metres = torch.from_numpy(d16.astype(np.float32)) \
        * cfg.camera.depth_scale
    gen = torch.Generator().manual_seed(0)
    outs = []
    for depth in (torch.from_numpy(d16), metres):
        gen.manual_seed(0)
        st, out = tracker.track_step(
            cfg, tracker.init_state(cfg, "cpu"), torch.from_numpy(g), depth,
            torch.zeros(()), tracker.generator_sampler(gen))
        outs.append((st, out))
    (st16, o16), (stm, om) = outs
    assert torch.equal(st16.prev_depth, stm.prev_depth)
    assert torch.equal(o16.keyframe.xyz_w, om.keyframe.xyz_w)
    z = st16.prev_depth[st16.prev.mask]
    assert len(z) > 50
    zt = torch.from_numpy(d)[st16.prev.uv[st16.prev.mask, 1].round().long(),
                             st16.prev.uv[st16.prev.mask, 0].round().long()]
    assert (z - zt).abs().max() <= 1.0 / 5000.0
    # the runner's wire carries the camera's units
    wire = runner._unpack_frame(runner._pack_frame(g, d, 1.0 / 5000.0),
                                120, 160)[1]
    assert np.abs(wire * (1.0 / 5000.0) - d).max() <= 1.0 / 5000.0
    assert runner._pack_frame(g, d) == runner._pack_frame(g, d, 1e-3)


# --- the benchmark's readers ------------------------------------------------

READERS = ("host_wait_ms", "host_syncs_per_frame", "track_ransac_ms",
           "track_core_ms", "place_verify_ms", "place_verify_ok_pct")


def _reader(name):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _span(self_s):
    return dict(calls=1, total_s=self_s, self_s=self_s)


@pytest.mark.parametrize("name", READERS)
def test_readers_on_hand_made_sessions(monkeypatch, name):
    full = Session(frames=20, spans={
        "pipeline.read": _span(0.04), "track.core": _span(0.3),
        "track.ransac.fm": _span(0.1), "track.ransac.pnp": _span(0.2),
        "track.ransac.anchor": _span(0.1), "place.verify": _span(0.5)},
        counters={"frames": 20, "host.syncs": 30,
                  "place.verify.dispatched": 8, "place.verify.passed": 2})
    want = {"host_wait_ms": 2.0, "host_syncs_per_frame": 1.5,
            "track_ransac_ms": 20.0, "track_core_ms": 15.0,
            "place_verify_ms": 25.0, "place_verify_ok_pct": 25.0}[name]
    read = _reader(name)
    monkeypatch.setattr(TRACER, "last_session", lambda: full)
    assert read({}) == pytest.approx(want)
    monkeypatch.setattr(TRACER, "last_session",
                        lambda: Session(frames=20, counters={"frames": 20}))
    assert read({}) is None
    monkeypatch.setattr(TRACER, "last_session", lambda: None)
    assert read({}) is None
    monkeypatch.delattr(profiling, "TRACER")     # a program without it
    assert read({}) is None
