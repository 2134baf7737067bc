"""The port's native runtime (``dynamic_visual_slam_tpu_torch/native``:
its own ``runtime.cpp``, built with g++ into ``build/native/``) against the
reference package's, and the profiling helpers on top of it.

- The reference's seven cases (``tests/test_native.py``: round trip,
  drop-oldest, pop timeout, cross-thread, the sync policy against
  ``ApproximateTimeSync``, mandatory B waits, the chrome trace) on the
  port's bindings.
- The port's ``NativeSync`` against the reference's on one seeded stream of
  pushes: equal polls.  A 720p frame's payload (u8 gray + u16 depth,
  2,764,800 bytes) and one longer than ``max_item`` pop byte-equal to the
  reference's.
- The build: the library is named by a digest of source and flags under
  ``build/native/``, never the reference's ``libdvsruntime.so``; several
  processes building at once leave one loadable library; a stale library
  or a leftover temporary file is never loaded; ``cli run --trace``, which
  records through the port's tracer, writes its trace with no working
  compiler.
- ``device_profile`` writes a trace on the CPU.
"""

import ctypes
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from dynamic_visual_slam_tpu import native as jnative
from dynamic_visual_slam_tpu_torch import cli, native
from dynamic_visual_slam_tpu_torch.native import build
from dynamic_visual_slam_tpu_torch.pipeline.sync import ApproximateTimeSync
from dynamic_visual_slam_tpu_torch.utils import profiling

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent


# --- the reference's cases (tests/test_native.py) on the port -------------

def test_push_pop_roundtrip():
    q = native.NativeQueue(depth=4)
    q.push(1.5, b"hello")
    assert q.pop(timeout=0.5) == (1.5, b"hello")


def test_drop_oldest():
    q = native.NativeQueue(depth=2)
    for i in range(4):
        q.push(float(i), bytes([i]))
    assert q.dropped == 2
    assert q.pop(0.2)[1] == bytes([2])


def test_pop_timeout():
    q = native.NativeQueue(depth=2)
    t0 = time.time()
    assert q.pop(timeout=0.15) is None
    assert 0.1 < time.time() - t0 < 1.0


def test_cross_thread():
    q = native.NativeQueue(depth=8)
    got = []

    def consumer():
        for _ in range(10):
            item = q.pop(timeout=2.0)
            if item:
                got.append(item)

    t = threading.Thread(target=consumer)
    t.start()
    for i in range(10):
        q.push(i * 0.1, f"frame{i}".encode())
        time.sleep(0.002)
    t.join(timeout=30)
    assert not t.is_alive()
    assert len(got) == 10
    assert got[0][1] == b"frame0" and got[-1][1] == b"frame9"


def test_sync_matches_python_policy():
    """Same push sequence through both implementations → same pairs."""
    seq = [("a", 1.00, 0), ("b", 1.02, 100), ("a", 1.05, 1),
           ("b", 1.30, 101), ("a", 1.31, 2), ("a", 1.40, 3),
           ("a", 1.55, 4), ("b", 1.56, 102)]
    ns = native.NativeSync(slop=0.05, b_optional=True)
    ps = ApproximateTimeSync(slop=0.05, b_optional=True)
    n_out, p_out = [], []
    for kind, stamp, ident in seq:
        if kind == "a":
            ns.push_a(stamp, ident)
            ps.push_a(stamp, ident)
        else:
            ns.push_b(stamp, ident)
            ps.push_b(stamp, ident)
        n_out += ns.poll()
        p_out += [(s, a, b) for s, a, b in ps.poll()]
    assert n_out == p_out, (n_out, p_out)
    assert any(b is not None for _, _, b in n_out)
    assert any(b is None for _, _, b in n_out)


def test_mandatory_b_waits():
    ns = native.NativeSync(slop=0.05, b_optional=False)
    ns.push_a(1.0, 0)
    ns.push_b(9.0, 5)
    assert ns.poll() == []


def test_spans_dump_chrome_trace(tmp_path):
    tr = native.NativeTracer(capacity=128)
    with tr.span("track"):
        time.sleep(0.001)
        with tr.span("orb", tid=1):
            pass
    tr.instant("keyframe")
    path = str(tmp_path / "trace.json")
    assert tr.dump_chrome_trace(path) == 5
    data = json.load(open(path))
    names = [e["name"] for e in data["traceEvents"]]
    assert names.count("track") == 2 and names.count("orb") == 2
    assert {e["ph"] for e in data["traceEvents"]} == {"B", "E", "i"}


# --- against the reference's bindings -------------------------------------

@pytest.mark.parametrize("b_optional", [False, True])
def test_sync_polls_equal_the_reference(b_optional):
    """One seeded stream of 400 a/b pushes (b stamps jittered around a's,
    some b's missing, some late), polled after every push."""
    if not jnative.available():
        pytest.fail("the reference's native runtime did not load")
    rng = np.random.default_rng(7)
    ours = native.NativeSync(queue_size=10, slop=0.05, b_optional=b_optional,
                             timeout_entries=2)
    ref = jnative.NativeSync(queue_size=10, slop=0.05, b_optional=b_optional,
                             timeout_entries=2)
    got, want = [], []
    for i in range(400):
        stamp = i / 30.0
        pushes = [("a", stamp, i)]
        if rng.random() > 0.2:
            pushes.append(("b", stamp + rng.normal(0, 0.03), 1000 + i))
        if rng.random() < 0.3:
            pushes.reverse()
        for kind, s, ident in pushes:
            for q in (ours, ref):
                getattr(q, f"push_{kind}")(s, ident)
            got.append(ours.poll())
            want.append(ref.poll())
    assert got == want
    pairs = [p for polls in got for p in polls]
    assert len(pairs) > 200
    assert any(b is not None for _, _, b in pairs)


@pytest.mark.parametrize("case", ["720p", "longer_than_max_item"])
def test_queue_bytes_equal_the_reference(case):
    """A 720p frame's payload, and one longer than the queue's buffer
    (popped cut to ``max_item`` bytes, as the reference's slice cuts it)."""
    if not jnative.available():
        pytest.fail("the reference's native runtime did not load")
    n = 1280 * 720 * 3
    payload = np.random.default_rng(3).integers(
        0, 256, n, dtype=np.uint8).tobytes()
    max_item = n + 64 if case == "720p" else 1000
    ours = native.NativeQueue(depth=2, max_item=max_item)
    ref = jnative.NativeQueue(depth=2, max_item=max_item)
    ours.push(0.5, payload)
    ref.push(0.5, payload)
    got, want = ours.pop(1.0), ref.pop(1.0)
    assert got == want
    assert got[1] == payload[:max_item]
    assert ours.dropped == ref.dropped == 0 and len(ours) == len(ref) == 0


# --- the build ------------------------------------------------------------

def test_library_is_the_ports_own():
    assert native.available(), native.error()
    path = Path(build.ensure_built())
    assert path.parent == ROOT / "build" / "native"
    assert path.name.startswith("libdvsruntime-") and path.suffix == ".so"
    assert build.SRC == ROOT / "dynamic_visual_slam_tpu_torch" / "native" \
        / "runtime.cpp"
    # the same C interface as the reference's source
    decl = [line.split("(")[0].split()[-1] for line in
            build.SRC.read_text().splitlines() if " dvs_" in line
            and "(" in line and not line.startswith(" ")]
    ref = [line.split("(")[0].split()[-1] for line in
           (ROOT / "dynamic_visual_slam_tpu" / "native" / "runtime.cpp")
           .read_text().splitlines() if " dvs_" in line and "(" in line
           and not line.startswith(" ")]
    assert decl == ref and len(decl) == 17


def test_concurrent_builds_leave_one_loadable_library(tmp_path):
    """Four processes build into one directory at once; a stale library of
    another digest and a half-written temporary file are there before."""
    (tmp_path / "libdvsruntime-000000000000.so").write_bytes(b"stale")
    (tmp_path / "libdvsruntime-000000000000.so.1.tmp").write_bytes(b"half")
    code = ("import sys\nfrom pathlib import Path\n"
            "from dynamic_visual_slam_tpu_torch.native import build\n"
            "build.BUILD_DIR = Path(sys.argv[1])\n"
            "print(build.build(verbose=False))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    built = sorted(p.name for p in tmp_path.iterdir()
                   if p.name.endswith(".so")
                   and "000000000000" not in p.name)
    assert built == [Path(paths.pop()).name]
    assert not [p for p in tmp_path.iterdir()
                if p.name.endswith(".tmp") and "000000000000" not in p.name]
    lib = native._declare(ctypes.CDLL(str(tmp_path / built[0])))
    assert lib.dvs_now() > 0


def test_an_edited_source_is_rebuilt(tmp_path, monkeypatch):
    src = tmp_path / "runtime.cpp"
    src.write_text(build.SRC.read_text() + "\n// edited\n")
    before = build.library_path()
    monkeypatch.setattr(build, "SRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_err", None)
    after = build.library_path()
    assert after.name != before.name
    assert native.available(), native.error()
    assert after.exists()
    q = native.NativeQueue(depth=1)
    q.push(2.0, b"x")
    assert q.pop(0.1) == (2.0, b"x")


def test_trace_without_a_compiler_writes_the_trace(tmp_path, monkeypatch):
    """``--trace`` records through the port's own tracer
    (``utils/profiling.TRACER``): no native runtime is needed."""
    monkeypatch.setattr(build, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_err", None)
    rc = cli.main(["run", "--device", "cpu", "--width", "160", "--height",
                   "120", "--frames", "2", "--trace", "--out-dir",
                   str(tmp_path / "out")])
    assert rc == 0
    events = json.loads((tmp_path / "out" / "trace.json").read_text())[
        "traceEvents"]
    assert [e["name"] for e in events if e["ph"] == "B"].count("frame") == 2
    assert not native.available()
    assert not profiling.TRACER.on


# --- profiling ------------------------------------------------------------

def test_device_profile_writes_a_trace_on_the_cpu(tmp_path):
    logdir = tmp_path / "prof"
    with profiling.device_profile(str(logdir)) as prof:
        torch.ones(64).cumsum(0).sum()
    assert prof is not None
    traces = list(logdir.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
    with profiling.device_profile(None) as prof:
        pass
    assert prof is None
