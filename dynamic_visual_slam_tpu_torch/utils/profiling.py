"""Profiling and tracing: the port's one recorder.

- ``TRACER``: spans and counters inside every layer of the program
  (``Tracer``; ``traced`` makes a function's calls spans);
  ``write_chrome_trace`` writes a session as ``cli run --trace``'s
  ``trace.json``;
- StageTimer: per-stage wall-clock EMAs, as the reference package's
  ``utils/profiling``, which here also keeps every sample after the first
  and reports their median and 90th percentile;
- device_profile(): ``torch.profiler`` where the reference has
  ``jax.profiler``.

The tracer.  ``TRACER.span(name)`` is a context manager and
``TRACER.count(name, n)`` adds to a counter.  Off is the default: both
return after one attribute test (``span`` hands back the shared no-op
``NO_SPAN``), so that the hot path pays nothing, and the tracer never
synchronises the device.  It is on between ``enable()`` and ``disable()``,
and from the start of an entry call (``SLAMSystem.process``,
``process_batch``, ``SLAMFleet.step_batch``, ``YoloDetector.__call__``,
through ``TRACER.entry``) made while a ``torch.profiler`` session records
until the first entry call that finds it stopped (or ``last_session()``).
The profiler's state is read at the C level
(``torch._C._autograd._profiler_enabled``): a profiler stopped underneath
its Python object leaves the Python flag set.  Each such stretch is one
``Session``.

A span records its name, its parent (the innermost span open in the same
thread: each thread has a stack of its own, so the fleet's shard threads
nest apart), its thread, and its start and end.  A counter is charged to
its session's total and to the innermost open span of the calling thread.
Records stay in memory until the session closes.  While the profiler
records, each span also opens ``torch.profiler.record_function("layer:"
+ name)``, so that the profiler's trace, and the idle gaps a reader puts
down to the innermost ``layer:`` range, name the program's stages.

The clock.  ``torch.profiler`` stamps host events with c10's approximate
clock (the TSC on x86, ``torch._C._profiler._get_approximate_time``) and
reports them converted to Unix nanoseconds by an
``_ApproximateClockToUnixTimeConverter`` made at its start.  A span is
stamped with the same clock and converted by a converter of the session's
own when the session closes; where this PyTorch lacks either, with
``time.time_ns()``, the Unix clock the profiler converts to
(``Session.clock`` says which).

Host synchronisations.  On a CUDA device a session sets
``torch.cuda.set_sync_debug_mode("warn")`` and counts each synchronising
operation the mode reports (``host.syncs``) through a warnings filter that
shows every occurrence; the mode, the filter and ``warnings.showwarning``
are put back when the session closes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import re
import threading
import time
import warnings
from collections import defaultdict
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

SYNC_WARNING = "called a synchronizing CUDA operation"


def _profiler_enabled() -> bool:
    return torch._C._autograd._profiler_enabled()


def _clock():
    """(stamp function, converter class or None, clock name)."""
    prof = getattr(torch._C, "_profiler", None)
    stamp = getattr(prof, "_get_approximate_time", None)
    conv = getattr(prof, "_ApproximateClockToUnixTimeConverter", None)
    if stamp is not None and conv is not None:
        return stamp, conv, "approximate"
    return time.time_ns, None, "unix"


class _NoSpan:
    """The span the tracer hands out while it is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class Record(NamedTuple):
    """A closed span: ``parent`` indexes the session's records (-1: a
    root); ``start_ns``/``end_ns`` are Unix nanoseconds, the profiler's
    timeline; ``counts`` the counters charged to it while innermost."""

    name: str
    parent: int
    thread: str
    start_ns: int
    end_ns: int
    counts: Dict[str, int]


@dataclasses.dataclass
class Session:
    """What one session recorded: ``frames`` handed to entry calls (every
    stream counted), per span name ``calls``, ``total_s`` and ``self_s``
    (a span less the part of its interval its children cover), the
    counters' totals, and the records themselves."""

    frames: int = 0
    wall_s: float = 0.0
    spans: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    records: List[Record] = dataclasses.field(default_factory=list)
    clock: str = ""


class _Open:
    """The state of the open session."""

    def __init__(self, auto: bool, syncs: bool, tracer: "Tracer"):
        self.auto = auto
        self.stamp, conv, self.clock_name = _clock()
        self.converter = conv() if conv is not None else None
        self.t0 = time.perf_counter()
        self.local = threading.local()
        self.lock = threading.Lock()
        self.counters: Dict[str, int] = defaultdict(int)
        self.records: List["_Span"] = []
        self.open = True
        self.restore = _install_sync_counter(tracer) if syncs else None

    def stack(self) -> List["_Span"]:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
            self.local.thread = threading.current_thread().name
        return st


class _Span:
    __slots__ = ("tracer", "session", "name", "frames", "parent", "thread",
                 "t0", "t1", "counts", "_rf")

    def __init__(self, tracer: "Tracer", session: _Open, name: str,
                 frames: int = 0):
        self.tracer, self.session, self.name = tracer, session, name
        self.frames = frames
        self.parent = None
        self.counts: Optional[Dict[str, int]] = None
        self._rf = None

    def __enter__(self):
        s = self.session
        stack = s.stack()
        self.parent = stack[-1] if stack else None
        self.thread = s.local.thread
        stack.append(self)
        if _profiler_enabled():
            self._rf = torch.profiler.record_function("layer:" + self.name)
            self._rf.__enter__()
        if self.frames:
            self.tracer.count("frames", self.frames)
        self.t0 = s.stamp()
        return self

    def __exit__(self, *exc):
        s = self.session
        self.t1 = s.stamp()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        stack = s.stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        if s.open:
            s.records.append(self)
        return False


class Tracer:
    """The port's spans and counters (module docstring).  One instance,
    ``TRACER``."""

    def __init__(self):
        self.on = False
        self._s: Optional[_Open] = None
        self._last: Optional[Session] = None
        self._lock = threading.RLock()

    # -- the hot path --------------------------------------------------------
    def span(self, name: str):
        if not self.on:
            return NO_SPAN
        s = self._s
        return NO_SPAN if s is None else _Span(self, s, name)

    def count(self, name: str, n: int = 1) -> None:
        if not self.on:
            return
        s = self._s
        if s is None:
            return
        n = int(n)
        with s.lock:
            s.counters[name] += n
        stack = getattr(s.local, "stack", None)
        if stack:
            top = stack[-1]
            if top.counts is None:
                top.counts = {}
            top.counts[name] = top.counts.get(name, 0) + n

    def entry(self, name: str, frames: int = 0, device=None):
        """The span of an entry call handed ``frames`` frames on
        ``device``: opens a session while the profiler records (counting
        host synchronisations on a CUDA device), closes one the profiler
        left."""
        if not self.on:
            if not _profiler_enabled():
                return NO_SPAN
            self._start(auto=True, syncs=device is not None
                        and torch.device(device).type == "cuda")
        elif self._s is not None and self._s.auto \
                and not _profiler_enabled():
            self._stop()
            return NO_SPAN
        s = self._s
        return NO_SPAN if s is None else _Span(self, s, name, frames)

    def now(self) -> Optional[int]:
        """A stamp on the session's clock, for ``add_span``; None while
        off."""
        s = self._s if self.on else None
        return None if s is None else s.stamp()

    def add_span(self, name: str, start: Optional[int],
                 end: Optional[int] = None) -> None:
        """A root span of the calling thread from two ``now()`` stamps
        (``end`` defaults to now), such as a frame's wait in a queue."""
        s = self._s if self.on else None
        if s is None or start is None:
            return
        sp = _Span(self, s, name)
        s.stack()
        sp.thread = s.local.thread
        sp.t0, sp.t1 = start, s.stamp() if end is None else end
        if s.open:
            s.records.append(sp)

    # -- sessions ------------------------------------------------------------
    def enable(self, syncs: Optional[bool] = None) -> None:
        """Open a session (closing one the profiler opened).  ``syncs``:
        count host synchronisations (default: when CUDA is available;
        off the card the warnings plumbing alone, for tests)."""
        with self._lock:
            if self._s is not None:
                self._stop()
            self._start(auto=False, syncs=torch.cuda.is_available()
                        if syncs is None else syncs)

    def disable(self) -> Optional[Session]:
        """Close the open session → it (None if none was open)."""
        with self._lock:
            return self._stop() if self._s is not None else None

    def last_session(self) -> Optional[Session]:
        """The newest closed session; a session the profiler opened and
        has since stopped is closed first."""
        with self._lock:
            s = self._s
            if s is not None and s.auto and not _profiler_enabled():
                self._stop()
            return self._last

    def _start(self, auto: bool, syncs: bool) -> None:
        with self._lock:
            if self._s is not None:
                return
            self._s = _Open(auto, syncs, self)
            self.on = True

    def _stop(self) -> Session:
        with self._lock:
            s = self._s
            if s is None:
                return self._last
            self.on = False
            self._s = None
            s.open = False
            if s.restore is not None:
                s.restore()
            self._last = _summarise(s)
            return self._last


def _summarise(s: _Open) -> Session:
    spans = list(s.records)
    conv = s.converter.to_unix_ns if s.converter is not None else int
    index = {id(sp): i for i, sp in enumerate(spans)}
    records, child = [], [0] * len(spans)
    for sp in spans:
        t0, t1 = int(conv(sp.t0)), int(conv(sp.t1))
        parent = index.get(id(sp.parent), -1) if sp.parent is not None \
            else -1
        records.append(Record(sp.name, parent, sp.thread, t0, t1,
                              dict(sp.counts or {})))
        if parent >= 0:
            child[parent] += t1 - t0
    stats: Dict[str, Dict[str, float]] = {}
    for r, c in zip(records, child):
        st = stats.setdefault(r.name, dict(calls=0, total_s=0.0, self_s=0.0))
        st["calls"] += 1
        st["total_s"] += (r.end_ns - r.start_ns) * 1e-9
        st["self_s"] += (r.end_ns - r.start_ns - c) * 1e-9
    counters = dict(s.counters)
    return Session(frames=counters.get("frames", 0),
                   wall_s=time.perf_counter() - s.t0, spans=stats,
                   counters=counters, records=records, clock=s.clock_name)


def _install_sync_counter(tracer: Tracer):
    """Count ``host.syncs`` from the sync debug mode's warnings (the mode
    itself only where CUDA is available) → the function that puts the
    mode, the filter and ``showwarning`` back."""
    warnings.filterwarnings("always", message=re.escape(SYNC_WARNING),
                            category=UserWarning)
    item = warnings.filters[0]
    shown = warnings.showwarning

    def showwarning(message, category, filename, lineno, file=None,
                    line=None):
        if str(message).startswith(SYNC_WARNING):
            tracer.count("host.syncs")
        else:
            shown(message, category, filename, lineno, file, line)
    warnings.showwarning = showwarning
    mode = None
    if torch.cuda.is_available():
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")

    def restore():
        if mode is not None:
            torch.cuda.set_sync_debug_mode(mode)
        if warnings.showwarning is showwarning:
            warnings.showwarning = shown
        with contextlib.suppress(ValueError):
            warnings.filters.remove(item)
        getattr(warnings, "_filters_mutated", lambda: None)()
    return restore


TRACER = Tracer()


def traced(name: str):
    """Decorator: each call of the function is a ``name`` span (while the
    tracer is off, one more call frame and one attribute test)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not TRACER.on:
                return fn(*args, **kwargs)
            with TRACER.span(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def write_chrome_trace(session: Session, path: str) -> int:
    """``session`` as a chrome trace: begin/end events of every tree rooted
    at a "frame" span, in each thread's order (``ts`` in µs on the
    profiler's Unix timeline), and the session's summary (frames, spans,
    counters) under ``otherData``.  → the number of events."""
    kids: Dict[int, List[int]] = defaultdict(list)
    for i, r in enumerate(session.records):
        kids[r.parent].append(i)
    for v in kids.values():
        v.sort(key=lambda i: (session.records[i].start_ns, i))
    tids: Dict[str, int] = {}
    events: List[Dict[str, Any]] = []

    def walk(i: int) -> None:
        r = session.records[i]
        tid = tids.setdefault(r.thread, len(tids))
        events.append(dict(name=r.name, ph="B", ts=r.start_ns * 1e-3, pid=0,
                           tid=tid))
        for j in kids.get(i, ()):
            walk(j)
        events.append(dict(name=r.name, ph="E", ts=r.end_ns * 1e-3, pid=0,
                           tid=tid))
    for i in kids.get(-1, ()):
        if session.records[i].name == "frame":
            walk(i)
    summary = dict(frames=session.frames, wall_s=session.wall_s,
                   clock=session.clock, spans=session.spans,
                   counters=session.counters)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "otherData": summary}, f)
    return len(events)


class StageTimer:
    """EMA wall-clock per named stage + counts.  The first sample of each
    stage (jit compile) is recorded separately, not mixed into the EMA."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema_ms: Dict[str, float] = {}
        self.first_ms: Dict[str, float] = {}
        self.count: Dict[str, int] = defaultdict(int)
        self.samples_ms: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = (time.perf_counter() - t0) * 1e3
            if name not in self.first_ms:
                self.first_ms[name] = dt
            else:
                prev = self.ema_ms.get(name)
                self.ema_ms[name] = dt if prev is None else \
                    (1 - self.alpha) * prev + self.alpha * dt
                self.samples_ms[name].append(dt)
            self.count[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for k in self.count:
            entry = dict(count=self.count[k],
                         first_ms=round(self.first_ms.get(k, 0.0), 3))
            if k in self.ema_ms:
                entry["ema_ms"] = round(self.ema_ms[k], 3)
                entry["median_ms"] = round(float(np.median(
                    self.samples_ms[k])), 3)
                entry["p90_ms"] = round(float(np.percentile(
                    self.samples_ms[k], 90)), 3)
            out[k] = entry
        return out


@contextlib.contextmanager
def device_profile(logdir: Optional[str]):
    """``torch.profiler`` trace (TensorBoard's format, a chrome trace JSON
    under ``logdir``) when logdir is given: the card's activity when CUDA is
    available, the host's otherwise.  Yields the profiler (None without
    logdir)."""
    if not logdir:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                logdir)) as prof:
        yield prof
