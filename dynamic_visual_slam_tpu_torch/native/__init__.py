"""ctypes bindings for the port's native runtime (queues, approximate-time
sync, tracer): a copy of the reference package's ``native`` with its
signatures and behaviour, built from this package's own ``runtime.cpp``
(``native/build.py``).  ``load`` returns None when the library cannot be
built; ``error`` then says why.  Callers that can do without it use the
pure-Python equivalents in pipeline/sync.py; the classes raise.

Two departures, neither visible in the bytes: ``NativeQueue.push`` hands
ctypes the payload's own buffer (no copy before the C++ side's), and
``pop`` copies the popped bytes out with ``ctypes.string_at`` (slicing a
ctypes array builds a Python list of ints first, which costs tens of ms on
a 720p frame)."""

from __future__ import annotations

import ctypes
import json
import threading
from typing import List, Optional, Tuple


class _SyncPair(ctypes.Structure):
    _fields_ = [("stamp_a", ctypes.c_double),
                ("id_a", ctypes.c_int64),
                ("id_b", ctypes.c_int64)]


class _TraceEvent(ctypes.Structure):
    _fields_ = [("t", ctypes.c_double),
                ("kind", ctypes.c_int32),
                ("tid", ctypes.c_int32),
                ("name", ctypes.c_char * 48)]


_lib = None
_lib_err: Optional[str] = None
_lock = threading.Lock()


def load() -> Optional[ctypes.CDLL]:
    """Load (building on demand) the native library; None on failure."""
    global _lib, _lib_err
    with _lock:
        if _lib is not None or _lib_err is not None:
            return _lib
        try:
            from dynamic_visual_slam_tpu_torch.native.build import (
                ensure_built)
            _lib = _declare(ctypes.CDLL(ensure_built()))
        except (OSError, RuntimeError) as e:
            _lib_err = str(e)
        return _lib


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, u64, i64, dbl = (ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64,
                        ctypes.c_double)
    sigs = {
        "dvs_queue_create": (p, [u64]),
        "dvs_queue_push": (None, [p, dbl, ctypes.c_char_p, u64]),
        "dvs_queue_pop": (i64, [p, dbl, ctypes.POINTER(dbl),
                                ctypes.POINTER(ctypes.c_uint8), u64]),
        "dvs_queue_size": (u64, [p]),
        "dvs_queue_dropped": (u64, [p]),
        "dvs_queue_close": (None, [p]),
        "dvs_queue_destroy": (None, [p]),
        "dvs_sync_create": (p, [u64, dbl, ctypes.c_int, ctypes.c_int]),
        "dvs_sync_push_a": (None, [p, dbl, i64]),
        "dvs_sync_push_b": (None, [p, dbl, i64]),
        "dvs_sync_poll": (i64, [p, ctypes.POINTER(_SyncPair), i64]),
        "dvs_sync_destroy": (None, [p]),
        "dvs_trace_create": (p, [u64]),
        "dvs_trace_record": (None, [p, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_char_p]),
        "dvs_trace_dump": (i64, [p, ctypes.POINTER(_TraceEvent), i64]),
        "dvs_trace_destroy": (None, [p]),
        "dvs_now": (dbl, []),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def available() -> bool:
    return load() is not None


def error() -> Optional[str]:
    """Why the library could not be built or loaded (None if it was)."""
    load()
    return _lib_err


def _require() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError(f"native runtime unavailable: {_lib_err}")
    return lib


class NativeQueue:
    """Bounded drop-oldest byte queue (thread-safe, blocking pop).  A
    payload longer than ``max_item`` pops cut to its first ``max_item``
    bytes, as the reference's does."""

    def __init__(self, depth: int = 30, max_item: int = 1 << 20):
        self._lib = _require()
        self._h = ctypes.c_void_p(self._lib.dvs_queue_create(depth))
        self._buf = (ctypes.c_uint8 * max_item)()

    def push(self, stamp: float, payload: bytes) -> None:
        payload = bytes(payload)
        self._lib.dvs_queue_push(self._h, stamp, payload, len(payload))

    def pop(self, timeout: float = 1.0) -> Optional[Tuple[float, bytes]]:
        stamp = ctypes.c_double()
        n = self._lib.dvs_queue_pop(self._h, timeout, ctypes.byref(stamp),
                                    self._buf, len(self._buf))
        if n < 0:
            return None
        # the C++ side copies at most len(buf) bytes but returns the
        # payload's whole length
        return stamp.value, ctypes.string_at(self._buf,
                                             min(n, len(self._buf)))

    def __len__(self) -> int:
        return int(self._lib.dvs_queue_size(self._h))

    @property
    def dropped(self) -> int:
        return int(self._lib.dvs_queue_dropped(self._h))

    def close(self) -> None:
        self._lib.dvs_queue_close(self._h)

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.dvs_queue_destroy(self._h)


class NativeSync:
    """Two-stream approximate-time pairing (ids in, matched id pairs out)."""

    def __init__(self, queue_size: int = 10, slop: float = 0.05,
                 b_optional: bool = False, timeout_entries: int = 2):
        self._lib = _require()
        self._h = ctypes.c_void_p(self._lib.dvs_sync_create(
            queue_size, slop, int(b_optional), timeout_entries))
        self._out = (_SyncPair * 64)()

    def push_a(self, stamp: float, ident: int) -> None:
        self._lib.dvs_sync_push_a(self._h, stamp, ident)

    def push_b(self, stamp: float, ident: int) -> None:
        self._lib.dvs_sync_push_b(self._h, stamp, ident)

    def poll(self) -> List[Tuple[float, int, Optional[int]]]:
        n = self._lib.dvs_sync_poll(self._h, self._out, 64)
        return [(p.stamp_a, p.id_a, None if p.id_b < 0 else p.id_b)
                for p in self._out[:n]]

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.dvs_sync_destroy(self._h)


class NativeTracer:
    """Chrome-trace event recorder backed by the native ring buffer."""

    BEGIN, END, INSTANT = 0, 1, 2

    def __init__(self, capacity: int = 65536):
        self._lib = _require()
        self._h = ctypes.c_void_p(self._lib.dvs_trace_create(capacity))
        self._cap = capacity

    def begin(self, name: str, tid: int = 0) -> None:
        self._lib.dvs_trace_record(self._h, self.BEGIN, tid, name.encode())

    def end(self, name: str, tid: int = 0) -> None:
        self._lib.dvs_trace_record(self._h, self.END, tid, name.encode())

    def instant(self, name: str, tid: int = 0) -> None:
        self._lib.dvs_trace_record(self._h, self.INSTANT, tid, name.encode())

    def span(self, name: str, tid: int = 0):
        tracer = self

        class _Span:
            def __enter__(self):
                tracer.begin(name, tid)

            def __exit__(self, *a):
                tracer.end(name, tid)
        return _Span()

    def dump_chrome_trace(self, path: str) -> int:
        out = (_TraceEvent * self._cap)()
        n = self._lib.dvs_trace_dump(self._h, out, self._cap)
        phases = {0: "B", 1: "E", 2: "i"}
        events = [dict(name=e.name.decode(errors="replace"),
                       ph=phases[e.kind], ts=e.t * 1e6, pid=0, tid=e.tid)
                  for e in out[:n]]
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)
        return n

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.dvs_trace_destroy(self._h)
