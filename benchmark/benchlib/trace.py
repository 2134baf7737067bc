"""The device trace of a traced run: ``torch.profiler`` over the window's
first steps, read from the profiler's raw event list, or, where this
PyTorch gives its events no activity type, from the Chrome trace it writes
into the checkout's cache directory (a trace of many steps runs to
hundreds of megabytes), read back and deleted.

From it: kernel time and launches by kernel name, the device's busy time
(the union of kernel, copy and set intervals), the profiled window's
length, and the device's idle time, each gap put down to the innermost
layer range (``layer:<name>``, from ``probes``) that the host was inside at
the gap's middle and summed by layer.
"""

from __future__ import annotations

import collections
import gc
import json
import os
from pathlib import Path
from typing import Any, Dict, Iterable, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def start(cuda: bool = True):
    """A started profiler: host and (``cuda``) device activity."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=acts,
        record_shapes=False, with_stack=False, profile_memory=False)
    prof.__enter__()
    return prof


def _events(res, path: Path) -> Iterable[Tuple[str, str, float, float]]:
    """(category, name, start, duration) of every complete event of the
    profiler's raw results, in microseconds: from the events themselves
    where this PyTorch gives them an activity type, else from the Chrome
    trace that the results write (read back and deleted)."""
    import torch
    if hasattr(torch._C._autograd._KinetoEvent, "activity_type"):
        return ((e.activity_type(), e.name(), e.start_ns() * 1e-3,
                 e.duration_ns() * 1e-3) for e in res.events())
    path.parent.mkdir(parents=True, exist_ok=True)
    res.save(str(path))
    try:
        with open(path) as f:
            chrome = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return [(e.get("cat", ""), e.get("name", "?"), float(e.get("ts", 0.0)),
             float(e.get("dur", 0.0))) for e in chrome if e.get("ph") == "X"]


def stop(prof, path: Path) -> Dict[str, Any]:
    """End the profiler and read its trace (see ``read``).  The profiler is
    stopped underneath ``prof``, so that no Python event objects are built
    (some PyTorch versions build them on ``__exit__``: minutes for a trace
    of a million launches), and with the garbage collector off: millions of
    short-lived objects and no cycles."""
    import torch
    from torch.autograd.profiler import _disable_profiler
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    gc_was = gc.isenabled()
    gc.disable()
    try:
        return read(_events(_disable_profiler(), path))
    finally:
        if gc_was:
            gc.enable()


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def read(events: Iterable[Tuple[str, str, float, float]]) -> Dict[str, Any]:
    """Complete events (category, name, start, duration; microseconds, as
    a Chrome trace's ``cat``, ``name``, ``ts`` and ``dur``) → ``kernels`` {name:
    [launches, seconds]}, ``launches``, ``busy_s``, ``window_s``,
    ``idle_gaps`` [[layer, seconds]] (longest first) and ``device_ops``
    [[name, seconds]] (most time first)."""
    kernels: Dict[str, List[float]] = collections.defaultdict(
        lambda: [0, 0.0])
    dev: List[Tuple[float, float]] = []
    ranges: List[Tuple[float, float, str]] = []
    host_lo, host_hi = float("inf"), float("-inf")
    for cat, name, ts, dur in events:
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
            if cat == "kernel":
                k = kernels[name]
                k[0] += 1
                k[1] += dur * 1e-6
        elif cat in ("cpu_op", "user_annotation", "cuda_runtime",
                     "cuda_driver"):
            host_lo, host_hi = min(host_lo, ts), max(host_hi, ts + dur)
            if cat == "user_annotation" and name.startswith("layer:"):
                ranges.append((ts, ts + dur, name[len("layer:"):]))
    busy = _union(dev)
    lo = min([host_lo] + [a for a, _ in busy[:1]])
    hi = max([host_hi] + [b for _, b in busy[-1:]])
    window_s = max(hi - lo, 0.0) * 1e-6
    gaps = [(b0, a1) for (_, b0), (a1, _) in zip(busy[:-1], busy[1:])]
    if busy:
        gaps = [(lo, busy[0][0])] + gaps + [(busy[-1][1], hi)]
    ranges.sort()
    by_layer: Dict[str, float] = collections.defaultdict(float)
    longest: List[Tuple[float, str]] = []
    stack: List[Tuple[float, float, str]] = []
    i = 0
    # host ranges nest (one thread), so the innermost open range at a
    # gap's middle is the top of a stack swept along in time
    for a, b in gaps:
        t = 0.5 * (a + b)
        while i < len(ranges) and ranges[i][0] <= t:
            while stack and stack[-1][1] < ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        name = stack[-1][2] if stack else "host"
        by_layer[name] += (b - a) * 1e-6
        longest.append(((b - a) * 1e-6, name))
    longest.sort(reverse=True)
    return {
        "kernels": {k: v for k, v in kernels.items()},
        "launches": int(sum(v[0] for v in kernels.values())),
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "window_s": window_s,
        "idle_gaps": sorted(([k, v] for k, v in by_layer.items()),
                            key=lambda x: -x[1])[:TOP],
        "longest_gaps": [[name, w] for w, name in longest[:TOP]],
        "device_ops": sorted(([k, v[1]] for k, v in kernels.items()),
                             key=lambda x: -x[1])[:TOP],
    }
