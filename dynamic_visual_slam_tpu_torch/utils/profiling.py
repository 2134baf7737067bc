"""Profiling and tracing, as the reference package's ``utils/profiling``:

- StageTimer: per-stage wall-clock EMAs, which here also keeps every
  sample after the first and reports their median and 90th percentile;
- make_tracer(): the native chrome-trace ring buffer (native.NativeTracer);
- device_profile(): ``torch.profiler`` where the reference has
  ``jax.profiler``.

Unlike the reference's, ``make_tracer`` raises when the native runtime
cannot be built, with the compiler's message: ``cli run --trace`` then
fails (exit code 2) rather than run without writing a trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch


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


def make_tracer(capacity: int = 65536):
    """Native chrome-trace recorder; raises RuntimeError, with the
    compiler's message, when the native runtime cannot be built."""
    from dynamic_visual_slam_tpu_torch import native
    return native.NativeTracer(capacity)
