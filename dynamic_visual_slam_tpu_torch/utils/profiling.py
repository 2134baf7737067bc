"""Per-stage wall-clock timing: the reference package's
``utils/profiling.StageTimer``, which also keeps every sample after the
first and reports their median and 90th percentile."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np


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
