"""End-to-end arithmetic over a whole window: no chunks, no medians of
medians."""

from __future__ import annotations

import math
from typing import Sequence


def rate(count: int, seconds: float) -> float:
    """Results that came back over the window's wall time."""
    if seconds <= 0:
        raise ValueError("rate: the window has no length")
    return count / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile of every value: the smallest
    value with at least q % of the values at or below it."""
    if not values:
        raise ValueError("percentile: no values")
    xs = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1]
