"""Streaming histogram over fixed log-spaced buckets.

A numpy-only copy of ``Histogram`` and its bucket layout from
``repro/obs/registry.py`` (the counters, gauges, registry and sinks come
with a later slice).  One global layout (32 buckets per decade over
[1, 1e9] — microseconds from 1 us to ~17 min — plus an underflow bucket),
so histograms of one metric merge exactly.  Percentiles interpolate
inside the bucket and clamp to the exact [min, max] seen.
"""

from __future__ import annotations

import math

import numpy as np

BUCKETS_PER_DECADE = 32
DECADES = 9
LO = 1.0                       # first finite edge (1 us when timing)
NUM_BUCKETS = BUCKETS_PER_DECADE * DECADES + 1   # +1 underflow [0, LO)
RATIO = 10.0 ** (1.0 / BUCKETS_PER_DECADE)
_LOG_RATIO = math.log(RATIO)


def bucket_index(value: float) -> int:
    """Bucket holding ``value``: 0 is the underflow [0, LO); bucket i>0
    covers [LO*RATIO^(i-1), LO*RATIO^i); the top bucket absorbs
    overflow."""
    if value < LO:
        return 0
    i = int(math.log(value / LO) / _LOG_RATIO) + 1
    return min(i, NUM_BUCKETS - 1)


def bucket_edges(i: int) -> tuple[float, float]:
    """[lo, hi) edges of bucket ``i`` (underflow reports lo=0)."""
    if i <= 0:
        return 0.0, LO
    return LO * RATIO ** (i - 1), LO * RATIO ** i


class Histogram:
    """Streaming histogram: exact count/sum/min/max, bucket-resolution
    percentiles clamped into the exact [min, max] envelope."""

    __slots__ = ("counts", "count", "total", "vmin", "vmax")

    def __init__(self):
        self.counts = np.zeros(NUM_BUCKETS, np.int64)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def record(self, value: float) -> None:
        v = float(value)
        self.counts[bucket_index(v)] += 1
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def record_many(self, values) -> None:
        for v in np.asarray(values, np.float64).reshape(-1):
            self.record(v)

    def percentile(self, q: float) -> float:
        """q in [0, 100].  0.0 on an empty histogram."""
        if self.count == 0:
            return 0.0
        target = (q / 100.0) * self.count
        cum = np.cumsum(self.counts)
        b = int(np.searchsorted(cum, target, side="left"))
        b = min(b, NUM_BUCKETS - 1)
        lo, hi = bucket_edges(b)
        prev = float(cum[b - 1]) if b > 0 else 0.0
        frac = (target - prev) / max(float(self.counts[b]), 1.0)
        est = lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        return float(min(max(est, self.vmin), self.vmax))
