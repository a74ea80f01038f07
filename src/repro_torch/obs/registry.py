"""Metrics registry: counters, gauges, streaming histograms.

A numpy-only copy of ``repro/obs/registry.py`` (it keeps its own copy of
the bucket layout and imports nothing of ``repro``).  The registry is
the in-process sink the serve loops, the online server, the train loop
and the launch drivers report into.  Three metric kinds:

  counter    monotonically increasing int/float (``inc``)
  gauge      last-write-wins level (``gauge``)
  histogram  streaming distribution over FIXED log-spaced buckets
             (``observe``): p50/p95/p99/max read out at snapshot time

One global layout (32 buckets per decade over [1, 1e9] — microseconds
from 1 us to ~17 min — plus an underflow bucket), so histograms of one
metric merge exactly: bucket counts add, min/max combine.  Percentiles
interpolate inside the bucket and clamp to the exact [min, max] seen.
The same value stream gives the same ``snapshot()`` as the reference's.

The module-level default registry starts **disabled**: every ``inc`` /
``observe`` / ``span`` call is one flag check and allocates nothing
until a driver opts in (``--metrics-out`` or ``enable()``).  Snapshots
(``metrics_snapshot/v1``) and statsd lines are in ``obs.export``.
"""

from __future__ import annotations

import math
import threading

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
    """Streaming histogram over the fixed log-spaced buckets.

    Tracks count/sum/min/max exactly; percentiles are bucket-resolution
    estimates clamped into the exact [min, max] envelope.  ``merge`` is
    exact on bucket counts (int64 adds), so merged percentiles are the
    percentiles of the concatenated stream — associative and
    commutative up to float addition in ``sum``.
    """

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

    def merge(self, other: "Histogram") -> "Histogram":
        self.counts += other.counts
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        return self

    def snapshot(self) -> dict:
        """JSON-ready state: exact moments, bucket-resolution
        percentiles, and the sparse bucket counts (so snapshots from
        different replicas can be merged back via
        ``Histogram.from_snapshot(...).merge``)."""
        empty = self.count == 0
        return {
            "count": int(self.count),
            "sum": float(self.total),
            "min": 0.0 if empty else float(self.vmin),
            "max": 0.0 if empty else float(self.vmax),
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
            "buckets": {str(i): int(c)
                        for i, c in enumerate(self.counts) if c},
        }

    @classmethod
    def from_snapshot(cls, snap: dict) -> "Histogram":
        h = cls()
        for i, c in snap.get("buckets", {}).items():
            h.counts[int(i)] = int(c)
        h.count = int(snap["count"])
        h.total = float(snap["sum"])
        if h.count:
            h.vmin = float(snap["min"])
            h.vmax = float(snap["max"])
        return h


class Registry:
    """Named counters/gauges/histograms plus the enable switch.

    ``enabled`` gates the module-level convenience functions below (the
    hot-path contract: disabled => one attribute load + branch, no
    allocation).  Direct method calls on an explicit ``Registry`` /
    ``Histogram`` instance are NOT gated — benches that always need
    latency percentiles own their histogram objects directly.

    ``name`` labels the registry as a metrics *source* (one per serving
    replica of a fleet): snapshots of a named registry carry a
    ``"source"`` key, so per-replica streams stay attributable after
    they are concatenated.  The module-level default registry is
    anonymous.
    """

    def __init__(self, enabled: bool = True, name: str | None = None):
        self.enabled = enabled
        self.name = name
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, Histogram] = {}
        self.seq = 0          # snapshots emitted (JSONL line index)
        self.ticks = 0        # loop iterations seen (flush cadence)

    def inc(self, name: str, delta: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + delta

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram()
        h.record(value)

    def histogram(self, name: str) -> Histogram:
        """Get-or-create (pre-registering keeps the metric catalog
        stable: phases that never fire still appear in snapshots with
        count 0)."""
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram()
        return h

    def merge(self, other: "Registry") -> "Registry":
        """Fold another shard/replica's registry into this one:
        counters add, gauges last-write-wins, histograms merge."""
        for k, v in other.counters.items():
            self.inc(k, v)
        self.gauges.update(other.gauges)
        for k, h in other.histograms.items():
            self.histogram(k).merge(h)
        return self

    def reset(self) -> None:
        self.counters.clear()
        self.gauges.clear()
        self.histograms.clear()
        self.seq = 0
        self.ticks = 0


# -- module-level default registry (disabled until a driver opts in) ---

_default = Registry(enabled=False)

# thread-local registry binding: ``bind(reg)`` scopes the module-level
# convenience functions (and ``obs.span`` / ``obs.tick``) to an explicit
# registry, which is how a fleet of in-process replicas gives each its
# own metrics namespace without threading a registry handle through
# every instrumented call site.  Unbound threads (the default, and every
# driver here) keep reporting into ``_default``.
_tls = threading.local()


class _Bind:
    """Context manager pushing ``reg`` as the calling thread's current
    registry.  Re-entrant (a stack) and exception-safe."""

    __slots__ = ("reg",)

    def __init__(self, reg: Registry):
        self.reg = reg

    def __enter__(self) -> Registry:
        s = getattr(_tls, "stack", None)
        if s is None:
            s = _tls.stack = []
        s.append(self.reg)
        return self.reg

    def __exit__(self, exc_type, exc, tb) -> bool:
        _tls.stack.pop()
        return False


def bind(reg: Registry) -> _Bind:
    """Scope the module-level metrics functions to ``reg`` on this
    thread: ``with obs.bind(replica_registry): serve(...)``."""
    return _Bind(reg)


def get_registry() -> Registry:
    s = getattr(_tls, "stack", None)
    return s[-1] if s else _default


def enable() -> Registry:
    _default.enabled = True
    return _default


def disable() -> None:
    _default.enabled = False


def enabled() -> bool:
    return get_registry().enabled


def inc(name: str, delta: float = 1) -> None:
    reg = get_registry()
    if reg.enabled:
        reg.inc(name, delta)


def gauge(name: str, value: float) -> None:
    reg = get_registry()
    if reg.enabled:
        reg.gauge(name, value)


def observe(name: str, value: float) -> None:
    reg = get_registry()
    if reg.enabled:
        reg.observe(name, value)


def ensure_histograms(names) -> None:
    """Pre-register histogram names (no-op when disabled)."""
    reg = get_registry()
    if reg.enabled:
        for n in names:
            reg.histogram(n)
