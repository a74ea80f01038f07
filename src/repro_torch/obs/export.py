"""Snapshot and statsd exporters for the metrics registry.

Port of ``repro/obs/export.py``: the same ``metrics_snapshot/v1`` lines,
with the same ``seq`` / ``ticks`` cadence.  ``snapshot(reg)`` freezes
the registry into one record (``tools/check_bench_schema.py`` validates
it):

    {"schema": "metrics_snapshot/v1", "seq": N, "ticks": T,
     "counters":   {name: number, ...},
     "gauges":     {name: number, ...},
     "histograms": {name: {count, sum, min, max, p50, p95, p99,
                           buckets: {idx: count}}, ...}}

Snapshots of a *named* registry (``Registry(name="replica0")``) also
carry a ``"source"`` key.  ``buckets`` holds the sparse log-bucket
counts, so snapshots merge offline (``Histogram.from_snapshot(...)
.merge``); ``registry_from_snapshot`` rebuilds a live ``Registry`` from
one record, and reads the reference's snapshots as well as the port's.

``statsd_lines(reg)`` renders the statsd line protocol (counters ``|c``,
gauges ``|g``, histogram percentiles as derived gauges).

``JsonlSink`` appends snapshots to a JSONL file; attach one with
``set_sink`` and call ``tick()`` once a loop iteration: every ``every``
ticks (and on ``flush``) one line is written.  Without a sink, or with
metrics disabled, ``tick`` is a flag check.  Drivers call
``close_sink()`` on every exit path (in a ``finally``): it writes the
last partial window of ticks.  A sink that cannot write raises; nothing
catches it.
"""

from __future__ import annotations

import json

from repro_torch.obs.registry import Histogram, Registry, get_registry

SCHEMA = "metrics_snapshot/v1"


def snapshot(reg: Registry | None = None) -> dict:
    reg = reg or get_registry()
    reg.seq += 1
    rec = {
        "schema": SCHEMA,
        "seq": int(reg.seq),
        "ticks": int(reg.ticks),
        "counters": {k: (int(v) if float(v).is_integer() else float(v))
                     for k, v in sorted(reg.counters.items())},
        "gauges": {k: float(v) for k, v in sorted(reg.gauges.items())},
        "histograms": {k: h.snapshot()
                       for k, h in sorted(reg.histograms.items())},
    }
    if reg.name is not None:
        rec["source"] = reg.name
    return rec


def registry_from_snapshot(snap: dict) -> Registry:
    """Rebuild a live ``Registry`` from one ``metrics_snapshot/v1``
    record: counters/gauges restored as numbers, histograms via
    ``Histogram.from_snapshot`` (bucket-exact).  The inverse of
    ``snapshot`` up to ``seq``/``ticks`` bookkeeping — merging two
    rebuilt registries (``Registry.merge``) is therefore exactly the
    cross-replica fold the in-process fleet aggregator runs."""
    reg = Registry(name=snap.get("source"))
    reg.ticks = int(snap.get("ticks", 0))
    for k, v in snap.get("counters", {}).items():
        reg.counters[k] = v
    for k, v in snap.get("gauges", {}).items():
        reg.gauges[k] = float(v)
    for k, h in snap.get("histograms", {}).items():
        reg.histograms[k] = Histogram.from_snapshot(h)
    return reg


def statsd_lines(reg: Registry | None = None) -> list[str]:
    reg = reg or get_registry()
    lines = [f"{k}:{v:g}|c" for k, v in sorted(reg.counters.items())]
    lines += [f"{k}:{v:g}|g" for k, v in sorted(reg.gauges.items())]
    for k, h in sorted(reg.histograms.items()):
        for q in (50, 95, 99):
            lines.append(f"{k}.p{q}:{h.percentile(q):g}|g")
        lines.append(f"{k}.count:{h.count}|g")
    return lines


class JsonlSink:
    """Appends one ``metrics_snapshot/v1`` line per flush."""

    def __init__(self, path: str, every: int = 0):
        """``every``: flush cadence in ticks (0 = only explicit
        ``flush`` calls)."""
        self.path = path
        self.every = int(every)
        self.last_write_ticks = -1     # registry ticks at the last
                                       # write (close_sink pending test)
        open(path, "w").close()        # truncate: one run per file

    def write(self, reg: Registry) -> None:
        self.last_write_ticks = reg.ticks
        with open(self.path, "a") as f:
            f.write(json.dumps(snapshot(reg), sort_keys=True) + "\n")


_sink: JsonlSink | None = None


def set_sink(sink: JsonlSink | None) -> None:
    global _sink
    _sink = sink


def tick(n: int = 1) -> None:
    """One loop-iteration heartbeat: drives the periodic in-loop flush.
    No-op unless metrics are enabled AND a sink with a cadence is set.
    """
    reg = get_registry()
    if not reg.enabled:
        return
    reg.ticks += n
    if _sink is not None and _sink.every > 0 \
            and reg.ticks % _sink.every == 0:
        _sink.write(reg)


def flush() -> None:
    """Write one snapshot line now (if metrics are on and a sink is
    attached)."""
    reg = get_registry()
    if reg.enabled and _sink is not None:
        _sink.write(reg)


def close_sink() -> None:
    """Terminal flush + detach: write the last *partial* tick window
    (ticks seen since the most recent periodic write — silently dropped
    before this existed) and clear the sink.  Idempotent, and a no-op
    when metrics are off or no sink is attached; drivers call it in a
    ``finally`` so error exits still land their final window."""
    global _sink
    reg = get_registry()
    if reg.enabled and _sink is not None \
            and reg.ticks != _sink.last_write_ticks:
        _sink.write(reg)
    _sink = None
