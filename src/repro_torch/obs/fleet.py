"""Cross-replica metrics aggregation: the fleet's view of N registries.

Port of ``repro/obs/fleet.py``.  Every serving replica of
``repro_torch.serve.fleet`` owns a *named* ``Registry`` (its metrics
namespace); this module folds N of them, live in-process objects or
``metrics_snapshot/v1`` JSONL records read back offline, into one fleet
view:

  counters    add across replicas (statsd ``|c`` semantics)
  histograms  merge bucket for bucket (``Histogram.merge`` /
              ``Histogram.from_snapshot``: integer bucket adds over the
              one fixed global layout), so fleet percentiles are the
              percentiles of the union latency stream, never the mean of
              per-replica percentiles (a replica with 1 request would
              weigh as much as one with 10k)
  gauges      namespaced ``<source>.<name>`` per replica (last write wins
              across replicas would clobber levels such as a replica's
              queue depth)

``FleetAggregator`` is the one implementation behind the live path
(``serve.fleet.Fleet.aggregate()``) and the offline one (the reference's
``tools/summarize_metrics.py`` re-merging snapshot files, which reads the
port's streams too): offline sources are rebuilt with
``export.registry_from_snapshot`` and fed through the same fold.
"""

from __future__ import annotations

import json

from repro_torch.obs.export import (registry_from_snapshot, snapshot,
                                    statsd_lines)
from repro_torch.obs.registry import Histogram, Registry


class FleetAggregator:
    """Folds N replica registries into one fleet-level registry.

    ``sources`` is a list of live ``Registry`` objects; for
    ``metrics_snapshot/v1`` records use ``from_snapshots``.  Unnamed
    sources get positional names (``r0``, ``r1``, ...) so their gauges
    stay apart.
    """

    def __init__(self, sources: list[Registry]):
        self.sources = list(sources)

    @classmethod
    def from_snapshots(cls, snaps: list[dict]) -> "FleetAggregator":
        """Offline construction from ``metrics_snapshot/v1`` records, one
        a replica: each stream's LAST line (snapshots are cumulative, so
        summing every line would count them many times)."""
        return cls([registry_from_snapshot(s) for s in snaps])

    def merged(self) -> Registry:
        """The fleet fold: counters add, histograms bucket-merge, gauges
        namespaced per source."""
        out = Registry(name="fleet")
        for i, src in enumerate(self.sources):
            label = src.name or f"r{i}"
            for k, v in src.counters.items():
                out.inc(k, v)
            for k, h in src.histograms.items():
                out.histogram(k).merge(h)
            for k, v in src.gauges.items():
                out.gauge(f"{label}.{k}", v)
            out.ticks += src.ticks
        return out

    def percentiles(self, name: str,
                    qs=(50, 95, 99)) -> tuple[float, ...]:
        """Fleet percentiles of histogram ``name`` from the exact bucket
        merge (an empty histogram reads 0.0, like ``Histogram``)."""
        h = Histogram()
        for src in self.sources:
            got = src.histograms.get(name)
            if got is not None:
                h.merge(got)
        return tuple(h.percentile(q) for q in qs)

    def snapshot(self) -> dict:
        """One merged ``metrics_snapshot/v1`` record (schema-valid, like
        the per-replica streams it came from)."""
        return snapshot(self.merged())

    def statsd(self) -> list[str]:
        """The merged registry in the statsd line protocol."""
        return statsd_lines(self.merged())


def merge_snapshots(snaps: list[dict]) -> dict:
    """Offline one-shot: merge per-replica ``metrics_snapshot/v1`` records
    into one fleet record (see ``FleetAggregator``)."""
    return FleetAggregator.from_snapshots(snaps).snapshot()


def last_snapshot(path: str) -> dict:
    """The final (cumulative) ``metrics_snapshot/v1`` record of one JSONL
    stream: the line an offline re-merge must use."""
    last = None
    with open(path) as f:
        for line in f:
            if line.strip():
                last = json.loads(line)
    if last is None:
        raise ValueError(f"{path}: no metrics_snapshot records")
    return last
