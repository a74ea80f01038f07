"""repro_torch.obs — metrics and tracing across serve, store and train.

Port of ``repro.obs``.  numpy and the standard library only, plus the
stream synchronize in the timing helpers' ``sync``:

  registry   counters / gauges / streaming histograms (fixed log-spaced
             buckets, p50/p95/p99/max, exact merge) behind a switch that
             starts disabled; ``bind(reg)`` scopes the module-level calls
             to one registry on the calling thread
  trace      ``span("stage")`` nestable timed stages and ``timeblock``,
             the one wall-clock idiom of the serve, train and pipeline
             loops (``tb.sync(x)`` waits for ``x``'s CUDA device inside
             the clock)
  export     ``metrics_snapshot/v1`` snapshots, the statsd line protocol
             and the periodic JSONL sink driven by ``tick()``
             (``close_sink()`` on loop exit lands the last partial window)
  fleet      cross-replica aggregation: ``FleetAggregator`` re-merges
             per-replica registries or snapshot streams bucket for bucket
             (fleet percentiles are union-stream percentiles, never a
             mean of per-replica ones); ``bind(reg)`` gives each replica
             of ``serve.fleet`` its own named registry

The drivers turn it on with ``--metrics-out PATH``
(``repro_torch.launch.serve``, ``repro_torch.launch.pipeline``; a
directory of per-source streams for ``repro_torch.launch.fleet``).  The
metric catalog and span taxonomy are the reference's,
docs/observability.md; the port records the same names.
"""

from repro_torch.obs.export import (  # noqa: F401
    JsonlSink,
    close_sink,
    flush,
    registry_from_snapshot,
    set_sink,
    snapshot,
    statsd_lines,
    tick,
)
from repro_torch.obs.fleet import (  # noqa: F401
    FleetAggregator,
    last_snapshot,
    merge_snapshots,
)
from repro_torch.obs.registry import (  # noqa: F401
    Histogram,
    Registry,
    bind,
    disable,
    enable,
    enabled,
    ensure_histograms,
    gauge,
    get_registry,
    inc,
    observe,
)
from repro_torch.obs.trace import (  # noqa: F401
    Span,
    Timeblock,
    current_path,
    span,
    timeblock,
)
