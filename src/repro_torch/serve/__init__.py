"""repro_torch.serve: the online serving subsystem (port of ``repro.serve``).

Live, traffic-adaptive state over the stores of ``repro_torch.core``
(the tier-partitioned ``PackedStore``) and ``repro_torch.store`` (the
packed, hierarchical and hashed backends):

  cache    hot-row cache: the top-K rows by live priority in fp32, hit
           rate accounted, bit-identical to the packed gather
  online   ``OnlineServer``: the Eq. 7 fold a batch, periodic delta
           re-tiers (``packed_store.repack_delta``, or a migration across
           the hier store's levels) and the cache rebuild, on one device
  loop     request loops and their timing, the drifting-zipf workload,
           micro-batching (``MicroBatcher``: single-user requests padded
           and masked into fixed-shape batches, one forward a batch) and
           ``serve_forward``, the one backend-dispatched loop (the
           staged pipeline for the hier store, the cache-first forward
           for the resident backends)
  shadow   shadow re-tiers: ``ShadowRepack`` / ``ShadowMigrate`` build the
           next store generation in bounded chunks off the request path;
           ``OnlineServer`` swaps it in with one pointer flip
           (``OnlineConfig.retier_async``)
  fleet    N replicas (each with its own named metrics registry) behind a
           ``Router`` (round-robin / least-outstanding), staggered
           re-tiers, periodic cross-replica Eq. 7 priority merges and
           the fleet gauges (divergence, lag, tier skew, queue depth),
           aggregated exactly by ``obs.FleetAggregator``

Entry points: ``repro_torch.launch.serve --online`` (``--hbm-budget-mb``
for the hier store, ``--store-backend hashed``),
``repro_torch.launch.fleet`` (the replica sweep, ``bench_fleet/v1``) and
``repro_torch.benchmarks.qps --online``; ``--mesh N`` of the serve CLI
and ``repro_torch.benchmarks.qps_sharded`` serve row-sharded
(``OnlineServer(mesh=)``, ``repro_torch.dist``).

The names below are the reference's exports.  They load on first use
(PEP 562): ``store.api`` imports ``serve.cache`` while ``serve.online``
imports ``store.api``, so importing every submodule here would close an
import cycle for whoever imports ``repro_torch.store`` first.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "cache": ("HotRowCache", "build_cache", "cache_from_rows",
              "cache_select", "cached_lookup", "empty_cache"),
    "fleet": ("Fleet", "FleetConfig", "FleetResult", "Replica", "Router",
              "run_fleet"),
    "loop": ("LoopResult", "MicroBatch", "MicroBatcher",
             "drifting_zipf_batch", "run_loop", "run_microbatched_loop",
             "serve_forward", "serve_forward_hier", "serve_forward_loop",
             "serve_forward_microbatched", "stream_bytes_per_request"),
    "online": ("OnlineConfig", "OnlineServer", "ServeStats"),
    "shadow": ("ShadowMigrate", "ShadowRepack"),
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = sorted(_WHERE)


def __getattr__(name: str):
    mod = _WHERE.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(__all__))
