"""The fleet CLI: ``python -m repro_torch.launch.fleet --replicas 1,2,4,8``.

Port of ``repro/launch/fleet.py``.  Scales the multi-replica serving
fabric (``repro_torch.serve.fleet``) across a sweep of replica counts
under one synthetic drifting-zipf request stream and prints a
``bench_fleet/v1`` record.  For each replica count:

1. build N ``OnlineServer`` replicas over ONE snapped store: the fp32
   table tensor is shared, each replica packs its own store from it
   (``PackedBackend`` -> ``pack``, through ``rowwise_quant``), with its
   own named metrics registry;
2. route ``--requests`` single-user requests through the router
   (``--policy round_robin | least_outstanding``), with staggered re-tiers
   every ``--retier-every`` requests (``--retier-async``: shadow builds)
   and a cross-replica Eq. 7 priority merge every ``--merge-every``;
3. aggregate: fleet percentiles from the exact cross-replica histogram
   merge (``obs.FleetAggregator``), router overhead from the timed
   routing decision, priority divergence before and after the merges,
   tier-occupancy skew and swap co-scheduling from the fleet gauges.

Each fleet is released before the next is built.  A replica's forward is
the reference's: ``globalize``, ``cached_lookup`` over ``lookup_fused``
(one tiered ``dequant_bag`` launch), ``model.head``, then
``server.observe(gidx, int(hits), valid=, count=)``
(``serve.loop.microbatch_serve_fn``); dense features of a replica's
batch ``r`` come from seed ``20_000 + r``, one counter a replica, as the
reference draws them.  There is no fused head (the reference has none
here) and no forward warm-up: the reference's warm-up compiles its jitted
forward, and eager torch has nothing to compile.

``--model smoke`` (the default) is the reference's size; ``--model full``
serves the published widths (wide-deep 22,216,000 rows x 32, xdeepfm
86,709,150 x 10, dlrm-rm2 204,185,088 x 64).  Before anything is built,
the sweep's largest fleet is counted against the device's memory: the
fp32 table once, and a replica's pack at the plan's byte budget (half
the fp32 bytes) plus its int32 merge window; dlrm-rm2 at full width
holds one replica on an 80 GB card and is refused above it.  The run is
on the GPU unless ``--device cpu`` is given.

The replicas timeshare one device, so ``aggregate_qps`` is the capacity
sum (each replica's steady QPS over its own busy time): what N
independent hosts would deliver (``serve.fleet``; the router's cost is
measured, as ``router_overhead_frac``).

``--metrics-out DIR`` writes one ``metrics_snapshot/v1`` JSONL stream a
source (``replicasN_replica0.jsonl`` ... ``replicasN_router.jsonl``) and
the merged fleet stream (``replicasN_fleet.jsonl``); the reference's
``tools/summarize_metrics.py`` re-merges them.  The last stdout line is
the ``bench_fleet/v1`` record (the reference's keys); ``--emit PATH``
also writes it to a file (``python tools/check_bench_schema.py PATH``
validates it).  The repository root's ``BENCH_fleet.json`` is the JAX
package's record: emit elsewhere.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable

import numpy as np
import torch

from repro_torch import configs, obs, resolve_device
from repro_torch.launch.serve import online_store
from repro_torch.serve.fleet import (ROUTER_POLICIES, Fleet, FleetConfig,
                                     Replica, run_fleet)
from repro_torch.serve.loop import (MicroBatch, drifting_zipf_batch,
                                    microbatch_serve_fn)
from repro_torch.serve.online import OnlineConfig, OnlineServer


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="Sweep a fleet of online serving replicas.")
    ap.add_argument("--arch", default="dlrm-rm2", choices=configs.names())
    ap.add_argument("--requests", type=int, default=256,
                    help="single-user requests a replica-count run (one "
                         "shared drifting-zipf stream)")
    ap.add_argument("--serve-batch", type=int, default=8,
                    help="micro-batch capacity a replica")
    ap.add_argument("--replicas", default="1,2,4,8",
                    help="comma-separated replica counts to sweep")
    ap.add_argument("--policy", default="round_robin",
                    choices=ROUTER_POLICIES)
    ap.add_argument("--merge-every", type=int, default=64,
                    help="fleet requests between cross-replica Eq. 7 "
                         "priority merges (0 = never merge)")
    ap.add_argument("--retier-every", type=int, default=64,
                    help="a replica's re-tier cadence in fleet requests, "
                         "staggered across replicas (0 = never)")
    ap.add_argument("--retier-async", action="store_true",
                    help="shadow-build re-tiers off the request path "
                         "(repro_torch.serve.shadow) instead of inline "
                         "repacks")
    ap.add_argument("--cache-rows", type=int, default=128,
                    help="top-K fp32 hot rows a replica (0 disables)")
    ap.add_argument("--drift", type=float, default=4.0,
                    help="zipf hot-set drift in ids/request")
    ap.add_argument("--metrics-out", default=None, metavar="DIR",
                    help="write per-source metrics_snapshot/v1 JSONL "
                         "streams (one a replica + router + the merged "
                         "fleet) into this directory")
    ap.add_argument("--emit", default=None, metavar="PATH",
                    help="also write the bench_fleet/v1 record here")
    ap.add_argument("--model", default="smoke", choices=("smoke", "full"),
                    help="smoke = the reference's size, full = the "
                         "published widths")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises when absent)")
    args = ap.parse_args(argv)
    try:
        counts = sorted({int(c) for c in args.replicas.split(",") if c})
    except ValueError:
        counts = []
    if not counts or min(counts) < 1:
        ap.error("--replicas needs positive integers")
    args.replica_counts = counts
    return args


def fleet_bytes(spec, replicas: int) -> int:
    """Device bytes a fleet of ``replicas`` needs, counted before anything
    is built: the shared fp32 table, and a replica's pack at the plan's
    byte budget (half the fp32 bytes) plus its int32 merge window."""
    fp32 = spec.total_rows * spec.dim * 4
    return fp32 + replicas * (fp32 // 2 + 4 * spec.total_rows)


def device_bytes(device: torch.device) -> int:
    """The memory of ``device``: the card's, or the host's RAM."""
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def run(args: argparse.Namespace, *, state: tuple | None = None,
        after_batch: Callable | None = None,
        on_entry: Callable | None = None) -> dict:
    """The sweep as ``args`` say; returns the ``bench_fleet/v1`` record.

    ``state`` = (head params, snapped ``QATStore``, ``FQuantConfig``)
    replaces the reference's random start (``launch.serve.online_store``).
    ``after_batch(replica, mb, served)``, when given, runs after each
    micro-batch's timed window and its window count: ``served`` holds the
    batch's ``packed``, ``gidx``, ``emb`` and ``logits``
    (``serve.loop.microbatch_serve_fn``; ``replica._retiered[-1]`` says
    whether the batch re-tiered).  ``on_entry(n, fleet, result)``, when
    given, runs after each replica count's run, before its fleet is
    released."""
    device = resolve_device(args.device)
    arch = configs.get(args.arch)
    if arch.family != "recsys" or arch.seq_model:
        raise SystemExit("the fleet CLI serves field-based recsys archs only")
    full = args.model == "full"
    model = arch.model if full else arch.smoke_model
    num_dense = arch.num_dense if full else arch.smoke_num_dense
    spec = model.spec
    need, have = fleet_bytes(spec, max(args.replica_counts)), \
        device_bytes(device)
    if need > have:
        raise SystemExit(
            f"--arch {args.arch} --model {args.model}: "
            f"{max(args.replica_counts)} replicas need ~{need / 1e9:.1f} GB "
            f"(the fp32 table once, a pack and a merge window a replica) "
            f"and {device} has {have / 1e9:.1f} GB")
    params, store, cfg = (online_store(model, spec, device)
                          if state is None else state)
    cards = np.asarray(spec.cardinalities, np.int64)
    offsets = np.asarray(spec.offsets(), np.int64)

    def make_replica(rid: int) -> Replica:
        server = OnlineServer(
            store, cfg,
            OnlineConfig(cache_rows=args.cache_rows,
                         retier_every=0,   # the FLEET schedules
                                           # (staggered) re-tiers
                         retier_async=args.retier_async))
        served = {} if after_batch is not None else None
        serve_fn = microbatch_serve_fn(server, model, spec, params,
                                       num_dense=num_dense, served=served)
        kw = dict(globalize=lambda idx: idx.astype(np.int64)
                  + offsets[None, :])
        if after_batch is None:
            return Replica(rid, server, serve_fn, args.serve_batch,
                           spec.num_fields, **kw)
        return _Hooked(rid, server, serve_fn, args.serve_batch,
                       spec.num_fields, after_batch=after_batch,
                       served=served, **kw)

    if args.metrics_out:
        os.makedirs(args.metrics_out, exist_ok=True)

    sweep = []
    for n in args.replica_counts:
        fleet = Fleet([make_replica(i) for i in range(n)],
                      FleetConfig(policy=args.policy,
                                  serve_batch=args.serve_batch,
                                  merge_every=args.merge_every,
                                  retier_every=args.retier_every))
        paths = None
        if args.metrics_out:
            paths = [os.path.join(args.metrics_out,
                                  f"replicas{n}_replica{i}.jsonl")
                     for i in range(n)]
            paths.append(os.path.join(args.metrics_out,
                                      f"replicas{n}_router.jsonl"))
        res = run_fleet(
            fleet,
            lambda r: drifting_zipf_batch(
                cards, 1, r, args.requests, drift=args.drift)[0],
            args.requests, jsonl_paths=paths)
        if args.metrics_out:
            # the merged fleet stream: the same schema, one line, equal to
            # re-merging the per-source lines offline
            obs.JsonlSink(os.path.join(
                args.metrics_out, f"replicas{n}_fleet.jsonl")).write(
                    fleet.aggregate().merged())
        if on_entry is not None:
            on_entry(n, fleet, res)
        del fleet                   # released before the next is built
        entry = res.as_dict()
        sweep.append(entry)
        print(f"replicas={n}: aggregate {entry['aggregate_qps']:.0f} "
              f"qps, fleet p50 {entry['p50_us']:.0f}us "
              f"p99 {entry['p99_us']:.0f}us, route p50 "
              f"{entry['route_p50_us']:.1f}us "
              f"({entry['router_overhead_frac']:.2%} of per-request "
              f"p50), merges {entry['merges']}, divergence "
              f"{entry['divergence_premerge']:.4f} -> "
              f"{entry['divergence']:.4f}", flush=True)

    rec = {"schema": "bench_fleet/v1", "benchmark": "fleet",
           "arch": args.arch, "policy": args.policy,
           "serve_batch": args.serve_batch, "requests": args.requests,
           "merge_every": args.merge_every,
           "retier_every": args.retier_every,
           "retier_async": bool(args.retier_async),
           "drift": args.drift, "sweep": sweep}
    if args.emit:
        with open(args.emit, "w") as f:
            json.dump(rec, f, indent=1, sort_keys=True)
        print(f"wrote {args.emit}")
    return rec


class _Hooked(Replica):
    """A replica that hands each micro-batch to ``after_batch`` after its
    window (``run``'s audit hook)."""

    def __init__(self, *args, after_batch: Callable, served: dict, **kw):
        super().__init__(*args, **kw)
        self.after_batch = after_batch
        self.served = served

    def run_batch(self, mb: MicroBatch) -> None:
        super().run_batch(mb)
        self.after_batch(self, mb, self.served)
        self.served.clear()


def main(argv=None) -> dict:
    """The CLI: the record is the last stdout line; the metrics sink is
    closed on every exit path (the CLIs' ``close_sink`` contract)."""
    try:
        rec = run(parse_args(argv))
        print(json.dumps(rec))
        return rec
    finally:
        obs.close_sink()


if __name__ == "__main__":
    main()
