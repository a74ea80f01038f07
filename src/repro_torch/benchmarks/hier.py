"""Hierarchical-store serving sweep: miss rate and QPS against the device
budget, the ``bench_hier/v1`` record.

    python -m repro_torch.benchmarks.hier [--fast] [--emit PATH] \\
        [--fractions F,...] [--requests N] [--serve-batch N] \\
        [--retier-async] [--device cpu]

Port of ``benchmarks/hier.py``.  The same drifting-zipf single-user
stream is served from the same initial store (the bench DLRM,
``benchmarks.qps._bench_store``) at a range of device budget fractions:
the hot level gets ``frac`` of the fully packed bytes, the warm level the
same budget, and the rest spills to mmap'd cold shards.  Each entry
records the loop's QPS and percentiles and where the lookups were
resolved: fp32 cache, hot level, host RAM or disk.  Placement is a
priority prefix (``store.budget.plan_placement``), so a larger budget's
hot set holds a smaller one's and ``hier_miss_rate`` (warm + cold hits
over lookups) does not rise with the fraction;
``tools/check_bench_schema.py`` holds the record to that.
``--retier-async`` migrates by chunked shadow builds and swaps
(``serve.shadow.ShadowMigrate``) instead of synchronously.  The cold
shards go to a temporary directory of the sweep's own (``store_dir=``
picks another), removed when it ends.  The times are the device's (the
card's unless ``--device cpu``); the record adds ``device`` and
``device_name``.  Nothing is written without ``--emit``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

from repro_torch.benchmarks.qps import (_bench_store, _device_keys,
                                        write_bench_json)
from repro_torch.core import packed_store as ps

BENCH_SCHEMA = "bench_hier/v1"

SWEEP_KEYS = ("qps", "steady_qps", "p50_us", "p95_us", "p99_us",
              "lookups",
              "latency_p50", "latency_p95", "latency_p99",
              "p99_retier_attributed", "p99_while_retiering",
              "swaps", "shadow_builds",
              "cache_hit_rate", "hier_miss_rate", "warm_hits",
              "cold_hits", "staged_rows", "migrations", "promoted",
              "demoted", "hot_rows", "warm_rows", "cold_rows")


def run_hier_sweep(fractions=(0.05, 0.15, 0.4, 1.0), requests=256,
                   serve_batch=8, cache_rows=64, retier_every=64,
                   drift=4.0, ratio=0.5, a=1.2, seed=0, store_dir=None,
                   retier_async=False, *, params: dict | None = None,
                   device=None) -> dict:
    """One ``bench_hier/v1`` record over device budget fractions (the
    reference's arguments; ``params`` replaces the bench model's drawn
    weights, as in ``benchmarks.qps``).  ``cache_rows`` stays small so
    the sweep exercises the spill path."""
    from repro_torch.serve.loop import serve_forward_hier
    from repro_torch.serve.online import OnlineConfig, OnlineServer
    from repro_torch.store.hier import HierConfig

    setup, spec, params, store, cfg = _bench_store(ratio, params=params,
                                                   device=device)
    fp32 = spec.total_rows * spec.dim * 4
    full_bytes = ps.pack(store, cfg).nbytes()
    with tempfile.TemporaryDirectory(prefix="bench_hier_") as tmp:
        base_dir = store_dir or tmp
        sweep = []
        for frac in fractions:
            budget = max(1, int(full_bytes * float(frac)))
            server = OnlineServer(
                store, cfg,
                OnlineConfig(cache_rows=cache_rows,
                             retier_every=retier_every,
                             retier_async=retier_async),
                hier=HierConfig(
                    hbm_budget_bytes=budget, host_budget_bytes=budget,
                    store_dir=os.path.join(base_dir, f"frac_{frac}")))
            result = serve_forward_hier(
                server, setup.model, spec, params, serve_batch=serve_batch,
                requests=requests, drift=drift, a=a,
                num_dense=setup.ds.cfg.num_dense, seed=seed)
            server.drain_shadow()   # finish any shadow build in flight
            entry = {"hbm_budget_fraction": float(frac),
                     "hbm_budget_bytes": budget}
            d = result.as_dict()
            entry.update({k: d[k] for k in SWEEP_KEYS})
            sweep.append(entry)
            del server
    rec = {"schema": BENCH_SCHEMA, "benchmark": "hier_budget_sweep",
           "requests": requests, "serve_batch": serve_batch,
           "cache_rows": cache_rows, "retier_every": retier_every,
           "drift": drift, "retier_async": retier_async,
           "full_store_bytes": int(full_bytes),
           "packed_fp32_ratio": round(full_bytes / fp32, 4),
           "sweep": sweep}
    rec.update(_device_keys(setup.device))
    return rec


def sweep_budgets(fast: bool) -> dict:
    """The reference's fractions and requests (``--fast``: its reduced
    ones, as its runner's ``--emit BENCH_hier.json`` uses them)."""
    return {"fractions": (0.1, 0.5) if fast else (0.05, 0.15, 0.4, 1.0),
            "requests": 64 if fast else 256}


def run(fast: bool = False, device=None) -> list[dict]:
    """The runner's CSV rows from a sweep."""
    rec = run_hier_sweep(**sweep_budgets(fast), device=device)
    return [{"metric": f"hier_frac{e['hbm_budget_fraction']}",
             "value": e["steady_qps"],
             "miss_rate": e["hier_miss_rate"],
             "hot_rows": e["hot_rows"], "cold_rows": e["cold_rows"]}
            for e in rec["sweep"]]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fast", action="store_true",
                    help="the reference's reduced budgets")
    ap.add_argument("--fractions", default=None, metavar="F[,F...]")
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--serve-batch", type=int, default=8)
    ap.add_argument("--retier-async", action="store_true",
                    help="chunked shadow migrations and swaps instead of "
                         "the synchronous migrate")
    ap.add_argument("--emit", default=None, metavar="PATH",
                    help="write the bench_hier/v1 record to PATH")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises when absent)")
    args = ap.parse_args(argv)
    fracs = (tuple(float(x) for x in args.fractions.split(","))
             if args.fractions else
             ((0.1, 0.5, 1.0) if args.fast else (0.05, 0.15, 0.4, 1.0)))
    rec = run_hier_sweep(
        fractions=fracs,
        requests=args.requests or (64 if args.fast else 256),
        serve_batch=args.serve_batch, retier_async=args.retier_async,
        device=args.device)
    if args.emit:
        write_bench_json(rec, args.emit)
    print(json.dumps(rec))
    if args.emit:
        print(f"wrote {args.emit}")
    return rec


if __name__ == "__main__":
    main()
