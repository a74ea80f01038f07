"""Benchmark runner: one job per paper table or figure, on the card.

    python -m repro_torch.benchmarks.run [--fast] [--only NAME] [--device cpu]
    python -m repro_torch.benchmarks.run --emit PATH [--fast] [--device cpu]
    python -m repro_torch.benchmarks.run --emit-pipeline PATH [--fast]

Port of ``benchmarks/run.py``.  The CSV jobs print ``name,us_per_call,
derived`` rows (``derived`` carries the table's payload as key=value
pairs), after one ``#`` line naming the reference's jobs not ported
yet.  The jobs are the paper's six (``table2_time``, ``table3_fquant``,
``fig3_thresholds``, ``table4_combined``, ``fig2_fperm``,
``freq_error``), the offline QPS proxy ``qps`` (``benchmarks.qps.run``),
the sharded serving sweep ``qps_sharded`` (``benchmarks.qps_sharded.run``:
meshes 1, 2, 4 of the smoke dlrm-rm2) and the hashed ratio sweep
``hashed``, at the reference's budgets (``--fast``: its reduced ones),
and ``roofline`` (``benchmarks.roofline.run``: the dry-run model, no
rows until a port module writes dry-run records).  They run on ``cuda``
unless ``--device cpu``, and raise without a GPU.  Unlike the reference,
a job's exception is not caught: it propagates and the process exits
non-zero.  ``--only`` with a job that waits (``WAITING``, empty now)
raises ``NotImplementedError`` naming its ROADMAP item, and the rows
start with a ``#`` line naming the waiting jobs while there are any.

``--emit PATH`` writes one record instead, dispatched on the basename
through ``benchmarks.manifest.COMMITTED_BENCH`` as the reference does:
``BENCH_qps.json`` the micro-batched sweep (``--serve-batches``,
``--retier-async``), ``BENCH_hier.json`` the hier store's budget sweep
(``benchmarks.hier``, ``--retier-async``), ``BENCH_pipeline.json`` the
pipeline's record (a false ``verify_*`` exits non-zero after writing),
``BENCH_hash.json`` the hashed sweep, ``BENCH_kernel.json`` the kernel
record (``benchmarks.kernels.run``, one timed window a candidate with
``--fast``, else two); ``BENCH_fleet.json`` exits naming its own command
(``python -m repro_torch.launch.fleet --emit BENCH_fleet.json``, as the
reference's runner does), any other name exits listing the manifest.
``--emit-pipeline PATH`` is ``--emit`` of the pipeline's record to
``PATH``.  The path is the caller's: nothing is written where it did not
say (the repository's ``BENCH_*.json`` are the JAX package's records).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Callable

# the reference's jobs not ported yet, with their ROADMAP Queue 1 items
WAITING: dict[str, str] = {}
# the manifest's records whose modules are not ported yet
EMIT_WAITING: dict[str, str] = {}


def jobs(fast: bool, device, audit=None
         ) -> dict[str, Callable[[], list[dict]]]:
    """The CSV jobs at the reference's budgets, on ``device``; ``audit``
    goes to ``qps.run``."""
    from repro_torch.benchmarks import (fig2_fperm, fig3_thresholds,
                                        freq_error, hashed, qps,
                                        qps_sharded, roofline, table2_time,
                                        table3_fquant, table4_combined)
    return {
        "table2_time": lambda: table2_time.run(
            eval_batches=2 if fast else 4, shuffles=1 if fast else 2,
            device=device),
        "table3_fquant": lambda: table3_fquant.run(
            train_steps=150 if fast else 800, device=device),
        "fig3_thresholds": lambda: fig3_thresholds.run(
            train_steps=150 if fast else 800,
            t16_grid=(1e-1, 1e1) if fast else (1e-2, 1e-1, 1e0, 1e1),
            t8_grid=(1e-1, 1e1) if fast else (1e-2, 1e-1, 1e0, 1e1),
            device=device),
        "table4_combined": lambda: table4_combined.run(
            train_steps=150 if fast else 800, device=device),
        "fig2_fperm": lambda: fig2_fperm.run(
            train_steps=150 if fast else 800,
            keep_counts=(6,) if fast else (8, 6, 4),
            finetune_steps=40 if fast else 150, device=device),
        "qps": lambda: qps.run(iters=5 if fast else 20, device=device,
                               audit=audit),
        "qps_sharded": lambda: qps_sharded.run(
            requests=24 if fast else 48,
            serve_batches=(8,) if fast else (1, 8), device=device),
        "freq_error": lambda: freq_error.run(
            train_steps=100 if fast else 400, device=device),
        "hashed": lambda: hashed.run(fast=fast, device=device),
        "roofline": roofline.run,
    }


def emit(name: str, seconds: float, rows: list[dict]) -> None:
    us = seconds * 1e6
    for row in rows:
        payload = ";".join(f"{k}={v}" for k, v in row.items())
        print(f"{name},{us:.0f},{payload}")
    sys.stdout.flush()


def emit_record(name: str, path: str, args: argparse.Namespace,
                audit=None) -> dict:
    """Write one manifest record to ``path``, dispatched on ``name`` (the
    basename) as the reference's ``_emit_bench_record``; returns it.
    ``audit`` goes to the hashed sweep."""
    from repro_torch.benchmarks.manifest import COMMITTED_BENCH
    from repro_torch.benchmarks.qps import write_bench_json

    fast = args.fast
    if name not in COMMITTED_BENCH:
        raise SystemExit(f"--emit {name}: not a committed benchmark record "
                         f"(manifest: {', '.join(sorted(COMMITTED_BENCH))})")
    if name == "BENCH_fleet.json":
        raise SystemExit(f"{name} is emitted by its own command: "
                         f"`{COMMITTED_BENCH[name][1]}`")
    if name in EMIT_WAITING:
        raise NotImplementedError(f"--emit {name}: not ported yet, ROADMAP "
                                  f"Queue 1 {EMIT_WAITING[name]}")
    if name == "BENCH_pipeline.json":
        from repro_torch.launch.pipeline import (PipelineConfig,
                                                 fast_config, run_pipeline,
                                                 verify_failures)
        # the checkpoints go to a directory of this run's own
        with tempfile.TemporaryDirectory() as ckpt:
            cfg = (fast_config(device=args.device, ckpt_dir=ckpt) if fast
                   else PipelineConfig(device=args.device, ckpt_dir=ckpt))
            rec = run_pipeline(cfg)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1, sort_keys=True)
        print(f"wrote {path}")
        failures = verify_failures(rec)
        if failures:
            raise SystemExit(f"pipeline verify FAILED: {failures}")
        return rec
    if name == "BENCH_qps.json":
        from repro_torch.benchmarks import qps
        rec = qps.run_online_sweep(
            qps._parse_serve_batches(args.serve_batches),
            requests=96 if fast else 384,
            retier_every=32 if fast else 128,
            retier_async=args.retier_async, device=args.device)
    elif name == "BENCH_kernel.json":
        from repro_torch.benchmarks import kernels
        rec = kernels.run(iters=1 if fast else 2, device=args.device)
    elif name == "BENCH_hier.json":
        from repro_torch.benchmarks import hier
        rec = hier.run_hier_sweep(**hier.sweep_budgets(fast),
                                  retier_async=args.retier_async,
                                  device=args.device)
    else:                                       # BENCH_hash.json
        from repro_torch.benchmarks import hashed
        rec = hashed.run_hashed_sweep(**hashed.sweep_budgets(fast),
                                      audit=audit, device=args.device)
    write_bench_json(rec, path)
    print(f"wrote {path}")
    return rec


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="The paper's tables and figures (CSV rows), or one "
                    "benchmark record (--emit).")
    ap.add_argument("--fast", action="store_true",
                    help="the reference's reduced budgets")
    ap.add_argument("--only", default=None, metavar="NAME",
                    help="run one job")
    ap.add_argument("--emit", default=None, metavar="PATH",
                    help="write the manifest record named by PATH's "
                         "basename (BENCH_qps.json, BENCH_hier.json, "
                         "BENCH_pipeline.json, BENCH_hash.json, "
                         "BENCH_kernel.json) to PATH and skip the CSV jobs")
    ap.add_argument("--emit-pipeline", default=None, metavar="PATH",
                    help="run the train -> prune -> quantize -> pack -> "
                         "serve pipeline and write its bench_pipeline/v1 "
                         "record to PATH; skips the CSV jobs")
    ap.add_argument("--serve-batches", default="1,8,32",
                    help="serve batches of the BENCH_qps.json sweep")
    ap.add_argument("--retier-async", action="store_true",
                    help="the BENCH_qps.json / BENCH_hier.json sweep "
                         "re-tiers by shadow builds and swaps")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises when absent)")
    return ap.parse_args(argv)


def main(argv=None, audit=None) -> dict[str, dict]:
    """Runs the jobs and prints their rows; returns ``{name: {"rows":
    rows, "seconds": s}}`` (with ``--emit``: ``{name: {"record": rec}}``).
    ``audit`` goes to the ``qps`` job (``benchmarks.qps.run``) and to the
    ``BENCH_hash.json`` sweep (``benchmarks.hashed.run_hashed_sweep``)."""
    from repro_torch import resolve_device
    args = parse_args(argv)
    if args.emit_pipeline:
        return {"BENCH_pipeline.json": {"record": emit_record(
            "BENCH_pipeline.json", args.emit_pipeline, args)}}
    if args.emit:
        name = os.path.basename(args.emit)
        return {name: {"record": emit_record(name, args.emit, args, audit)}}
    if args.only in WAITING:
        raise NotImplementedError(f"{args.only}: not ported yet, ROADMAP "
                                  f"Queue 1 {WAITING[args.only]}")
    device = resolve_device(args.device)
    todo = jobs(args.fast, device, audit)
    if args.only is not None:
        if args.only not in todo:
            raise SystemExit(f"--only {args.only}: no such job "
                             f"({', '.join(list(todo) + list(WAITING))})")
        todo = {args.only: todo[args.only]}
    if WAITING:
        print("# not ported yet (ROADMAP Queue 1): "
              + "; ".join(f"{k}: {v}" for k, v in WAITING.items()))
    out = {}
    for name, job in todo.items():
        t0 = time.perf_counter()
        rows = job()
        seconds = time.perf_counter() - t0
        emit(name, seconds, rows)
        out[name] = {"rows": rows, "seconds": seconds}
    return out


if __name__ == "__main__":
    main()
