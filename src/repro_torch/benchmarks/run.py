"""Benchmark runner: one job per paper table or figure, on the card.

    python -m repro_torch.benchmarks.run [--fast] [--only NAME] [--device cpu]

Port of ``benchmarks/run.py``'s CSV jobs: prints ``name,us_per_call,
derived`` rows (``derived`` carries the table's payload as key=value
pairs), after one ``#`` line naming the reference's jobs not ported
yet.  The jobs are the paper's six: ``table2_time``, ``table3_fquant``,
``fig3_thresholds``, ``table4_combined``, ``fig2_fperm`` and
``freq_error``, at the reference's budgets (``--fast``: its reduced
ones).  They run on ``cuda`` unless ``--device cpu``, and raise without
a GPU.  Unlike the reference, a job's exception is not caught: it
propagates and the process exits non-zero.  ``--only`` with a job that
waits (``qps``, ``qps_sharded``, ``hashed``, ``roofline``), ``--emit``
and ``--emit-pipeline`` raise ``NotImplementedError`` naming its ROADMAP
item.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable

# the reference's jobs not ported yet, with their ROADMAP Queue 1 items
WAITING = {
    "qps": "item 10, the offline bench_qps CPU proxy",
    "qps_sharded": "item 7, the mesh",
    "hashed": "item 4, the hashed train step with bench_hash/v1",
    "roofline": "item 9, autotune with benchmarks/kernels.py",
}
EMIT_ITEM = "item 10, the runner's --emit with benchmarks/manifest.py"


def jobs(fast: bool, device) -> dict[str, Callable[[], list[dict]]]:
    """The six paper jobs at the reference's budgets, on ``device``."""
    from repro_torch.benchmarks import (fig2_fperm, fig3_thresholds,
                                        freq_error, table2_time,
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
        "freq_error": lambda: freq_error.run(
            train_steps=100 if fast else 400, device=device),
    }


def emit(name: str, seconds: float, rows: list[dict]) -> None:
    us = seconds * 1e6
    for row in rows:
        payload = ";".join(f"{k}={v}" for k, v in row.items())
        print(f"{name},{us:.0f},{payload}")
    sys.stdout.flush()


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="The paper's tables and figures (CSV rows).")
    ap.add_argument("--fast", action="store_true",
                    help="the reference's reduced budgets")
    ap.add_argument("--only", default=None, metavar="NAME",
                    help="run one job")
    ap.add_argument("--emit", default=None, metavar="PATH",
                    help="not ported yet")
    ap.add_argument("--emit-pipeline", default=None, metavar="PATH",
                    help="not ported yet")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises when absent)")
    return ap.parse_args(argv)


def main(argv=None) -> dict[str, dict]:
    """Runs the jobs and prints their rows; returns ``{name: {"rows":
    rows, "seconds": s}}``."""
    from repro_torch import resolve_device
    args = parse_args(argv)
    if args.emit or args.emit_pipeline:
        raise NotImplementedError(f"--emit / --emit-pipeline: not ported "
                                  f"yet, ROADMAP Queue 1 {EMIT_ITEM}")
    if args.only in WAITING:
        raise NotImplementedError(f"{args.only}: not ported yet, ROADMAP "
                                  f"Queue 1 {WAITING[args.only]}")
    device = resolve_device(args.device)
    todo = jobs(args.fast, device)
    if args.only is not None:
        if args.only not in todo:
            raise SystemExit(f"--only {args.only}: no such job "
                             f"({', '.join(list(todo) + list(WAITING))})")
        todo = {args.only: todo[args.only]}
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
