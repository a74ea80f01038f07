"""Where the slow requests of the async ``bench_qps/v1`` sweep spend their
time, on one CUDA card.

    python3 scripts/async_tail_trace.py [--sweeps 4] [--heap 0,2000000] \\
        [--batches 1,8,32] [--out PATH] [--device cuda]

Runs ``benchmarks.qps.run_online_sweep(batches, retier_async=True)`` (the
reference's defaults) ``--sweeps`` times for each ``--heap`` size: the
number of small Python containers kept alive beside the run (a long-lived
serving process holds many; 0 is a fresh process's heap).  Metrics are
on, and every span and timeblock is kept with its end time; every
garbage collection is timed through ``gc.callbacks``; the re-tier's
materialize is timed alone (synchronized on both sides).  Each sweep
entry prints one JSON line: p50, p99 and p99 while re-tiering (us),
whether both tails are within ``tools/check_bench_schema.py``'s budget
(10 x p50), and for the five slowest batches of the re-tier window their
latency and what ran inside it (spans in us, collections by generation
in us, the materialize in us).  Prints the card's name and power limit
first and a count of entries over budget a heap size last.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

EVENTS: list = []          # (end perf_counter, name, microseconds)


def _instrument(torch, device: str) -> None:
    from repro_torch.obs import registry
    from repro_torch.serve import shadow

    observe = registry.Registry.observe

    def recording_observe(self, name, value):
        EVENTS.append((time.perf_counter(), name, float(value)))
        observe(self, name, value)
    registry.Registry.observe = recording_observe

    materialize = shadow.ShadowRepack.materialize

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def timed_materialize(self):
        sync()
        t0 = time.perf_counter()
        out = materialize(self)
        sync()
        t1 = time.perf_counter()
        EVENTS.append((t1, "materialize", (t1 - t0) * 1e6))
        return out
    shadow.ShadowRepack.materialize = timed_materialize

    gc_t0 = {}

    def on_gc(phase, info):
        if phase == "start":
            gc_t0["t"] = time.perf_counter()
        else:
            t1 = time.perf_counter()
            EVENTS.append((t1, f"gc{info['generation']}",
                           (t1 - gc_t0.get("t", t1)) * 1e6))
    gc.callbacks.append(on_gc)


def _batches(loop_mod) -> list:
    """Wrap the loop's per-batch marks: [(start, end)] a batch."""
    bounds: list = []
    mark, account = loop_mod._shadow_mark, loop_mod._account

    def marked(server):
        bounds.append([time.perf_counter(), None])
        return mark(server)

    def accounted(server, m, retiered, retier_s, window):
        bounds[-1][1] = time.perf_counter()
        account(server, m, retiered, retier_s, window)
        bounds[-1].append(window[-1])
    loop_mod._shadow_mark, loop_mod._account = marked, accounted
    return bounds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweeps", type=int, default=4)
    ap.add_argument("--heap", default="0,2000000")
    ap.add_argument("--batches", default="1,8,32")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.benchmarks import qps
    from repro_torch.serve import loop
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True, timeout=60
                             ).stdout.strip(), flush=True)
    _instrument(torch, args.device)
    obs.enable()
    bounds = _batches(loop)
    batches = [int(b) for b in args.batches.split(",")]
    out = open(args.out, "w") if args.out else None
    keep: list = []
    over = {}
    for heap in (int(h) for h in args.heap.split(",")):
        # one-element lists: containers the collector tracks and scans
        keep.extend([i] for i in range(heap - len(keep)))
        gc.collect()
        n_over = 0
        for rep in range(args.sweeps):
            del EVENTS[:]
            del bounds[:]
            rec = qps.run_online_sweep(batches, retier_async=True,
                                       device=args.device)
            ev = sorted(EVENTS)
            start = 0
            for e in rec["sweep"]:
                # the sweep's batches in order: entry k owns the next
                # requests / serve_batch bounds (the tail batch included)
                nb = -(-rec["requests"] // e["serve_batch"])
                mine = bounds[start:start + nb]
                start += nb
                lat = np.array([b[1] - b[0] for b in mine]) * 1e6
                win = [i for i, b in enumerate(mine) if b[2] and i > 0]
                slow = sorted(win, key=lambda i: -lat[i])[:5]
                detail = []
                for i in slow:
                    t0, t1 = mine[i][0], mine[i][1]
                    inside = {}
                    for t, name, us in ev:
                        if t0 <= t <= t1:
                            inside[name] = round(inside.get(name, 0.0) + us)
                    detail.append({"batch": i, "us": round(float(lat[i])),
                                   "inside": inside})
                budget = 10 * e["p50_us"]
                ok = max(e["p99_us"], e["p99_while_retiering"]) <= budget
                n_over += not ok
                line = {"heap": heap, "sweep": rep,
                        "objects": len(gc.get_objects()),
                        "serve_batch": e["serve_batch"],
                        "p50_us": e["p50_us"], "p99_us": e["p99_us"],
                        "p99_while_retiering": e["p99_while_retiering"],
                        "within_budget": ok, "batches": len(mine),
                        "window": len(win), "slowest": detail}
                print(json.dumps(line), flush=True)
                if out:
                    out.write(json.dumps(line) + "\n")
        over[heap] = f"{n_over} of {args.sweeps * len(batches)}"
    print(json.dumps({"entries_over_budget": over}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
