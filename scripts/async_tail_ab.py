"""The async ``bench_qps/v1`` tail budget on one CUDA card against the
allocator's state: expandable segments on or off, and the pool released
(a 20 GB block allocated, freed and ``torch.cuda.empty_cache()``) just
before each sweep or not.

    python3 scripts/async_tail_ab.py [--sweeps 3] [--rounds 2]

Each variant runs in a fresh process (``PYTORCH_CUDA_ALLOC_CONF`` is read
when CUDA starts), variants in turns, ``--rounds`` times; a process runs
``--sweeps`` sweeps of ``benchmarks.qps.run_online_sweep([1, 8],
retier_async=True)`` (the reference's defaults).  One JSON line a sweep:
each entry's p50, p99 and p99 while re-tiering (us) and whether both
tails are within ``tools/check_bench_schema.py``'s budget (10 x p50).
Prints the card's name and power limit first and a count of sweeps over
budget a variant last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = (("expandable", "release"), ("plain", "release"),
            ("expandable", "keep"), ("plain", "keep"))


def child(alloc: str, pool: str, sweeps: int) -> None:
    if alloc == "expandable":
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.benchmarks import qps
    for rep in range(sweeps):
        if pool == "release":
            x = torch.empty(int(20e9), dtype=torch.uint8, device="cuda")
            del x
            torch.cuda.empty_cache()
        rec = qps.run_online_sweep([1, 8], retier_async=True)
        entries = [{"serve_batch": e["serve_batch"], "p50_us": e["p50_us"],
                    "p99_us": e["p99_us"],
                    "p99_while_retiering": e["p99_while_retiering"],
                    "within_budget": max(e["p99_us"],
                                         e["p99_while_retiering"])
                    <= 10 * e["p50_us"]} for e in rec["sweep"]]
        print(json.dumps({"alloc": alloc, "pool": pool, "sweep": rep,
                          "entries": entries}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweeps", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", nargs=2, metavar=("ALLOC", "POOL"))
    args = ap.parse_args(argv)
    if args.child:
        child(*args.child, args.sweeps)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    over = {f"{a}/{p}": [0, 0] for a, p in VARIANTS}
    for _ in range(args.rounds):
        for alloc, pool in VARIANTS:
            out = subprocess.run(
                [sys.executable, __file__, "--sweeps", str(args.sweeps),
                 "--child", alloc, pool], capture_output=True, text=True,
                check=True, timeout=900).stdout
            for line in out.splitlines():
                if line.startswith("{"):
                    print(line, flush=True)
                    rec = json.loads(line)
                    over[f"{alloc}/{pool}"][0] += not all(
                        e["within_budget"] for e in rec["entries"])
                    over[f"{alloc}/{pool}"][1] += 1
    print(json.dumps({"sweeps_over_budget": {k: f"{a} of {n}" for k, (a, n)
                                             in over.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
