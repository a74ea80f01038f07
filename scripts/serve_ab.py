"""Serve latency of two checkouts of the port against each other, and the
cost of ``--metrics-out``, on one CUDA card.

    python3 scripts/serve_ab.py NAME=ROOT NAME=ROOT [--only CONFIG] \\
        [--rounds 1] [--out PATH]

Each ROOT is a checkout's root (its ``src/`` holds ``repro_torch``).  To
compare a commit with its parent, unpack the parent into an ignored
directory (``git archive PARENT src | tar -x -C build/parent``) and name
both: ``parent=build/parent new=.``.  Each config runs
``python -m repro_torch.launch.serve`` in a fresh process from each
checkout, and from the second checkout with ``--metrics-out`` too (M: a
snapshot line every 4 requests, as ``chip_smoke.py`` phase 13 takes
it), in turns A B M M B A, ``--rounds`` times, so the metrics-on cost is
read beside the same call's metrics-off runs.  Configs, at the
published widths and ``chip_smoke.py``'s settings (batch 512, 16
requests, the first left out of the percentiles):

- ``dlrm``: dlrm-rm2 offline, 204,185,088 rows packed at a 50% budget;
- ``online``: wide&deep online through the fused head, 22,216,000 rows,
  a re-tier every 2 requests, 256 cache rows, drift 4.0;
- ``hashed``: wide&deep online from the hashed store, fp32 pool at ratio
  100, the same online settings.

Each checkout builds its own kernels (into its ``build/repro_torch/``) in
its first run.  Prints the card's name and power limit, one JSON line a
run (the record's p50 / p99 / steady QPS) and a last JSON line with
each config's runs by checkout; ``--out`` also writes it there.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ONLINE = ["--online", "--model", "full", "--batch", "512", "--requests",
          "16", "--retier-every", "2", "--cache-rows", "256", "--drift",
          "4.0"]
CONFIGS = {
    "dlrm": ["--arch", "dlrm-rm2", "--model", "full", "--batch", "512",
             "--requests", "16"],
    "online": ["--arch", "wide-deep", "--fuse-matmul", *ONLINE],
    "hashed": ["--arch", "wide-deep", "--store-backend", "hashed",
               "--hash-bits", "32", *ONLINE],
}


def run(root: str, argv: list) -> dict:
    """One serve run from checkout ``root`` in a fresh process; its
    record, with the process's wall seconds."""
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.abspath(root),
                                                   "src"))
    env.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          *argv], cwd=root, env=env, capture_output=True,
                         text=True, timeout=900)
    if out.returncode != 0:
        raise SystemExit(f"serve from {root} failed ({out.returncode}):\n"
                         f"{out.stderr[-4000:]}")
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    rec["process_s"] = time.perf_counter() - t0
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs=2, metavar="NAME=ROOT")
    ap.add_argument("--only", action="append", choices=tuple(CONFIGS))
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", default=None, metavar="PATH")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    (a, root_a), (b, root_b) = (t.split("=", 1) for t in args.trees)
    result = {"card": smi.splitlines()[0], "configs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.only or CONFIGS:
            m = f"{b}+metrics"
            runs = {a: [], b: [], m: []}
            order = [(a, root_a), (b, root_b), (m, root_b), (m, root_b),
                     (b, root_b), (a, root_a)]
            for _ in range(args.rounds):
                for label, root in order:
                    argv = list(CONFIGS[name])
                    if label == m:
                        path = os.path.join(tmp, f"{name}.jsonl")
                        argv += ["--metrics-out", path, "--metrics-every",
                                 "4"]
                    rec = run(root, argv)
                    if label == m:
                        with open(path) as fh:
                            last = json.loads(
                                fh.read().strip().splitlines()[-1])
                        rec["metrics_lines"] = last["seq"]
                    runs[label].append(rec)
                    print(json.dumps({"config": name, "tree": label, **{
                        k: rec.get(k) for k in ("p50_us", "p99_us", "qps",
                                                "steady_qps", "process_s",
                                                "metrics_lines")}}),
                          flush=True)
            result["configs"][name] = {
                label: [{k: r.get(k) for k in ("p50_us", "p99_us",
                                               "steady_qps")}
                        for r in recs] for label, recs in runs.items()}
    print(json.dumps(result), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
