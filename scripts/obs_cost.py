"""What the ``obs`` layer costs on the port's request paths, measured in
one process on one CUDA card.

    python3 scripts/obs_cost.py [--only CONFIG] [--blocks 3] \\
        [--requests 32] [--out PATH]

Each config's served state is built once, through
``repro_torch.launch.serve.run`` at the published widths and
``chip_smoke.py``'s settings (batch 512); then blocks of ``--requests``
requests are timed on it in turns, ``--blocks`` times:

- ``dlrm`` (offline, 204,185,088 rows packed at 50%): P O R M S S M R O
  P, where P is the parent commit's loop (a ``perf_counter`` pair around
  each request, no timeblock and no tick), O the driver's loop
  (``serve.time_requests``) with metrics off, R the same with the
  registry on and no sink, M with a JSONL sink writing a line every 4
  requests (as ``chip_smoke.py`` phase 13), S with one every 16 (the
  drivers' default);
- ``online`` (wide&deep through the fused head, a re-tier every 2
  requests, 256 cache rows) and ``hashed`` (wide&deep from the fp32 pool):
  P O R M S S M R O P over ``serve.loop.serve_forward_loop`` on the same
  server, its state carried from block to block, where P is metrics off
  with the parent commit's Eq. 7 fold (no subnormal flush) swapped into
  ``store.api`` for the block.

Requests in one process on one store, so the blocks differ only in the
variant: dlrm blocks take consecutive requests, online blocks each
replay the stream's first ``--requests`` requests on the server as the
blocks before left it.  Prints the card's name and power limit, one JSON line
a block (its p50 / p99 over the block's requests, the first of each
block left out) and a last JSON line with each variant's p50 and p99 over
all its requests; ``--out`` also writes that there.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

ONLINE = ["--online", "--model", "full", "--batch", "512", "--requests",
          "1", "--retier-every", "2", "--cache-rows", "256", "--drift",
          "4.0"]
CONFIGS = {
    "dlrm": ["--arch", "dlrm-rm2", "--model", "full", "--batch", "512",
             "--requests", "1"],
    "online": ["--arch", "wide-deep", "--fuse-matmul", *ONLINE],
    "hashed": ["--arch", "wide-deep", "--store-backend", "hashed",
               "--hash-bits", "32", *ONLINE],
}


def parent_loop(serve, served, requests: int, start: int) -> list[float]:
    """The parent commit's offline loop, as it was."""
    import torch

    from repro_torch import sync
    dev = served.packed.payload32.device
    lat = []
    with torch.inference_mode():
        for r in range(start, start + requests):
            batch = {k: v.to(dev) for k, v in served.make_request(r).items()}
            sync(dev)
            t = time.perf_counter()
            serve.serve_request(served.model, served.params, served.packed,
                                batch)
            sync(dev)
            lat.append(time.perf_counter() - t)
    return lat


# variant -> the sink's cadence (None: registry off; 0: on, no sink)
SINK = {"P": None, "O": None, "R": 0, "M": 4, "S": 16}


def parent_fold(w, indices, cfg, valid=None):
    """The parent commit's ``priority.serve_fold``: no subnormal flush."""
    import torch

    from repro_torch.core.priority import access_counts
    c = access_counts(indices, w.shape[0], valid)
    f32 = dict(dtype=torch.float32, device=w.device)
    decay = torch.tensor(1.0 - cfg.beta, **f32)
    return decay * w + torch.tensor(cfg.beta, **f32) * c


def metrics(variant: str, path: str) -> None:
    from repro_torch import obs
    obs.close_sink()
    obs.disable()
    obs.get_registry().reset()
    every = SINK[variant]
    if every is not None:
        obs.enable()
        if every:
            obs.set_sink(obs.JsonlSink(path, every=every))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", action="append", choices=tuple(CONFIGS))
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--out", default=None, metavar="PATH")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("obs_cost: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.priority import serve_fold
    from repro_torch.launch import serve
    from repro_torch.serve.loop import serve_forward_loop
    from repro_torch.store import api
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    result = {"card": smi.splitlines()[0], "requests_a_block": args.requests,
              "configs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        sink = os.path.join(tmp, "m.jsonl")
        for name in args.only or CONFIGS:
            served = serve.run(serve.parse_args(CONFIGS[name]))
            offline = name == "dlrm"
            order = tuple("PORMSSMROP")
            lat_by = {v: [] for v in order}
            start = 1
            for _ in range(args.blocks):
                for v in order:
                    metrics(v, sink)
                    if v == "P" and offline:
                        lat = parent_loop(serve, served, args.requests, start)
                    elif offline:
                        lat = serve.time_requests(
                            served.model, served.params, served.packed,
                            served.make_request, args.requests,
                            served.packed.payload32.device, start=start)
                    else:
                        model = served.model
                        if v == "P":
                            api.serve_fold = parent_fold
                        try:
                            lat = list(serve_forward_loop(
                                served.server, model, model.spec,
                                served.params, batch=512,
                                requests=args.requests,
                                fuse_matmul=name == "online").lat_s)
                        finally:
                            api.serve_fold = serve_fold
                    metrics("O", sink)
                    start += args.requests
                    us = np.asarray(lat[1:]) * 1e6
                    lat_by[v].extend(us.tolist())
                    print(json.dumps({"config": name, "variant": v,
                                      "p50_us": float(np.percentile(us, 50)),
                                      "p99_us": float(np.percentile(us, 99))}),
                          flush=True)
            result["configs"][name] = {
                v: {"requests": len(us), "p50_us": float(np.percentile(us, 50)),
                    "p99_us": float(np.percentile(us, 99)),
                    "mean_us": float(np.mean(us))}
                for v, us in lat_by.items()}
            del served
            torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
