"""Where a shadow re-tier's time goes on one CUDA card, beside the
synchronous delta re-tier over the same drift.

    python3 scripts/shadow_ticks.py [--archs wide-deep,xdeepfm] \\
        [--cycles 3] [--shadow-rows 4194304] [--out PATH]

For each arch the online store is built at the published widths
(``repro_torch.launch.serve.online_store``, as ``--online --model full``
builds it) and served through the fused head at batch 512.  Each cycle
folds two drifting-zipf requests, then times the shadow build's pieces
on the server's own path, each ended by a synchronize: the plan
(``begin_retier``), every chunk step (the last one includes the
materialize), the materialize alone again, the verify on the serving
stream, then the verify on the staging thread's stream while fused
forwards run on the serving stream (each forward timed, beside forwards
alone), and the swap tick (the cache rebuild).  Then it folds two more
requests and times a synchronous ``retier()`` (the delta re-tier and the
cache rebuild).  Prints the card's name and power limit and one JSON
line an arch; ``--out`` also writes the lines there.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")


def timed(torch, fn, *args) -> tuple:
    """(ms, result) of one call, synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return round((time.perf_counter() - t0) * 1e3, 3), out


def measure(torch, arch: str, cycles: int, shadow_rows: int) -> dict:
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.serve.loop import (_forward, drifting_zipf_batch,
                                        request_batch)
    from repro_torch.serve.online import OnlineConfig, OnlineServer

    dev = torch.device("cuda")
    model = configs.get(arch).model
    spec = model.spec
    params, store, cfg = serve.online_store(model, spec, dev)
    server = OnlineServer(store, cfg, OnlineConfig(
        cache_rows=256, retier_async=True, shadow_rows_per_step=shadow_rows,
        verify_swap=True))
    del store
    fwd = _forward(server, model, spec, True)
    out: dict = {"arch": arch, "vocab": spec.total_rows,
                 "shadow_rows": shadow_rows}

    def add(key, value):
        out.setdefault(key, []).append(value)

    def request(r: int, fold: bool):
        idx = drifting_zipf_batch(spec.cardinalities, 512, r, r + 1)
        b = request_batch(idx, r, 0, dev)
        logits, hits, gidx, _ = fwd(server.packed, server.cache, params, b)
        torch.cuda.current_stream(dev).synchronize()
        if fold:
            server.observe(gidx, int(hits))
        return b

    with torch.inference_mode():
        r = 0
        for _ in range(cycles):
            for _ in range(2):
                b = request(r, True)
                r += 1
            ms, opened = timed(torch, server.begin_retier)
            add("plan_ms", ms)
            if not opened:
                add("movers", 0)
                continue
            sh = server.shadow
            add("movers", sh.moved)
            steps = []
            while not sh.staged:
                steps.append(timed(torch, sh.step, shadow_rows)[0])
            add("chunk_step_ms", steps)
            add("materialize_ms", timed(torch, sh.materialize)[0])
            add("verify_serving_stream_ms", timed(torch, sh.verify)[0])
            alone = [timed(torch, fwd, server.packed, server.cache, params,
                           b)[0] for _ in range(5)]
            add("forward_alone_ms", alone)
            t0 = time.perf_counter()
            server._shadow_tick(1)          # starts the staging thread
            during = []
            while server._warmup.is_alive():
                during.append(timed(torch, fwd, server.packed, server.cache,
                                    params, b)[0])
            server._warmup.join()
            add("verify_staging_wall_ms",
                round((time.perf_counter() - t0) * 1e3, 3))
            add("forward_during_verify_ms", during)
            ms, swapped = timed(torch, server._shadow_tick, 1)
            if not swapped:
                raise SystemExit(f"{arch}: the swap did not land")
            add("swap_tick_ms", ms)
            for _ in range(2):
                request(r, True)
                r += 1
            moved = server.stats.rows_moved
            add("sync_retier_ms", timed(torch, server.retier)[0])
            add("sync_moved", server.stats.rows_moved - moved)
    out["memory_reserved_gb"] = torch.cuda.memory_reserved() / 1e9
    out["device_name"] = torch.cuda.get_device_name(0)
    del server, params
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--archs", default="wide-deep,xdeepfm")
    ap.add_argument("--cycles", type=int, default=3)
    ap.add_argument("--shadow-rows", type=int, default=1 << 22)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("shadow_ticks: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    from repro_torch.kernels import build
    build.build_all(["dequant_bag", "bag_matmul", "cin", "rowwise_quant"])
    lines = []
    for arch in args.archs.split(","):
        rec = measure(torch, arch, args.cycles, args.shadow_rows)
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
