"""Serving benchmarks: the offline QPS proxy and the ``bench_qps/v1``
record, on the card.

    python -m repro_torch.benchmarks.qps [--batch 512] [--device cpu]
    python -m repro_torch.benchmarks.qps --online --serve-batch 1,8,32 \\
        [--emit PATH] [--device cpu]
    python -m repro_torch.benchmarks.qps --online [--batch 256]

Port of ``benchmarks/qps.py``.  Without ``--online``, ``run`` is the
offline proxy of the paper's +30% QPS claim: the bench DLRM trained 60
F-Quantization steps, packed at half the fp32 bytes (Eq. 8 thresholds
planned from the trained priorities), and one batch of 512 scored
through the fp32 forward and through the packed forward
(``packed_store.lookup_fused``: one tiered ``dequant_bag`` launch, then
the head).  Its rows are the reference's: bytes a request for the fp32
table and for the packed store (payload, scale and indirection word a
row, against the pack-time tiers), their ratio (the headroom a
bandwidth-bound server has) and the packed store's share of the fp32
bytes; and the two forwards' times.  The reference timed its jitted
forwards on a CPU and named them ``cpu_forward_us_*``; here the times
are the device's (the card's unless ``--device cpu``): the mean of
``iters`` calls after one warm-up, the device synchronized before each
clock read, as ``forward_us_fp32`` and ``forward_us_packed``.

The online half: the bench DLRM  The bench DLRM
(``common.make_setup(num_fields=10)``) with a pareto(1.2) x 10 priority
profile packed at ``ratio`` of the fp32 bytes serves a drifting-zipf
stream through ``serve.online.OnlineServer``: the hot-row cache, the
Eq. 7 fold and delta re-tiers (no training warm-up: the online loop
re-learns the tiering from traffic).  ``--retier-async`` runs each
re-tier as a chunked shadow build and swap (``serve.shadow``) instead of
a synchronous repack; ``tools/check_bench_schema.py`` then holds every
entry's p99 and ``p99_while_retiering`` (the p99 over the batches that
overlapped shadow work) to 10x its p50.  After each timed loop the last
shadow build is drained (outside the record, which keeps the loop's
counters).

``--online --serve-batch 1,8,32`` (``run_online_sweep``) serves the same
single-user stream (seeded per request index) at each micro-batch size
and gives one ``bench_qps/v1`` record with one sweep entry a size: the
loop's QPS, steady QPS and histogram percentiles (wall time on the
device it ran on, each batch ending when its device work has),
its counters, and the bytes per request against the pack-time tiers
(equal across entries by construction: micro-batching changes wall
time, never traffic).  ``--emit PATH`` writes it (``write_bench_json``;
nothing is written without it), and ``python tools/check_bench_schema.py
PATH`` validates it.  ``--online`` alone (``run_online``) serves
request-at-a-time batches of ``--batch`` and prints one record.

The record adds ``device`` and ``device_name``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.benchmarks.common import (device_batch, make_setup, timed,
                                           train_fquant)
from repro_torch.core import packed_store as ps
from repro_torch.core.qat_store import (FQuantConfig, QATStore,
                                        current_tiers, snap)
from repro_torch.core.tiers import assign_tiers, plan_thresholds_for_ratio
from repro_torch.models import embedding as E
from repro_torch.serve.loop import (serve_forward_loop,
                                    serve_forward_microbatched,
                                    stream_bytes_per_request)
from repro_torch.serve.online import OnlineConfig, OnlineServer

BENCH_SCHEMA = "bench_qps/v1"


def run(batch=512, iters=20, *, device: str | torch.device | None = None,
        audit=None) -> list[dict]:
    """The offline proxy's rows (see the module docstring).  ``audit(packed,
    gidx, emb)``, when given, gets the packed store, the batch's global ids
    and the packed arm's embeddings, after the timing."""
    setup = make_setup(num_fields=10, important=5, train_steps=60,
                       device=device)
    spec = setup.model.spec
    model = setup.model

    params, priority = train_fquant(setup, FQuantConfig(), steps=60)
    planned = plan_thresholds_for_ratio(priority, spec.dim, 0.5)
    cfg = FQuantConfig(tiers=planned, stochastic=False)
    store = QATStore(params["embed_table"], priority)
    store = store._replace(table=snap(store.table,
                                      current_tiers(store, cfg), cfg))
    packed = ps.pack(store, cfg)

    b = device_batch(setup.ds.batch(batch, 777), setup.device)
    gidx = E.globalize(b["indices"], spec)

    # bytes a request (B*F rows of D): payload + scale by tier, and the
    # indirection word of every row
    fp32_bytes_req = gidx.numel() * spec.dim * 4
    touched = assign_tiers(priority, planned)[gidx.reshape(-1).to(
        torch.int64)].to(torch.int64)
    per_tier = torch.tensor([spec.dim + 4, 2 * spec.dim + 4, 4 * spec.dim],
                            dtype=torch.int64, device=touched.device)
    packed_bytes_req = int((per_tier[touched] + 4).sum())

    last = {}

    def fwd_packed(b):
        last["emb"] = ps.lookup_fused(packed, E.globalize(b["indices"], spec))
        return model.head(params, last["emb"], b)

    with torch.inference_mode():
        _, t_fp32 = timed(model.forward, params, b, repeats=iters)
        _, t_packed = timed(fwd_packed, b, repeats=iters)
    if audit is not None:
        audit(packed, gidx, last["emb"])

    ratio = fp32_bytes_req / packed_bytes_req
    return [
        {"metric": "bytes_per_request_fp32", "value": fp32_bytes_req},
        {"metric": "bytes_per_request_packed", "value": packed_bytes_req},
        {"metric": "hbm_bytes_ratio (QPS headroom on bw-bound serving)",
         "value": round(ratio, 2)},
        {"metric": "table_memory_ratio",
         "value": round(packed.nbytes() / (spec.total_rows * spec.dim * 4),
                        3)},
        {"metric": "forward_us_fp32", "value": round(t_fp32 * 1e6)},
        {"metric": "forward_us_packed", "value": round(t_packed * 1e6)},
    ]


def _bench_store(ratio: float, *, params: dict | None = None,
                 device: str | torch.device | None = None):
    """The online benches' fixture: the bench DLRM with a fabricated
    pareto priority profile (numpy, seed 0) packed at ``ratio`` of the
    fp32 bytes.  Returns (setup, spec, params, store, cfg)."""
    setup = make_setup(num_fields=10, important=5, train_steps=0,
                       params=params, device=device)
    spec = setup.model.spec
    params = setup.params
    rng = np.random.default_rng(0)
    pri = torch.from_numpy((rng.pareto(1.2, spec.total_rows) * 10)
                           .astype(np.float32)).to(setup.device)
    cfg = FQuantConfig(tiers=plan_thresholds_for_ratio(pri, spec.dim, ratio),
                       stochastic=False)
    store = QATStore(params["embed_table"], pri)
    store = store._replace(table=snap(store.table,
                                      current_tiers(store, cfg), cfg))
    return setup, spec, params, store, cfg


def _device_keys(device: torch.device) -> dict:
    return {"device": device.type,
            "device_name": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu")}


def write_bench_json(rec: dict, path: str) -> None:
    """The one writer of ``bench_qps/v1`` files."""
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
        f.write("\n")


def run_online(batch=256, requests=24, cache_rows=512, retier_every=4,
               drift=4.0, ratio=0.5, retier_async=False, *,
               params: dict | None = None,
               device: str | torch.device | None = None) -> dict:
    """Request-at-a-time online serving under drifting zipf: one record."""
    setup, spec, params, store, cfg = _bench_store(ratio, params=params,
                                                   device=device)
    server = OnlineServer(store, cfg,
                          OnlineConfig(cache_rows=cache_rows,
                                       retier_every=retier_every,
                                       retier_async=retier_async))
    result = serve_forward_loop(
        server, setup.model, spec, params, batch=batch, requests=requests,
        drift=drift, num_dense=setup.ds.cfg.num_dense)
    server.drain_shadow()   # finish and join any shadow build in flight
    fp32 = spec.total_rows * spec.dim * 4
    rec = {"benchmark": "qps_online", "batch": batch,
           "requests": requests, "cache_rows": cache_rows,
           "retier_every": retier_every, "drift": drift,
           "retier_async": retier_async}
    rec.update(result.as_dict())
    rec["packed_fp32_ratio"] = round(server.host_packed.nbytes() / fp32, 4)
    rec.update(_device_keys(setup.device))
    return rec


def _stream_bytes_per_request(packed: ps.PackedStore, spec, requests: int,
                              drift: float, a: float, seed: int) -> dict:
    """Mean bytes per single-user request over the benchmark stream,
    against the pack-time tiers of ``packed``: the same for every sweep
    entry (the schema check rejects a record where it is not)."""
    return stream_bytes_per_request(ps.packed_tiers(packed), spec, requests,
                                    drift=drift, a=a, seed=seed)


def run_online_sweep(serve_batches, requests=384, cache_rows=512,
                     retier_every=128, drift=4.0, ratio=0.5, a=1.2, seed=0,
                     retier_async=False, *, params: dict | None = None,
                     device: str | torch.device | None = None) -> dict:
    """Micro-batched serving sweep: one ``bench_qps/v1`` record.

    Every ``serve_batch`` serves the same drifting-zipf single-user
    stream on a fresh server over the same store; ``retier_every``
    counts requests, so the re-tier cadence is the same too.
    ``retier_async`` runs the re-tiers as shadow builds and swaps."""
    setup, spec, params, store, cfg = _bench_store(ratio, params=params,
                                                   device=device)
    fp32 = spec.total_rows * spec.dim * 4
    initial_pack = ps.pack(store, cfg)
    bytes_rec = _stream_bytes_per_request(initial_pack, spec, requests,
                                          drift, a, seed)
    sweep = []
    for sb in serve_batches:
        server = OnlineServer(store, cfg,
                              OnlineConfig(cache_rows=cache_rows,
                                           retier_every=retier_every,
                                           retier_async=retier_async))
        result = serve_forward_microbatched(
            server, setup.model, spec, params, serve_batch=int(sb),
            requests=requests, drift=drift, a=a,
            num_dense=setup.ds.cfg.num_dense, seed=seed)
        # the record keeps the timed loop's counters; draining joins the
        # staging thread before the next server starts
        server.drain_shadow()
        entry = {"serve_batch": int(sb)}
        entry.update(result.as_dict())
        entry.update(bytes_rec)
        sweep.append(entry)
    rec = {"schema": BENCH_SCHEMA, "benchmark": "qps_online_microbatch",
           "requests": requests, "cache_rows": cache_rows,
           "retier_every": retier_every, "drift": drift,
           "retier_async": retier_async,
           "packed_fp32_ratio": round(initial_pack.nbytes() / fp32, 4),
           "sweep": sweep}
    rec.update(bytes_rec)
    rec.update(_device_keys(setup.device))
    return rec


def _parse_serve_batches(arg: str) -> list[int]:
    return [int(x) for x in arg.split(",") if x.strip()]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="Serving benchmarks: the offline QPS proxy, or with "
                    "--online the online loop (bench_qps/v1).")
    ap.add_argument("--online", action="store_true",
                    help="drifting-zipf online-serving loop (without it: "
                         "the offline proxy)")
    ap.add_argument("--batch", type=int, default=None,
                    help="batch a request (default 512 offline, 256 "
                         "--online)")
    ap.add_argument("--requests", type=int, default=None,
                    help="request-batches (default 24), or single-user "
                         "requests with --serve-batch (default 384)")
    ap.add_argument("--cache-rows", type=int, default=512)
    ap.add_argument("--retier-every", type=int, default=None,
                    help="re-tier cadence in request-batches (default 4), "
                         "or in single-user requests with --serve-batch "
                         "(default 128)")
    ap.add_argument("--drift", type=float, default=4.0)
    ap.add_argument("--retier-async", action="store_true",
                    help="chunked shadow build + swap instead of the "
                         "synchronous repack")
    ap.add_argument("--serve-batch", default=None, metavar="N[,N...]",
                    help="micro-batch sweep: serve the same single-user "
                         "stream at each size; one bench_qps/v1 record")
    ap.add_argument("--emit", default=None, metavar="PATH",
                    help="write the bench_qps/v1 record here "
                         "(--serve-batch)")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises when absent)")
    args = ap.parse_args(argv)
    if not args.online and (args.serve_batch or args.retier_async):
        ap.error("--serve-batch and --retier-async need --online")
    if args.emit and not args.serve_batch:
        ap.error("--emit requires --serve-batch")
    return args


def main(argv=None) -> dict:
    """The CLI: prints the record (and writes it with ``--emit``)."""
    args = parse_args(argv)
    if not args.online:
        rows = run(batch=args.batch or 512, device=args.device)
        for row in rows:
            print(json.dumps(row))
        return {"rows": rows}
    if args.serve_batch:
        rec = run_online_sweep(
            _parse_serve_batches(args.serve_batch),
            requests=args.requests or 384, cache_rows=args.cache_rows,
            retier_every=(128 if args.retier_every is None
                          else args.retier_every),
            drift=args.drift, retier_async=args.retier_async,
            device=args.device)
        if args.emit:
            write_bench_json(rec, args.emit)
    else:
        rec = run_online(
            batch=args.batch or 256, requests=args.requests or 24,
            cache_rows=args.cache_rows,
            retier_every=(4 if args.retier_every is None
                          else args.retier_every),
            drift=args.drift, retier_async=args.retier_async,
            device=args.device)
    print(json.dumps(rec))
    if args.emit:
        print(f"wrote {args.emit}")
    return rec


if __name__ == "__main__":
    main()
