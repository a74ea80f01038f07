"""Sharded serving QPS: the SHARK +30% QPS claim under distribution.

    python -m repro_torch.benchmarks.qps_sharded [--meshes 1,2,4] \\
        [--requests 48] [--serve-batches 1,8] [--retier-async] \\
        [--emit-dir DIR] [--device cpu]

Port of ``benchmarks/qps_sharded.py``.  For each mesh size it runs
``repro_torch.launch.serve --online --serve-batch SB --mesh N`` at the
reference CLI's model (the smoke dlrm-rm2) once per serve batch and folds
the runs into one ``bench_qps/v1`` record (benchmark
``qps_online_microbatch_sharded``), the contract of ``benchmarks.qps
--online --serve-batch``: the echoed top-level keys of the first run and
one sweep entry a serve batch.  ``python tools/check_bench_schema.py
FILE`` validates each.  The reference spawns one process a mesh size
because XLA fixes its device count at start-up; the port runs each in
process (``serve.run``; its progress lines go to stderr).  All N shards
live on the one device the run uses (``repro_torch.dist``), so the record
measures the sharded path's per-shard launches and shard sums, not a
collective across cards.  ``--emit-dir DIR`` writes
``DIR/BENCH_qps_mesh<N>.json`` (nothing is written without it; the
repository's ``BENCH_*.json`` are the JAX package's records); without it
each record is printed as a JSON line.  The records add ``device`` and
``device_name``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

BENCH_SCHEMA = "bench_qps/v1"
TOP_ECHO = ("requests", "cache_rows", "retier_every", "drift",
            "retier_async", "packed_fp32_ratio",
            "bytes_per_request_fp32", "bytes_per_request_packed")
SWEEP_KEYS = ("serve_batch", "qps", "steady_qps", "p50_us", "p95_us",
              "p99_us", "latency_p50", "latency_p95", "latency_p99",
              "p99_retier_attributed", "p99_while_retiering",
              "requests", "lookups", "hits", "cache_hit_rate",
              "retiers", "rows_moved", "swaps", "shadow_builds",
              "bytes_per_request_fp32", "bytes_per_request_packed")


def serve_record(mesh: int, requests: int, serve_batch: int,
                 retier_every: int, arch: str = "dlrm-rm2",
                 retier_async: bool = False, device=None) -> dict:
    """One online micro-batched serve run at mesh size ``mesh``: its
    record (``launch.serve``'s last line)."""
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--model", "smoke", "--requests", str(requests),
            "--mesh", str(mesh), "--online", "--serve-batch",
            str(serve_batch), "--retier-every", str(retier_every)]
    if retier_async:
        argv.append("--retier-async")
    if device is not None:
        argv += ["--device", str(device)]
    with contextlib.redirect_stdout(sys.stderr):
        return serve.run(serve.parse_args(argv)).record


def mesh_bench(mesh: int, serve_batches=(1, 8), requests: int = 48,
               retier_every: int = 24, retier_async: bool = False,
               device=None) -> dict:
    """One ``bench_qps/v1`` record: the serve-batch sweep at one mesh size
    (the sweep axis stays the serve batch: the schema holds
    bytes_per_request equal across entries, which holds only when every
    entry serves the same stream against the same pack)."""
    recs = [serve_record(mesh, requests, sb, retier_every,
                         retier_async=retier_async, device=device)
            for sb in serve_batches]
    out = {"schema": BENCH_SCHEMA,
           "benchmark": "qps_online_microbatch_sharded", "mesh": mesh}
    out.update({k: recs[0][k] for k in TOP_ECHO})
    out["sweep"] = [{k: rec[k] for k in SWEEP_KEYS} for rec in recs]
    out["device"] = recs[0]["device"]
    out["device_name"] = recs[0]["device_name"]
    return out


def run(meshes=(1, 2, 4), requests=48, batch=None, serve_batches=(1, 8),
        device=None) -> list[dict]:
    """The runner's job: one CSV row per (mesh, serve batch).  ``batch`` is
    the runner's signature and unused (the online path is
    micro-batched)."""
    del batch
    rows = []
    for n in meshes:
        rec = mesh_bench(n, serve_batches, requests=requests, device=device)
        for entry in rec["sweep"]:
            rows.append({
                "metric": f"qps_mesh{n}_sb{entry['serve_batch']}",
                "value": entry["steady_qps"],
                "p50_us": entry["p50_us"], "p99_us": entry["p99_us"],
                "cache_hit_rate": entry["cache_hit_rate"]})
    return rows


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--meshes", default="1,2,4")
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--serve-batches", default="1,8")
    ap.add_argument("--retier-async", action="store_true",
                    help="serve with the chunked shadow build + swap")
    ap.add_argument("--emit-dir", default=None, metavar="DIR",
                    help="write BENCH_qps_mesh<N>.json per mesh size")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises when absent)")
    return ap.parse_args(argv)


def main(argv=None) -> dict[int, dict]:
    """The CLI; returns the records by mesh size."""
    args = parse_args(argv)
    meshes = [int(x) for x in args.meshes.split(",") if x.strip()]
    sbs = tuple(int(x) for x in args.serve_batches.split(",") if x.strip())
    out = {}
    for n in meshes:
        rec = mesh_bench(n, sbs, requests=args.requests,
                         retier_async=args.retier_async, device=args.device)
        out[n] = rec
        if args.emit_dir:
            path = os.path.join(args.emit_dir, f"BENCH_qps_mesh{n}.json")
            with open(path, "w") as f:
                json.dump(rec, f, indent=1, sort_keys=True)
                f.write("\n")
            print(f"wrote {path}")
        else:
            print(json.dumps(rec))
    return out


if __name__ == "__main__":
    main()
