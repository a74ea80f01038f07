"""Serving CLI: ``python -m repro_torch.launch.serve --arch dlrm-rm2``.

Port of the flat packed, the hierarchical and the hashed branches of
``repro/launch/serve.py``, offline (the default, packed) and online
(``--online``).  Offline, it builds the
tier-partitioned store and serves a batched request stream through the
fused dequant-bag kernel:

1. pareto(1.2) x 10 row priorities (numpy, seed 0, as the reference
   draws them) feed ``plan_thresholds_for_ratio`` at a 50% byte budget
   (Eq. 8);
2. a random table (seed 0) is snapped and packed chunk by chunk on the
   device (``packed_store.build_chunked``), so the fp32 table never
   exists whole;
3. each request runs ``globalize``, ``packed_store.lookup_fused`` (one
   kernel launch per tier) and the DLRM head.

``--model full`` (the default) serves the published widths: 26 fields,
204,185,088 stacked rows x 64, bottom MLP 13-512-256-64, top MLP
415-512-512-256-1 (the reference CLI serves only its smoke model);
``--model smoke`` the reduced CPU-test size.  The run is on the GPU
unless ``--device cpu`` is given.  The timed window of a request starts
with its inputs on the device and ends when the serving stream is idle;
the first request is a warm-up and is left out of the percentiles.

The offline record: arch, model, device, device_name, batch, requests,
qps, p50_us, p99_us, packed_mib, packed_fp32_ratio, kernel_launches,
tier_rows [int8, half, fp32], thresholds [t8, t16], build_s.

``--online`` serves through ``repro_torch.serve``: the model's random
table (seed 0) is snapped and packed at the 50% budget over the same
pareto priorities, and a drifting-zipf stream (``--drift`` ids/request)
is served cache-first (``--cache-rows`` hot rows in fp32); every batch
is folded into the Eq. 7 EMA and every ``--retier-every`` requests the
tier-crossing rows move (``packed_store.repack_delta``, synchronous, on
the device).  With ``--retier-async`` the re-tier is a shadow build
instead (``serve.shadow``): the boundary request opens it, every later
request quantizes ``--shadow-rows`` of its movers, and the finished
store is staged on a thread (on its own CUDA stream; with
``--verify-swap`` checked bit for bit against a fresh ``pack`` at the
snapshot) and swapped in on a later request; after the loop the last
build is drained and the line ``shadow: N builds, N chunks, N swaps`` is
printed.  ``--fuse-matmul`` (wide-deep, xdeepfm) serves through the
model's fused head: the deep branch's first matmul runs in the
``bag_matmul`` kernel (one launch per tier), and xDeepFM's CIN in the
``cin`` kernel (one launch per layer).  The online record has the
reference's keys (qps, steady_qps, p50/p95/p99_us, latency_p50/95/99,
p99_retier_attributed, p99_while_retiering, requests, lookups, hits,
cache_hit_rate, retiers, rows_moved, shadow_builds, swaps, cache_rows,
retier_every, retier_async, drift, serve_batch, fuse_matmul,
store_backend, packed_mib, packed_fp32_ratio, arch, batch, mesh, online)
plus model, device, device_name, build_s, ``kernel_launches`` by kernel
over the request loop (and the final shadow drain) and
``build_kernel_launches`` over the build (the int8 tier's
``quantize_rowwise`` launches, and the shadow prewarm's one).  At full width the online
store holds the whole fp32 table beside its pack (wide-deep 2.84 GB,
xdeepfm 3.47 GB): ``repack_delta`` re-quantizes crossing rows from it.

``--serve-batch N`` (with ``--online``) switches to the micro-batched
loop (``serve.loop.serve_forward``): single-user requests accumulate
into fixed-shape (N, F) batches (pad + mask), each batch runs one
forward and one vectorised priority fold, and ``--requests`` then counts
single-user requests; the packed record adds the reference's
bytes_per_request_fp32 / bytes_per_request_packed.

``--online --store-backend hashed`` serves from the ROBE-style hashed
store (``store.hashed``) instead of the pack: the snapped table is
fitted into a pool of ``plan_pool_slots`` rows of ``--hash-chunk-dim``
values at a ``--hash-ratio`` fp32-bytes / pool-bytes target (12 CG
steps, ``fit_pool_from_table``), quantized to int8 with per-slot scales
with ``--hash-bits 8`` (``quantize_pool``), and the table is dropped.
Each request materialises its rows through one ``hashed_gather`` launch;
a re-tier moves no rows and refreshes the hot-row cache.  The record
adds the reference's pool_slots, hash_bits and hash_ratio, and fit_s.
As in the reference, hashed needs ``--online`` and has no fused head
(``--fuse-matmul`` is refused), and ``--hash-chunk-dim`` must divide the
embedding dim (xdeepfm's 10 refuses the default 8).

``--hbm-budget-mb B`` (with ``--online --serve-batch N``; the
reference's spelling, ``--store-backend hier`` with it is the same)
serves through the hierarchical store (``store.hier``): the device holds
only the priority-hot rows of the pack under B MiB, host RAM the next
under ``--host-budget-mb`` (0 = unbounded: no cold level), and mmap'd
cold shards under ``--store-dir`` the rest.  Each micro-batch stages its
warm and cold misses through one host buffer and one copy; every
re-tier migrates rows between the levels (``--retier-async``: a
``ShadowMigrate``, one cold shard a request).  ``--verify-hier`` then
folds any movement since the last migration in (one more migration) and
requires every row's lookup to equal the fully resident pack's bit for
bit: each level's bytes looked up on the device in row blocks, and a
sample of 1,048,576 ids through the staging path itself (``verify_hier``);
a mismatch exits non-zero.  The record adds the reference's
hbm_budget_mb and the loop's hier counters, and here level_rows,
level_bytes, serve_s (the loop's wall seconds, the final drain included),
retier_ms (mean wall ms a re-tier), verify_s, build_device_peak_bytes (the
device's allocator peak after the build), device_peak_bytes (at the end)
and host_peak_rss_bytes.  As in the reference, ``--hbm-budget-mb`` refuses
``--fuse-matmul`` (the fused head needs a fully resident store) and
``--store-backend hashed``.  ``run(rows_per_shard=)`` sets the cold
shards' rows (the reference's default 4,096; no flag, as there).

``--mesh N`` (N > 1) row-shards the store over an N-shard mesh
(``repro_torch.dist``) and serves through the sharded gathers: offline
``dist.packed.sharded_lookup`` (one tiered dequant_bag launch a shard a
request), online the backend's sharded ``lookup_fn`` / ``bag_matmul_fn``
(three ``bag_matmul`` launches a shard with ``--fuse-matmul``), the hashed
pool's ``sharded_hashed_lookup`` and the hier store's sharded hot level
(whose planner charges the device its shards' padded bytes); a re-tier
unshards, repacks and reshards on the device.  With one ``--device``,
as on the reference's CPU mesh, all N shards live on it: the path is the
sharded one at full width, the N launches and the shard sum run on one
card.  ``--device`` may instead list one card a shard
(``--device cuda:0,cuda:1,cuda:2,cuda:3 --mesh 4``, parsed by
``launch.mesh``, as the train CLI's): the store is built on the first,
each shard copied to its card, the partials summed on the first (the
reference's ``--mesh N`` over N devices); a listed card that is absent
raises.  The record's ``mesh`` is N.

``--metrics-out PATH`` turns the ``obs`` registry on and writes
``metrics_snapshot/v1`` JSONL there: one line every ``--metrics-every``
served batches (default 16; 0 = the final line only) and one final
line before the record, with the reference's serving span catalog
(``serve.loop.SERVE_PHASES``) pre-registered.  ``main`` closes the sink
on every exit path, so a failed run still writes its last window.
``python tools/check_bench_schema.py PATH`` validates the stream.

The last stdout line is the JSON record.
"""

from __future__ import annotations

import argparse
import json
import resource
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import configs, kernels, obs, sync
from repro_torch.core.packed_store import (PackedStore, build_chunked,
                                           live_counts, lookup, lookup_fused,
                                           pack, packed_tiers)
from repro_torch.core.qat_store import (CHUNK_ROWS, FQuantConfig, QATStore,
                                        current_tiers, snap_)
from repro_torch.core.tiers import plan_thresholds_for_ratio
from repro_torch.dist.packed import ShardedPack, shard_packed, sharded_lookup
from repro_torch.kernels import autotune
from repro_torch.kernels.dequant_bag import kernel as dequant_kernel
from repro_torch.launch.mesh import check_device_arg, mesh_from_args
from repro_torch.models import embedding as E
from repro_torch.serve.loop import (SERVE_PHASES, serve_forward,
                                    serve_forward_loop,
                                    stream_bytes_per_request)
from repro_torch.serve.online import OnlineConfig, OnlineServer
from repro_torch.store import hashed as H
from repro_torch.store.api import build as build_backend
from repro_torch.store.hier import HierConfig, hier_lookup

SEED = 0


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="Serve a recsys model from the packed SHARK store.")
    ap.add_argument("--arch", default="dlrm-rm2", choices=configs.names())
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--model", default="full", choices=("full", "smoke"),
                    help="full = the published widths, smoke = the "
                         "reduced test size")
    ap.add_argument("--device", default=None,
                    help="torch device, or a comma-separated list of one a "
                         "--mesh shard; default cuda (raises when absent)")
    ap.add_argument("--mesh", type=int, default=1,
                    help="row-shard the store over an N-shard 'model' mesh "
                         "(repro_torch.dist; every shard on --device, or "
                         "shard i on its i-th entry)")
    ap.add_argument("--online", action="store_true",
                    help="serve through repro_torch.serve: hot-row cache + "
                         "priority fold + incremental re-tiering under a "
                         "drifting-zipf workload")
    ap.add_argument("--cache-rows", type=int, default=256,
                    help="top-K fp32 hot rows (--online; 0 disables)")
    ap.add_argument("--retier-every", type=int, default=2,
                    help="requests between delta re-tiers (--online; 0 "
                         "disables)")
    ap.add_argument("--drift", type=float, default=4.0,
                    help="zipf hot-set drift in ids/request (--online; 0 = "
                         "stationary)")
    ap.add_argument("--serve-batch", type=int, default=0,
                    help="micro-batch N single-user requests per forward "
                         "(--online; 0 = request-at-a-time batches of "
                         "--batch users); --requests then counts "
                         "single-user requests")
    ap.add_argument("--retier-async", action="store_true",
                    help="shadow-build re-tiers off the request path "
                         "(repro_torch.serve.shadow): the boundary request "
                         "opens a shadow store, later requests advance it "
                         "in bounded chunks, and the finished generation "
                         "is swapped in with one pointer flip (--online)")
    ap.add_argument("--shadow-rows", type=int, default=512,
                    help="shadow build budget in rows per served request "
                         "(--retier-async)")
    ap.add_argument("--verify-swap", action="store_true",
                    help="at every shadow swap, check that the staged "
                         "generation is bit-identical to a full pack() at "
                         "the snapshot fold state (--retier-async; O(vocab) "
                         "a swap, on the staging thread)")
    ap.add_argument("--fuse-matmul", action="store_true",
                    help="serve through the model's fused head: the deep "
                         "branch's first matmul runs fused with the "
                         "embedding gather (kernels.bag_matmul) so the "
                         "(B, F*D) activations never materialise "
                         "(--online; wide-deep / xdeepfm)")
    ap.add_argument("--store-backend", default="packed",
                    choices=("packed", "hier", "hashed"),
                    help="embedding store backend (store.api.build): "
                         "'packed' = flat tier-partitioned store, 'hier' = "
                         "HBM / host / disk levels (--hbm-budget-mb), "
                         "'hashed' = ROBE-style compositional rows "
                         "materialized from a shared chunk pool (--online)")
    ap.add_argument("--hbm-budget-mb", type=float, default=0.0,
                    help="serve through the hierarchical store: the device "
                         "holds only the priority-hot rows under this "
                         "budget, the spill goes to host RAM / disk "
                         "(--online --serve-batch; 0 = fully resident)")
    ap.add_argument("--host-budget-mb", type=float, default=0.0,
                    help="warm (host RAM) budget of the hierarchical store; "
                         "0 = unbounded (no cold level), > 0 spills the "
                         "rest to mmap'd cold shards under --store-dir")
    ap.add_argument("--store-dir", default=None,
                    help="directory of the cold shard files and manifest "
                         "(required when --host-budget-mb makes a cold "
                         "level)")
    ap.add_argument("--verify-hier", action="store_true",
                    help="after serving, check that the hierarchical "
                         "lookup is bit-identical to a fully resident pack "
                         "of the live store over the whole vocab")
    ap.add_argument("--hash-ratio", type=float, default=100.0,
                    help="target fp32-table / pool compression ratio for "
                         "--store-backend hashed (pool rows are planned "
                         "from it)")
    ap.add_argument("--hash-chunk-dim", type=int, default=8,
                    help="pool row width Z for --store-backend hashed "
                         "(must divide the embedding dim)")
    ap.add_argument("--hash-bits", type=int, default=32, choices=(32, 8),
                    help="pool element width for --store-backend hashed: "
                         "32 = fp32 pool, 8 = int8 pool + per-slot scales "
                         "(the SHARK-rowwise x hashing combined mode)")
    ap.add_argument("--autotune-cache", default=None, metavar="PATH",
                    help="measured kernel-tiling cache to serve with "
                         "(kernels.autotune.set_cache_path: sets "
                         "REPRO_AUTOTUNE_CACHE for the process; seed it "
                         "with python -m repro_torch.benchmarks.kernels "
                         "--seed-cache).  Default: results/autotune.json "
                         "when present")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="enable the repro_torch.obs registry and write "
                         "metrics_snapshot/v1 JSONL here (one line every "
                         "--metrics-every served batches + a final "
                         "snapshot); docs/observability.md")
    ap.add_argument("--metrics-every", type=int, default=16,
                    help="snapshot cadence in served batches for "
                         "--metrics-out (0 = final snapshot only)")
    args = ap.parse_args(argv)
    if args.mesh < 1:
        ap.error("--mesh must be >= 1")
    check_device_arg(ap, args)
    if args.serve_batch > 0 and not args.online:
        ap.error("--serve-batch requires --online")
    if args.hbm_budget_mb > 0 and args.serve_batch <= 0:
        ap.error("--hbm-budget-mb requires --online --serve-batch N")
    if args.verify_hier and args.hbm_budget_mb <= 0:
        ap.error("--verify-hier requires --hbm-budget-mb")
    if args.retier_async and not args.online:
        ap.error("--retier-async requires --online")
    if args.verify_swap and not args.retier_async:
        ap.error("--verify-swap requires --retier-async")
    if args.fuse_matmul and not args.online:
        ap.error("--fuse-matmul requires --online")
    if args.fuse_matmul and args.hbm_budget_mb > 0:
        ap.error("--fuse-matmul requires a fully resident store "
                 "(no --hbm-budget-mb)")
    if args.hbm_budget_mb > 0 and args.store_backend == "packed":
        args.store_backend = "hier"     # the reference's spelling
    if args.store_backend == "hier" and args.hbm_budget_mb <= 0:
        ap.error("--store-backend hier needs --hbm-budget-mb")
    if args.store_backend == "hashed":
        if not args.online:
            ap.error("--store-backend hashed requires --online")
        if args.hbm_budget_mb > 0:
            ap.error("--store-backend hashed is incompatible with "
                     "--hbm-budget-mb")
        if args.fuse_matmul:
            ap.error("--store-backend hashed has no fused bag->matmul path "
                     "(rows materialize on the fly)")
        if args.verify_hier:
            ap.error("--verify-hier requires the hier backend")
    return args


class Served(NamedTuple):
    record: dict
    model: object
    params: dict
    packed: PackedStore
    make_request: Callable[[int], dict] | None
    server: OnlineServer | None = None


def serve_request(model, params: dict, packed, batch: dict) -> torch.Tensor:
    """One request: field-local (B, F) indices + dense -> (B,) logits,
    through ``sharded_lookup`` when ``packed`` is row-sharded."""
    gidx = E.globalize(batch["indices"], model.spec)
    if isinstance(packed, ShardedPack):
        emb = sharded_lookup(packed, gidx)
    else:
        emb = lookup_fused(packed, gidx)
    return model.head(params, emb, batch)


def make_mesh_arg(args: argparse.Namespace):
    """``--mesh N`` over ``--device`` (``launch.mesh.mesh_from_args``):
    None at 1 (the unsharded path, as the reference CLI), else N shards on
    the one device or one on each listed card."""
    return mesh_from_args(args.device, args.mesh)[1]


def time_requests(model, params: dict, packed,
                  make_request: Callable[[int], dict], requests: int,
                  device: torch.device, start: int = 0) -> list[float]:
    """The offline loop: requests ``start .. start + requests - 1``, each
    timed from its inputs on the device to the end of its device work
    (the ``serve.request`` timeblock, then one ``obs.tick()``); the wall
    seconds of each."""
    lat = []
    with torch.inference_mode():
        for r in range(start, start + requests):
            batch = {k: v.to(device) for k, v in make_request(r).items()}
            sync(device)
            with obs.timeblock("serve.request") as tb:
                serve_request(model, params, packed, batch)
                sync(device)
            lat.append(tb.seconds)
            obs.tick()
    return lat


def request_maker(spec: E.FieldSpec, batch: int, num_dense: int
                  ) -> Callable[[int], dict]:
    """Request ``r`` as CPU tensors, drawn as ``repro/launch/serve.py`` draws
    it: per-field uniform ids and standard-normal dense features."""
    cards = np.asarray(spec.cardinalities, np.int64)

    def make(r: int) -> dict:
        rr = np.random.default_rng(r)
        idx = (rr.random((batch, spec.num_fields)) * cards[None, :]
               ).astype(np.int32)
        out = {"indices": torch.from_numpy(idx)}
        if num_dense:
            out["dense"] = torch.from_numpy(
                np.random.default_rng(10_000 + r).standard_normal(
                    (batch, num_dense)).astype(np.float32))
        return out
    return make


def plan_store(spec: E.FieldSpec, device: torch.device, seed: int = SEED
               ) -> tuple[torch.Tensor, FQuantConfig]:
    """The reference CLI's pareto(1.2) x 10 row priorities (numpy) and the
    50%-budget thresholds planned from them."""
    pri = (np.random.default_rng(seed).pareto(1.2, spec.total_rows) * 10
           ).astype(np.float32)
    pri = torch.from_numpy(pri).to(device)
    cfg = FQuantConfig(tiers=plan_thresholds_for_ratio(pri, spec.dim, 0.5),
                       stochastic=False)
    return pri, cfg


def build_store(spec: E.FieldSpec, device: torch.device, seed: int = SEED,
                chunk_rows: int = CHUNK_ROWS
                ) -> tuple[PackedStore, FQuantConfig]:
    """Priorities -> 50%-budget thresholds -> chunked snap + pack."""
    pri, cfg = plan_store(spec, device, seed)
    packed = build_chunked(E.table_rows(spec, seed, device), pri, spec.dim,
                           cfg, chunk_rows=chunk_rows)
    return packed, cfg


def online_store(model, spec: E.FieldSpec, device: torch.device,
                 seed: int = SEED) -> tuple[dict, QATStore, FQuantConfig]:
    """The online path's start: (head params, snapped ``QATStore``,
    config).  The model's table is drawn whole (seed ``seed``) and
    snapped to the tiers of ``plan_store``'s priorities, as the
    reference CLI does before it hands the store to ``OnlineServer``.
    The snap runs in place in row blocks (``snap_``; row-wise, so the
    values are a whole snap's): at dlrm-rm2's 204,185,088 x 64 a second
    52.3 GB table does not fit beside the first."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = model.init(gen, device, with_table=True)
    table = params.pop("embed_table")
    pri, cfg = plan_store(spec, device, seed)
    store = QATStore(table, pri)
    return params, store._replace(
        table=snap_(table, current_tiers(store, cfg), cfg)), cfg


def run(args: argparse.Namespace, make_audit: Callable | None = None,
        rows_per_shard: int = 4096) -> Served:
    """Serve as ``args`` say.  ``make_audit(server, model, params)``
    (online only) returns the loop's ``audit`` hook (see
    ``serve.loop.run_loop``; with ``--serve-batch``, the hook of
    ``serve.loop.serve_forward``).  ``rows_per_shard``: the hier store's
    cold shard rows.  With ``--metrics-out`` the registry is
    on from here and one snapshot is flushed before returning; the
    caller closes the sink (``obs.close_sink``), as ``main`` does."""
    device = mesh_from_args(args.device, args.mesh)[0]
    if args.autotune_cache is not None:
        autotune.set_cache_path(args.autotune_cache)
    arch = configs.get(args.arch)
    if arch.family != "recsys" or arch.seq_model:
        raise SystemExit("the serve CLI serves field-based recsys archs only")
    if args.metrics_out:
        obs.enable()
        # the whole phase catalog, so snapshots carry every histogram,
        # phases this run never exercises included
        obs.ensure_histograms(f"{p}_us" for p in SERVE_PHASES)
        obs.set_sink(obs.JsonlSink(args.metrics_out,
                                   every=args.metrics_every))
    full = args.model == "full"
    model = arch.model if full else arch.smoke_model
    num_dense = arch.num_dense if full else arch.smoke_num_dense
    spec = model.spec
    if args.online:
        served = run_online(args, device, model, num_dense, make_audit,
                            rows_per_shard)
        obs.flush()
        return served

    t0 = time.perf_counter()
    launches0 = kernels.launch_counts()
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    params = model.init(gen, device, with_table=False)
    packed, cfg = build_store(spec, device)
    mesh = make_mesh_arg(args)
    if mesh is not None:
        packed = shard_packed(packed, mesh)
    sync(device)
    build_s = time.perf_counter() - t0
    build_launches = _launches_since(launches0)
    fp32 = spec.total_rows * spec.dim * 4
    packed_bytes = packed.nbytes()
    print(f"packed {packed_bytes / 2 ** 20:.2f} MiB "
          f"({packed_bytes / fp32:.1%} of fp32) in {build_s:.1f}s")

    make_request = request_maker(spec, args.batch, num_dense)
    launches0 = dequant_kernel.total_launches()
    lat = time_requests(model, params, packed, make_request, args.requests,
                        device)
    lat_us = np.asarray(lat[1:] if len(lat) > 1 else lat) * 1e6
    p50 = float(np.percentile(lat_us, 50))
    p99 = float(np.percentile(lat_us, 99))
    name = _device_name(device)
    print(f"{args.requests} requests x{args.batch}: p50 {p50:.0f}us "
          f"p99 {p99:.0f}us ({name}, mesh={args.mesh})")
    record = {"arch": args.arch, "model": args.model,
              "device": device.type, "device_name": name,
              "batch": args.batch, "requests": args.requests,
              "mesh": args.mesh,
              "qps": args.batch / (float(np.mean(lat_us)) / 1e6),
              "p50_us": p50, "p99_us": p99,
              "packed_mib": packed_bytes / 2 ** 20,
              "packed_fp32_ratio": packed_bytes / fp32,
              "kernel_launches": dequant_kernel.total_launches() - launches0,
              "tier_rows": live_counts(packed),
              "thresholds": list(cfg.tiers), "build_s": build_s,
              "build_kernel_launches": build_launches}
    obs.flush()
    return Served(record, model, params, packed, make_request)


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def _launches_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in kernels.launch_counts().items()}


def hashed_backend(args: argparse.Namespace, spec: E.FieldSpec,
                   store: QATStore, mesh=None):
    """The hashed store of the reference CLI: a pool planned for
    ``--hash-ratio``, fitted to the snapped table (with the store's
    priorities) and, for ``--hash-bits 8``, quantized to int8; its pool
    row-sharded over ``mesh`` when given."""
    hcfg = H.HashedConfig(
        vocab=spec.total_rows, dim=spec.dim, chunk_dim=args.hash_chunk_dim,
        num_slots=H.plan_pool_slots(spec.total_rows, spec.dim,
                                    args.hash_chunk_dim, args.hash_ratio,
                                    pool_bits=args.hash_bits),
        pool_bits=args.hash_bits)
    hs = H.fit_pool_from_table(store.table, hcfg, priority=store.priority)
    if args.hash_bits == 8:
        hs = H.quantize_pool(hs)
    return build_backend("hashed", hs, hcfg, mesh=mesh), hcfg


def hier_config(args: argparse.Namespace,
                rows_per_shard: int = 4096) -> HierConfig:
    """The hier store's budgets from the flags (MiB; a host budget of 0 is
    unbounded: no cold level)."""
    return HierConfig(
        hbm_budget_bytes=int(args.hbm_budget_mb * 2 ** 20),
        host_budget_bytes=(int(args.host_budget_mb * 2 ** 20)
                           if args.host_budget_mb > 0 else None),
        rows_per_shard=rows_per_shard, store_dir=args.store_dir)


def verify_hier(server: OnlineServer, sample_rows: int = 1 << 20) -> None:
    """``--verify-hier``: one more migration (so the levels' tiers are the
    live fold state's), then every row against the fully resident pack,
    bit for bit: each level's rows in blocks of 4,194,304 cut out of it and
    looked up on the device (the hot level through the serving gather,
    ``lookup_fused``), each block against the pack of its own rows
    (row-wise, so ``pack``'s bytes); and ``sample_rows`` ids spread over
    the whole table through the serving path itself (``hier_lookup``: the
    host stage of the warm and cold misses, the combine), against the
    pack's plain lookup of the same rows.  (The reference sends every row
    through the staging path: at dlrm-rm2's 204,185,088 rows that is
    ~52 GB of host dequant.)  Raises ``SystemExit`` on a mismatch."""
    server.retier()
    hier, store, cfg = server.hier, server.store, server.cfg
    dev = server.device
    block_fn = lookup_fused
    if hier.mesh is not None:       # each hot block through the mesh
        def block_fn(sub, idx, mesh=hier.mesh):
            return sharded_lookup(shard_packed(sub, mesh), idx, mesh=mesh)
    with torch.inference_mode():
        bad = hier.mismatch_pack(store, cfg, block_fn)
        ids = np.unique(np.linspace(0, hier.vocab - 1, sample_rows)
                        .astype(np.int64))
        sel = torch.from_numpy(ids).to(dev)
        ref = lookup(pack(QATStore(store.table[sel], store.priority[sel]),
                          cfg), torch.arange(ids.size, device=dev))
        got = hier_lookup(hier, ids)
        bad |= (ref.view(torch.int32) != got.view(torch.int32)).any()
    if bool(bad):
        raise SystemExit("hier verify FAILED: hierarchical lookup is not "
                         "bit-identical to the fully resident pack")
    print(f"hier verify OK: {hier.vocab} rows bit-identical across "
          f"{hier.counts()} after {hier.stats.migrations} migrations "
          f"({ids.size} of them through the staging path)")


def run_online(args: argparse.Namespace, device: torch.device, model,
               num_dense: int, make_audit: Callable | None,
               rows_per_shard: int = 4096) -> Served:
    spec = model.spec
    t0 = time.perf_counter()
    launches0 = kernels.launch_counts()
    params, store, cfg = online_store(model, spec, device)
    online = OnlineConfig(cache_rows=args.cache_rows,
                          retier_every=args.retier_every,
                          retier_async=args.retier_async,
                          shadow_rows_per_step=args.shadow_rows,
                          verify_swap=args.verify_swap)
    fp32 = spec.total_rows * spec.dim * 4
    hashed = {}
    mesh = make_mesh_arg(args)
    if args.store_backend == "hashed":
        t1 = time.perf_counter()
        backend, hcfg = hashed_backend(args, spec, store, mesh)
        sync(device)
        hashed["fit_s"] = time.perf_counter() - t1
        del store              # the pool replaces the table
        server = OnlineServer(online=online, backend=backend)
    else:
        server = OnlineServer(
            store, cfg, online, mesh=mesh,
            hier=(hier_config(args, rows_per_shard)
                  if args.store_backend == "hier" else None))
        del store
    sync(device)
    build_s = time.perf_counter() - t0
    build_peak = peak_memory(device)["device_peak_bytes"]
    build_launches = _launches_since(launches0)
    packed_bytes = server.backend.nbytes()
    if hashed:
        hashed.update({"pool_slots": int(hcfg.num_slots),
                       "hash_bits": args.hash_bits,
                       "hash_ratio": round(fp32 / packed_bytes, 2)})
        print(f"hashed pool {hcfg.num_slots} x {hcfg.chunk_dim} @ "
              f"{args.hash_bits}b = {packed_bytes / 2 ** 20:.3f} MiB "
              f"({fp32 / packed_bytes:.0f}x vs fp32 table), fitted in "
              f"{hashed['fit_s']:.1f}s")
    hier = server.hier
    if hier is not None:
        print(f"hier {packed_bytes / 2 ** 20:.2f} MiB total, levels "
              f"{hier.nbytes()} rows {hier.counts()}")
    print(f"packed {packed_bytes / 2 ** 20:.2f} MiB "
          f"({packed_bytes / fp32:.1%} of fp32), cache {args.cache_rows} "
          f"rows, retier every {args.retier_every} requests, built in "
          f"{build_s:.1f}s")
    stream = {}
    launches0 = kernels.launch_counts()
    t_serve = time.perf_counter()
    audit = (make_audit(server, model, params)
             if make_audit is not None else None)
    if args.serve_batch > 0:
        if not hashed:
            stream = stream_bytes_per_request(
                hier.tiers if hier is not None
                else packed_tiers(server.packed), spec, args.requests,
                drift=args.drift)
        result = serve_forward(
            server, model, spec, params, serve_batch=args.serve_batch,
            requests=args.requests, drift=args.drift, num_dense=num_dense,
            fuse_matmul=args.fuse_matmul, audit=audit)
        shape_note = (f"{args.requests} requests micro-batched "
                      f"x{args.serve_batch}")
    else:
        result = serve_forward_loop(
            server, model, spec, params, batch=args.batch,
            requests=args.requests, drift=args.drift, num_dense=num_dense,
            fuse_matmul=args.fuse_matmul, audit=audit)
        shape_note = f"{args.requests} requests x{args.batch}"
    if args.retier_async:
        # finish any shadow build in flight, so the process ends on a
        # committed generation (verify_swap checks this swap too); the
        # record keeps the loop's counters, as the reference's does
        server.drain_shadow()
        print(f"shadow: {server.stats.shadow_builds} builds, "
              f"{server.stats.shadow_chunks} chunks, "
              f"{server.stats.swaps} swaps"
              + (" (bit-identity verified at every swap)"
                 if args.verify_swap else ""))
    sync(device)
    serve_s = time.perf_counter() - t_serve
    launches = _launches_since(launches0)
    name = _device_name(device)
    print(f"{shape_note}: p50 "
          f"{result.p50_us:.0f}us p99 {result.p99_us:.0f}us steady "
          f"{result.steady_qps:.0f} qps hit-rate "
          f"{server.stats.hit_rate:.1%} retiers {server.stats.retiers} "
          f"rows moved {server.stats.rows_moved} ({name}, "
          f"mesh={args.mesh})")
    rec = {"arch": args.arch, "batch": args.batch,
           "requests": args.requests, "mesh": args.mesh, "online": True}
    rec.update(stream)
    rec.update(result.as_dict())
    rec.update({"cache_rows": args.cache_rows,
                "retier_every": args.retier_every,
                "retier_async": args.retier_async,
                "drift": args.drift, "serve_batch": args.serve_batch,
                "fuse_matmul": args.fuse_matmul,
                "store_backend": args.store_backend,
                "packed_mib": round(packed_bytes / 2 ** 20, 3),
                "packed_fp32_ratio": round(packed_bytes / fp32, 4)})
    rec.update(hashed)
    if hier is not None:
        rec.update({"hbm_budget_mb": args.hbm_budget_mb,
                    "build_device_peak_bytes": build_peak,
                    "level_rows": hier.counts(),
                    "level_bytes": hier.nbytes(),
                    "serve_s": serve_s,
                    "retier_ms": (server.stats.retier_seconds * 1e3
                                  / max(server.stats.retiers, 1))})
    rec.update({"model": args.model, "device": device.type,
                "device_name": name, "build_s": build_s,
                "kernel_launches": launches,
                "build_kernel_launches": build_launches})
    if hier is not None:
        if args.verify_hier:
            t1 = time.perf_counter()
            verify_hier(server)
            sync(device)
            rec["verify_s"] = time.perf_counter() - t1
        rec.update(peak_memory(device))
    return Served(rec, model, params, server.packed, None, server)


def peak_memory(device: torch.device) -> dict:
    """The device's allocator peak and the process's peak resident set, in
    bytes."""
    return {"device_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else 0),
            "host_peak_rss_bytes": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss * 1024}


def main(argv=None) -> None:
    """The CLI; the metrics sink is closed on every exit path (its last
    partial window is what a failed run needs)."""
    try:
        served = run(parse_args(argv))
        print(json.dumps(served.record))
    finally:
        obs.close_sink()


if __name__ == "__main__":
    main()
