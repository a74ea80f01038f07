"""Serving CLI: ``python -m repro_torch.launch.serve --arch dlrm-rm2``.

Port of the flat packed branch of ``repro/launch/serve.py``.  It builds
the tier-partitioned store and serves a batched request stream through
the fused dequant-bag kernel:

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
with its inputs on the device and ends after ``torch.cuda.synchronize()``;
the first request is a warm-up and is left out of the percentiles.

The last stdout line is a JSON record (arch, model, device, device_name,
batch, requests, qps, p50_us, p99_us, packed_mib, packed_fp32_ratio,
kernel_launches, tier_rows [int8, half, fp32], thresholds [t8, t16],
build_s).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.core.packed_store import (PackedStore, build_chunked,
                                           live_counts, lookup_fused)
from repro_torch.core.qat_store import FQuantConfig
from repro_torch.core.tiers import plan_thresholds_for_ratio
from repro_torch.kernels.dequant_bag import kernel as dequant_kernel
from repro_torch.models import embedding as E

SEED = 0
CHUNK_ROWS = 1 << 22     # 1 GB of fp32 rows per build step at D = 64


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="Serve a recsys model from the packed SHARK store.",
        epilog="Not ported yet (later slices): --online, --serve-batch, "
               "--mesh, --store-backend hier|hashed, --retier-async, "
               "--fuse-matmul, --metrics-out.")
    ap.add_argument("--arch", default="dlrm-rm2", choices=configs.names())
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--model", default="full", choices=("full", "smoke"),
                    help="full = the published widths, smoke = the "
                         "reduced test size")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises when absent)")
    return ap.parse_args(argv)


class Served(NamedTuple):
    record: dict
    model: object
    params: dict
    packed: PackedStore
    make_request: Callable[[int], dict]


def serve_request(model, params: dict, packed: PackedStore,
                  batch: dict) -> torch.Tensor:
    """One request: field-local (B, F) indices + dense -> (B,) logits."""
    gidx = E.globalize(batch["indices"], model.spec)
    emb = lookup_fused(packed, gidx)
    return model.head(params, emb, batch)


def request_maker(spec: E.FieldSpec, batch: int, num_dense: int
                  ) -> Callable[[int], dict]:
    """Request ``r`` as CPU tensors, drawn as ``repro/launch/serve.py`` draws
    it: per-field uniform ids and standard-normal dense features."""
    cards = np.asarray(spec.cardinalities, np.int64)

    def make(r: int) -> dict:
        rr = np.random.default_rng(r)
        idx = (rr.random((batch, spec.num_fields)) * cards[None, :]
               ).astype(np.int32)
        dense = np.random.default_rng(10_000 + r).standard_normal(
            (batch, num_dense)).astype(np.float32)
        return {"indices": torch.from_numpy(idx),
                "dense": torch.from_numpy(dense)}
    return make


def build_store(spec: E.FieldSpec, device: torch.device, seed: int = SEED,
                chunk_rows: int = CHUNK_ROWS
                ) -> tuple[PackedStore, FQuantConfig]:
    """Priorities -> 50%-budget thresholds -> chunked snap + pack."""
    pri = (np.random.default_rng(seed).pareto(1.2, spec.total_rows) * 10
           ).astype(np.float32)
    pri = torch.from_numpy(pri).to(device)
    cfg = FQuantConfig(tiers=plan_thresholds_for_ratio(pri, spec.dim, 0.5))
    packed = build_chunked(E.table_rows(spec, seed, device), pri, spec.dim,
                           cfg, chunk_rows=chunk_rows)
    return packed, cfg


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args: argparse.Namespace) -> Served:
    device = resolve_device(args.device)
    arch = configs.get(args.arch)
    full = args.model == "full"
    model = arch.model if full else arch.smoke_model
    num_dense = arch.num_dense if full else arch.smoke_num_dense
    spec = model.spec

    t0 = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    params = model.init(gen, device, with_table=False)
    packed, cfg = build_store(spec, device)
    _sync(device)
    build_s = time.perf_counter() - t0
    fp32 = spec.total_rows * spec.dim * 4
    packed_bytes = packed.nbytes()
    print(f"packed {packed_bytes / 2 ** 20:.2f} MiB "
          f"({packed_bytes / fp32:.1%} of fp32) in {build_s:.1f}s")

    make_request = request_maker(spec, args.batch, num_dense)
    launches0 = dequant_kernel.total_launches()
    lat = []
    with torch.inference_mode():
        for r in range(args.requests):
            batch = {k: v.to(device) for k, v in make_request(r).items()}
            _sync(device)
            t = time.perf_counter()
            serve_request(model, params, packed, batch)
            _sync(device)
            lat.append(time.perf_counter() - t)
    lat_us = np.asarray(lat[1:] if len(lat) > 1 else lat) * 1e6
    p50 = float(np.percentile(lat_us, 50))
    p99 = float(np.percentile(lat_us, 99))
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"{args.requests} requests x{args.batch}: p50 {p50:.0f}us "
          f"p99 {p99:.0f}us ({name})")
    record = {"arch": args.arch, "model": args.model,
              "device": device.type, "device_name": name,
              "batch": args.batch, "requests": args.requests,
              "qps": args.batch / (float(np.mean(lat_us)) / 1e6),
              "p50_us": p50, "p99_us": p99,
              "packed_mib": packed_bytes / 2 ** 20,
              "packed_fp32_ratio": packed_bytes / fp32,
              "kernel_launches": dequant_kernel.total_launches() - launches0,
              "tier_rows": live_counts(packed),
              "thresholds": list(cfg.tiers), "build_s": build_s}
    return Served(record, model, params, packed, make_request)


def main(argv=None) -> None:
    served = run(parse_args(argv))
    print(json.dumps(served.record))


if __name__ == "__main__":
    main()
