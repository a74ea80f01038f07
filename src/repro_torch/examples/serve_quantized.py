"""Serving batched requests against the tier-packed store.

Simulates the paper's serving deployment: a packed (int8 / bf16 / fp32)
embedding store behind a DLRM ranking head, serving batched requests;
reports the store's bytes against fp32 (the QPS mechanism) and the
latency on this device.  The fused ``dequant_bag`` kernel (one launch
over the three tiers on the card; its plain version on the CPU) is held
to the serving path on one batch.

Port of ``examples/serve_quantized.py``.  Run:

    PYTHONPATH=src python -m repro_torch.examples.serve_quantized \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from repro_torch import resolve_device, sync
from repro_torch.core import qat_store as qs
from repro_torch.core.metrics import auc
from repro_torch.core.packed_store import lookup as packed_lookup
from repro_torch.core.packed_store import pack
from repro_torch.core.tiers import TierConfig, plan_thresholds_for_ratio
from repro_torch.examples.common import batch, small_dlrm, synth
from repro_torch.kernels.dequant_bag.ops import packed_bag_lookup
from repro_torch.models import embedding as E
from repro_torch.optim import rowwise_adagrad
from repro_torch.train import steps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=400,
                    help="train steps (thresholds planned after a fifth)")
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises when absent)")
    args = ap.parse_args(argv)
    if args.steps < 2 or args.requests < 3:
        ap.error("--steps must be >= 2 and --requests >= 3")
    dev = resolve_device(args.device)

    ds = synth(10, seed=2)
    model = small_dlrm(ds)
    spec = model.spec

    # quick train with priorities
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    opt = rowwise_adagrad(0.05)

    def loss_fn(p, b):
        return model.loss_from_emb(p, model.embed(p, b), b).mean()

    def make_step(tiers):
        hook = steps.FQuantHook(
            cfg=qs.FQuantConfig(tiers=tiers), table_path="embed_table",
            indices_fn=lambda b: E.globalize(b["indices"], spec),
            labels_fn=lambda b: b["labels"])
        return steps.make_train_step(loss_fn, opt, hook,
                                     with_metrics=False), hook

    step, hook = make_step(TierConfig(-math.inf, -math.inf))
    state = steps.init_state(model.init(gen, dev), opt, hook, seed=3)
    plan_at = max(1, args.steps // 5)
    for i in range(args.steps):
        if i == plan_at:
            planned = plan_thresholds_for_ratio(state.priority, spec.dim,
                                                0.5)
            step, _ = make_step(planned)
        state, _ = step(state, batch(ds, 512, i, dev))
    params = state.params

    cfg = qs.FQuantConfig(tiers=planned, stochastic=False)
    store = qs.QATStore(params["embed_table"], state.priority)
    store = store._replace(table=qs.snap(
        store.table, qs.current_tiers(store, cfg), cfg))
    packed = pack(store, cfg)
    fp32_bytes = spec.total_rows * spec.dim * 4
    print(f"packed store {packed.nbytes() / 2 ** 20:.1f} MiB "
          f"({packed.nbytes() / fp32_bytes:.1%} of fp32) | tiers: "
          f"{packed.payload8.shape[0]:,} int8 / "
          f"{packed.payload16.shape[0]:,} bf16 / "
          f"{packed.payload32.shape[0]:,} fp32 rows")

    # ---- serve a request stream -------------------------------------------
    def serve(b):
        emb = packed_lookup(packed, E.globalize(b["indices"], spec))
        return model.head(params, emb, b)

    lat, all_scores, all_labels = [], [], []
    with torch.no_grad():
        for r in range(args.requests):
            req = batch(ds, 512, 40_000 + r, dev)
            sync(dev)
            t0 = time.perf_counter()
            scores = serve(req)
            sync(dev)
            lat.append(time.perf_counter() - t0)
            all_scores.append(scores)
            all_labels.append(req["labels"])
    lat_us = np.array(lat[2:]) * 1e6
    serve_auc = float(auc(torch.cat(all_scores), torch.cat(all_labels)))
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "CPU")
    print(f"served {args.requests} batches x512 | AUC {serve_auc:.4f} | "
          f"p50 {np.percentile(lat_us, 50):.0f}us "
          f"p99 {np.percentile(lat_us, 99):.0f}us ({where})")

    # ---- the fused dequant_bag kernel path on one batch -------------------
    req = batch(ds, 64, 60_000, dev)
    gidx = E.globalize(req["indices"], spec)
    with torch.no_grad():
        bags = packed_bag_lookup(packed, gidx)
        rows = packed_lookup(packed, gidx)
    np.testing.assert_allclose(bags.cpu().numpy(),
                               rows.sum(dim=1).cpu().numpy(), rtol=1e-5,
                               atol=1e-5)
    print("fused dequant_bag kernel output verified against serving path")
    return {"serve_auc": serve_auc,
            "packed_fp32_ratio": packed.nbytes() / fp32_bytes,
            "p50_us": float(np.percentile(lat_us, 50)),
            "p99_us": float(np.percentile(lat_us, 99))}


if __name__ == "__main__":
    main()
