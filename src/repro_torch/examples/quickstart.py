"""Quickstart: SHARK end to end in about a minute.

  1. train a small DLRM on synthetic click logs with F-Quantization
     (priorities + tier snapping in the train step),
  2. score feature fields with F-Permutation (first-order Taylor),
  3. prune the weakest fields, finetune,
  4. pack the table into the tier-partitioned serving store and serve.

Port of ``examples/quickstart.py``.  Run:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import taylor
from repro_torch.core.metrics import auc
from repro_torch.core.packed_store import lookup as packed_lookup
from repro_torch.core.packed_store import pack
from repro_torch.core.qat_store import FQuantConfig, QATStore
from repro_torch.core.tiers import (TierConfig, assign_tiers,
                                    plan_thresholds_for_ratio)
from repro_torch.examples.common import (batch, compression_ratio,
                                         small_dlrm, synth)
from repro_torch.models import embedding as E
from repro_torch.optim import rowwise_adagrad
from repro_torch.train import steps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=600,
                    help="F-Quantization train steps (thresholds planned "
                         "after a sixth of them)")
    ap.add_argument("--finetune-steps", type=int, default=150)
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises when absent)")
    args = ap.parse_args(argv)
    if args.steps < 2:
        ap.error("--steps must be >= 2 (warm-up, then planned tiers)")
    dev = resolve_device(args.device)

    # ----- data + model ---------------------------------------------------
    ds = synth(10, noise=0.3)
    model = small_dlrm(ds)
    spec = model.spec
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init(gen, dev)
    print(f"model: DLRM, {spec.num_fields} fields, "
          f"{spec.total_rows:,} embedding rows x {spec.dim}")

    # ----- F-Quantization training (Eq. 5-8) ------------------------------
    opt = rowwise_adagrad(0.05)
    mask = torch.ones(spec.num_fields, device=dev)

    def loss_fn(p, b):
        return model.loss_from_emb(p, model.embed(p, b, mask), b).mean()

    def make_step(tiers: TierConfig):
        hook = steps.FQuantHook(
            cfg=FQuantConfig(tiers=tiers), table_path="embed_table",
            indices_fn=lambda b: E.globalize(b["indices"], spec),
            labels_fn=lambda b: b["labels"])
        return steps.make_train_step(loss_fn, opt, hook), hook

    # warm-up: pure fp32 while priorities form
    step, hook = make_step(TierConfig(-math.inf, -math.inf))
    state = steps.init_state(params, opt, hook, seed=42)
    warmup = max(1, args.steps // 6)
    planned = None
    for i in range(args.steps):
        if i == warmup:          # plan thresholds for a 50% memory budget
            planned = plan_thresholds_for_ratio(state.priority, spec.dim,
                                                0.5)
            step, _ = make_step(planned)
            print(f"planned thresholds t8={planned.t8:.3g} "
                  f"t16={planned.t16:.3g}")
        state, m = step(state, batch(ds, 512, i, dev))
    tiers = assign_tiers(state.priority, planned)
    ratio = compression_ratio(tiers, spec.dim)
    print(f"train loss {float(m['loss']):.4f}; memory at {ratio:.1%} of "
          "fp32")

    # ----- F-Permutation field scores (Eq. 4) ----------------------------
    eval_batches = [batch(ds, 512, 9000 + i, dev) for i in range(4)]
    scores, _, _ = taylor.fperm_scores(
        lambda p, b: model.embed(p, b), model.loss_from_emb, state.params,
        eval_batches)
    order = np.argsort(scores.cpu().numpy())
    print("field importance (least->most):", order.tolist())
    print("planted-dead fields          :",
          sorted(ds.lossless_fields().tolist()))

    # prune the 3 weakest, finetune briefly
    mask[torch.from_numpy(order[:3].copy()).to(dev)] = 0.0
    for i in range(args.finetune_steps):
        state, m = step(state, batch(ds, 512, 700 + i, dev))

    # ----- pack + serve ----------------------------------------------------
    store = QATStore(state.params["embed_table"], state.priority)
    packed = pack(store, FQuantConfig(tiers=planned, stochastic=False))
    fp32_mib = spec.total_rows * spec.dim * 4 / 2 ** 20
    print(f"packed store: {packed.nbytes() / 2 ** 20:.1f} MiB "
          f"(fp32 would be {fp32_mib:.1f})")

    test = batch(ds, 4096, 12345, dev)
    with torch.no_grad():
        emb = packed_lookup(packed, E.globalize(test["indices"], spec))
        emb = emb * mask[None, :, None]
        logits = model.head(state.params, emb, test)
    serve_auc = float(auc(logits, test["labels"]))
    print(f"serving AUC from the packed store: {serve_auc:.4f}")
    return {"memory_ratio": ratio, "serve_auc": serve_auc,
            "pruned": sorted(int(f) for f in order[:3]),
            "packed_mib": packed.nbytes() / 2 ** 20}


if __name__ == "__main__":
    main()
