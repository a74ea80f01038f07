"""End-to-end SHARK compression (the paper's production pipeline).

Full Algorithm 1 (iterative prune -> finetune -> evaluate with the
T_accuracy guard), then F-Quantization at a target memory budget, with
the combined memory report of Table 4.

Port of ``examples/compress_dlrm.py``.  Run:

    PYTHONPATH=src python -m repro_torch.examples.compress_dlrm \\
        [--steps 700] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.metrics import auc
from repro_torch.core.pruning import PruneConfig, prune_loop
from repro_torch.core.qat_store import FQuantConfig
from repro_torch.core.tiers import assign_tiers, plan_thresholds_for_ratio
from repro_torch.examples.common import (batch, compression_ratio,
                                         small_dlrm, synth)
from repro_torch.models import embedding as E
from repro_torch.optim import rowwise_adagrad
from repro_torch.train import steps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=700)
    ap.add_argument("--rate-c", type=float, default=0.55,
                    help="memory target for pruning (fraction kept)")
    ap.add_argument("--t-accuracy", type=float, default=0.9925,
                    help="paper guard: stop below this x base metric")
    ap.add_argument("--finetune-steps", type=int, default=100,
                    help="support-set finetune steps a pruning iteration")
    ap.add_argument("--fquant-steps", type=int, default=300,
                    help="F-Quantization steps (thresholds planned after "
                         "a fifth of them)")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises when absent)")
    args = ap.parse_args(argv)
    if args.fquant_steps < 2:
        ap.error("--fquant-steps must be >= 2")
    dev = resolve_device(args.device)

    ds = synth(12, seed=1, noise=0.3)
    model = small_dlrm(ds)
    spec = model.spec
    opt = rowwise_adagrad(0.05)

    def masked_loss(mask):
        def loss(p, b):
            return model.loss_from_emb(p, model.embed(p, b, mask), b).mean()
        return loss

    def train(params, n, mask=None, start=0):
        m = torch.ones(spec.num_fields, device=dev) if mask is None else \
            mask.to(dev, torch.float32)
        step = steps.make_train_step(masked_loss(m), opt, with_metrics=False)
        state = steps.init_state(params, opt)
        for i in range(n):
            state, _ = step(state, batch(ds, 512, start + i, dev))
        return state.params

    print("== pre-training the base model ==")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = train(model.init(gen, dev), args.steps)

    eval_batches = [batch(ds, 1024, 50_000 + i, dev) for i in range(8)]

    def eval_metric_fn(p, mask):
        m = mask.to(dev, torch.float32)
        with torch.no_grad():
            s = torch.cat([model.forward(p, b, m) for b in eval_batches])
        lab = torch.cat([b["labels"] for b in eval_batches])
        return float(auc(s, lab))

    def finetune_fn(p, mask, n):
        return train(p, n, mask=mask, start=70_000)

    base_auc = eval_metric_fn(params, torch.ones(spec.num_fields))
    print(f"base AUC {base_auc:.4f}")

    print("== Algorithm 1: F-Permutation pruning ==")
    result = prune_loop(
        params, model.embed, model.loss_from_emb, eval_metric_fn,
        finetune_fn, lambda: eval_batches, spec.table_bytes(),
        PruneConfig(rate_c=args.rate_c, t_accuracy=args.t_accuracy,
                    finetune_steps=args.finetune_steps))
    for e in result.log:
        print(f"  iter {e.iteration}: pruned field {e.pruned_field:2d} "
              f"-> AUC {e.metric:.4f}, memory {e.remaining_memory:.1%} "
              f"({e.seconds:.1f}s)")
    print(f"pruned model: AUC {result.final_metric:.4f} "
          f"(guard {args.t_accuracy:.2%} of {result.base_metric:.4f}), "
          f"memory {result.remaining_memory:.1%}")
    print(f"planted-dead fields: {sorted(ds.lossless_fields().tolist())}; "
          f"pruned: {sorted(int(f) for f in result.ranking())}")

    print("== F-Quantization at a 50% budget on the survivors ==")
    mask = torch.from_numpy(result.field_mask.astype(np.float32)).to(dev)
    hook = steps.FQuantHook(
        cfg=FQuantConfig(), table_path="embed_table",
        indices_fn=lambda b: E.globalize(b["indices"], spec),
        labels_fn=lambda b: b["labels"])
    step = steps.make_train_step(masked_loss(mask), opt, hook,
                                 with_metrics=False)
    state = steps.init_state(result.params, opt, hook, seed=7)
    planned = None
    plan_at = max(1, args.fquant_steps // 5)
    for i in range(args.fquant_steps):
        if i == plan_at:
            planned = plan_thresholds_for_ratio(state.priority, spec.dim,
                                                0.5)
            step = steps.make_train_step(
                masked_loss(mask), opt,
                hook._replace(cfg=FQuantConfig(tiers=planned)),
                with_metrics=False)
        state, _ = step(state, batch(ds, 512, 90_000 + i, dev))

    quant_auc = eval_metric_fn(state.params, mask)
    quant_ratio = compression_ratio(assign_tiers(state.priority, planned),
                                    spec.dim)
    combined = quant_ratio * result.remaining_memory
    print(f"F-Q AUC {quant_auc:.4f} at {quant_ratio:.1%} precision-memory")
    print(f"== combined (Table 4): {combined:.1%} of baseline embedding "
          f"bytes, AUC {quant_auc:.4f} vs base {base_auc:.4f} ==")
    return {"base_auc": base_auc, "pruned_auc": result.final_metric,
            "pruned_memory": result.remaining_memory,
            "quant_auc": quant_auc, "quant_ratio": quant_ratio,
            "combined": combined}


if __name__ == "__main__":
    main()
