"""Table 4: F-Permutation and F-Quantization combined.

Port of ``benchmarks/table4_combined.py``.  Train fp32 -> F-P prune to
~60% of the embedding bytes -> F-Q quantize the surviving tables to
~50% -> ~30% of the baseline's embedding bytes (the paper's 50% x 60%
composition), each step's AUC beside it.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.benchmarks.common import (eval_auc, field_mask_tensor,
                                           generator, make_setup,
                                           train_fp32, train_fquant,
                                           train_fquant_core)
from repro_torch.benchmarks.fig2_fperm import rank_fperm
from repro_torch.core.qat_store import FQuantConfig
from repro_torch.core.tiers import (assign_tiers, fp32_bytes, memory_bytes,
                                    plan_thresholds_for_ratio)


def run(train_steps=800, keep=6, *,
        device: str | torch.device | None = None) -> list[dict]:
    setup = make_setup(num_fields=10, important=5,
                       train_steps=train_steps, device=device)
    spec = setup.model.spec
    table_bytes = np.asarray(spec.table_bytes(), float)
    rows = []

    params = train_fp32(setup)
    rows.append({"method": "baseline", "auc": eval_auc(setup, params),
                 "memory": 1.0})

    # F-P alone: prune to `keep` fields
    order = rank_fperm(setup, params)
    mask = np.ones(10, bool)
    mask[order[:10 - keep]] = False
    tmask = field_mask_tensor(mask, setup.device)
    params_fp = train_fp32(setup, field_mask=tmask, steps=200,
                           params=params, seed=3)
    mem_fp = table_bytes[mask].sum() / table_bytes.sum()
    rows.append({"method": "f_permutation",
                 "auc": eval_auc(setup, params_fp, field_mask=tmask),
                 "memory": round(float(mem_fp), 3)})

    # F-Q alone at ~50%
    warm = FQuantConfig(tiers=plan_thresholds_for_ratio(
        torch.ones(spec.total_rows, device=setup.device), spec.dim, 1.0))
    _, warm_pri = train_fquant(setup, warm, steps=100)
    fq_cfg = FQuantConfig(tiers=plan_thresholds_for_ratio(warm_pri,
                                                          spec.dim, 0.5))
    params_fq, pri = train_fquant(setup, fq_cfg)
    tiers = assign_tiers(pri, fq_cfg.tiers)
    mem_fq = memory_bytes(tiers, spec.dim) / fp32_bytes(spec.total_rows,
                                                        spec.dim)
    rows.append({"method": "f_quantization",
                 "auc": eval_auc(setup, params_fq),
                 "memory": round(float(mem_fq), 3)})

    # combined: quantized training on the pruned field set
    params_both, pri_b = train_fquant_masked(setup, fq_cfg, tmask)
    tiers_b = assign_tiers(pri_b, fq_cfg.tiers)
    # memory: only surviving fields' rows, at tiered precision
    mem_rows = memory_bytes(tiers_b, spec.dim) / fp32_bytes(
        spec.total_rows, spec.dim)
    mem_comb = float(mem_rows) * float(mem_fp)
    rows.append({"method": "f_p + f_q",
                 "auc": eval_auc(setup, params_both, field_mask=tmask),
                 "memory": round(mem_comb, 3)})
    return rows


def train_fquant_masked(setup, fq_cfg, field_mask, steps=None, seed=4):
    """F-Q training with the F-P field mask applied (its draws seeded
    ``seed + 5``, as the reference's key)."""
    params = setup.model.init(generator(setup.device, seed), setup.device)
    return train_fquant_core(setup, fq_cfg, field_mask, steps, params,
                             generator(setup.device, seed + 5))


if __name__ == "__main__":
    for r in run():
        print(r)
