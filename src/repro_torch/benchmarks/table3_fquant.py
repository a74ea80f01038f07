"""Table 3: F-Quantization against MPE, ALPT and fp32: AUC and memory.

Port of ``benchmarks/table3_fquant.py``; also the uniform fp16-SR /
int8-SR rows the paper discusses in Sec. 4.3 (degenerate tier configs).
"""

from __future__ import annotations

import torch

from repro_torch.benchmarks.common import (eval_auc, make_setup,
                                           train_alpt, train_fp32,
                                           train_fquant, train_mpe)
from repro_torch.core.baselines import mpe as mpe_lib
from repro_torch.core.baselines import uniform
from repro_torch.core.qat_store import FQuantConfig
from repro_torch.core.tiers import (TierConfig, assign_tiers, fp32_bytes,
                                    memory_bytes, plan_thresholds_for_ratio)

_INF = float("inf")


def run(train_steps=800, *, device: str | torch.device | None = None
        ) -> list[dict]:
    setup = make_setup(num_fields=10, important=5,
                       train_steps=train_steps, device=device)
    spec = setup.model.spec
    rows = []

    params = train_fp32(setup)
    rows.append({"method": "fp32", "auc": eval_auc(setup, params),
                 "memory": 1.0})

    # F-Quantization with thresholds planned for ~50% memory (the paper
    # hand-tunes t8/t16 to land at 50%; here they are planned from
    # priorities, the quantized mass split half and half)
    warm_cfg = FQuantConfig(tiers=TierConfig(t8=-_INF, t16=-_INF))
    _, warm_priority = train_fquant(setup, warm_cfg, steps=100)
    planned = plan_thresholds_for_ratio(warm_priority, spec.dim, 0.5)
    fq_cfg = FQuantConfig(tiers=planned)
    params_fq, priority = train_fquant(setup, fq_cfg)
    tiers = assign_tiers(priority, planned)
    mem = memory_bytes(tiers, spec.dim) / fp32_bytes(spec.total_rows,
                                                     spec.dim)
    rows.append({"method": "f_quantization",
                 "auc": eval_auc(setup, params_fq),
                 "memory": round(float(mem), 3)})

    # MPE (fp32 LFU cache + int8 backing): paper reports 55% memory
    params_mpe, _ = train_mpe(setup, capacity_frac=0.18, policy="lfu")
    mem_mpe = mpe_lib.memory_bytes(
        spec.total_rows, spec.dim,
        mpe_lib.MPEConfig(capacity=int(spec.total_rows * 0.18))) \
        / fp32_bytes(spec.total_rows, spec.dim)
    rows.append({"method": "mpe_lfu", "auc": eval_auc(setup, params_mpe),
                 "memory": round(float(mem_mpe), 3)})

    # ALPT: int8 + learned scales
    params_alpt = train_alpt(setup)
    mem_alpt = (spec.total_rows * spec.dim + spec.total_rows * 4) \
        / fp32_bytes(spec.total_rows, spec.dim)
    rows.append({"method": "alpt_int8",
                 "auc": eval_auc(setup, params_alpt),
                 "memory": round(float(mem_alpt), 3)})

    # uniform fp16-SR / int8-SR
    params_h, _ = train_fquant(setup, uniform.all_half_config())
    rows.append({"method": "uniform_fp16_sr",
                 "auc": eval_auc(setup, params_h), "memory": 0.5})
    params_8, _ = train_fquant(setup, uniform.all_int8_config())
    rows.append({"method": "uniform_int8_sr",
                 "auc": eval_auc(setup, params_8), "memory": 0.25})
    return rows


if __name__ == "__main__":
    for r in run():
        print(r)
