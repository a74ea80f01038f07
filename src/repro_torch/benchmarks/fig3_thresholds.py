"""Fig. 3: F-Quantization's sensitivity to t8 / t16.

Port of ``benchmarks/fig3_thresholds.py``.  The paper's protocol: sweep
t16 with t8 = -inf (every non-fp32 row at fp16), and sweep t8 with
t16 = t8 (two tiers: int8 against fp32).  Priorities here are the Eq. 7
steady state of the zipf stream, so thresholds translate to tier
fractions deterministically.
"""

from __future__ import annotations

import torch

from repro_torch.benchmarks.common import eval_auc, make_setup, train_fquant
from repro_torch.core.qat_store import FQuantConfig
from repro_torch.core.tiers import (TierConfig, assign_tiers, fp32_bytes,
                                    memory_bytes)


def run(train_steps=800,
        t16_grid=(1e-2, 1e-1, 1e0, 1e1),
        t8_grid=(1e-2, 1e-1, 1e0, 1e1), *,
        device: str | torch.device | None = None) -> list[dict]:
    setup = make_setup(num_fields=8, important=4, train_steps=train_steps,
                       device=device)
    spec = setup.model.spec
    rows = []
    # priorities in this small setup are O(batch * zipf-rate); the paper's
    # industrial thresholds (1e3/1e5) scale with its 8192 batch
    sweeps = ([("t16", t, TierConfig(t8=-float("inf"), t16=t))
               for t in t16_grid]
              + [("t8", t, TierConfig(t8=t, t16=t)) for t in t8_grid])
    for sweep, t, tiers_cfg in sweeps:
        cfg = FQuantConfig(tiers=tiers_cfg)
        params, pri = train_fquant(setup, cfg)
        tiers = assign_tiers(pri, cfg.tiers)
        mem = memory_bytes(tiers, spec.dim) / fp32_bytes(
            spec.total_rows, spec.dim)
        rows.append({"sweep": sweep, "threshold": t,
                     "auc": eval_auc(setup, params),
                     "memory": round(float(mem), 3)})
    return rows


if __name__ == "__main__":
    for r in run():
        print(r)
