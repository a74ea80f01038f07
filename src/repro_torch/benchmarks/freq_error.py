"""The paper's motivating observation (Sec. 1, also [32]): frequently
accessed rows carry more quantization error.

Port of ``benchmarks/freq_error.py``.  A DLRM trains with every row at
fp32 (the Eq. 7 priorities tracked), then rows are bucketed by priority
and the mean |snap(x) - x| of an int8 round-to-nearest snap reported a
bucket: the phenomenon that justifies spending precision on hot rows.
Mechanism: hot rows receive many updates and drift to larger magnitudes
(wider rows -> a coarser int8 grid).  The reference snaps eagerly, so
its int8 scale is the division (``reciprocal=False``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.benchmarks.common import make_setup, train_fquant
from repro_torch.core.baselines import uniform
from repro_torch.core.rowwise_quant import fake_quant_rowwise


def run(train_steps=400, *, device: str | torch.device | None = None
        ) -> list[dict]:
    setup = make_setup(num_fields=8, important=4, train_steps=train_steps,
                       device=device)
    params, priority = train_fquant(setup, uniform.all_fp32_config())
    table = params["embed_table"]
    pri = priority.cpu().numpy()

    snapped = fake_quant_rowwise(table, 8)
    err = (snapped - table).abs().mean(dim=-1).cpu().numpy()
    abs_table = table.abs().cpu().numpy()

    touched = pri > 0
    rows = []
    if touched.sum() > 100:
        qs_ = np.quantile(pri[touched], [0.5, 0.9, 0.99])
        buckets = [
            ("cold (never touched)", ~touched),
            ("warm (<p50)", touched & (pri <= qs_[0])),
            ("hot (p50-p90)", touched & (pri > qs_[0]) & (pri <= qs_[1])),
            ("very hot (p90-p99)", touched & (pri > qs_[1])
             & (pri <= qs_[2])),
            ("hottest (>p99)", touched & (pri > qs_[2])),
        ]
        for name, m in buckets:
            if m.sum():
                rows.append({"bucket": name, "rows": int(m.sum()),
                             "mean_int8_err": float(err[m].mean()),
                             "mean_abs_weight": float(abs_table[m].mean())})
    return rows


if __name__ == "__main__":
    for r in run():
        print(r)
