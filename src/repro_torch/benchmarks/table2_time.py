"""Table 2: score-producing cost, F-Permutation against Permutation (and
the training-based methods' cost model).

Port of ``benchmarks/table2_time.py``.  Measured: the wall time of one
full scoring pass over the same eval stream, on ``device`` (default the
GPU), with the device synchronized before each clock read, so each
window ends when its work has.  The reference's windows include XLA's
compile of each pass; here one untimed forward and backward of the bench
model runs first, so that the CUDA context and cuBLAS set-up stay out of
both windows.  The times are unrounded.  Extrapolated: the complexity
model the paper gives: F-P is O(3|DATA|) passes, Permutation
O(|DATA| * N * T); FSCD / LASSO need full retraining (|DATA| * epochs).
"""

from __future__ import annotations

import time

import torch

from repro_torch import sync
from repro_torch.benchmarks.common import (device_batch, generator, grad,
                                           make_setup, train_fp32)
from repro_torch.core import permutation, taylor


def run(num_fields=10, eval_batches=4, shuffles=2, *,
        device: str | torch.device | None = None) -> list[dict]:
    setup = make_setup(num_fields=num_fields, important=5,
                       train_steps=120, device=device)
    model = setup.model
    params = train_fp32(setup)
    batches = [device_batch(setup.ds.batch(512, 4000 + i), setup.device)
               for i in range(eval_batches)]

    def embed(p, b):
        return model.embed(p, b)

    # untimed: one forward and backward (context, cuBLAS handles)
    grad(lambda p: model.loss_from_emb(p, embed(p, batches[0]),
                                       batches[0]).mean(), params)
    sync(setup.device)

    # F-Permutation: one moments pass + one fwd/bwd pass
    t0 = time.perf_counter()
    scores_fp, _, _ = taylor.fperm_scores(embed, model.loss_from_emb,
                                          params, batches, order=1)
    sync(setup.device)
    t_fp = time.perf_counter() - t0

    # Permutation: N fields x T shuffles forward passes
    t0 = time.perf_counter()
    scores_perm, _ = permutation.permutation_scores(
        embed, model.loss_from_emb, params, batches, num_fields,
        num_shuffles=shuffles, generator=generator(setup.device, 0))
    sync(setup.device)
    t_perm = time.perf_counter() - t0

    # complexity model at paper scale (industrial: N=180 fields, T=10)
    n_ind, t_ind = 180, 10
    rows = [
        {"method": "f_permutation", "measured_s": t_fp, "passes": 3,
         "paper_scale_passes": 3},
        {"method": "permutation", "measured_s": t_perm,
         "passes": num_fields * shuffles + 1,
         "paper_scale_passes": n_ind * t_ind + 1},
        {"method": "fscd/lasso (training-based)", "measured_s": None,
         "passes": None,
         "paper_scale_passes": "full retrain (days, Table 2)"},
    ]
    rows.append({"method": "speedup f_p vs permutation (measured)",
                 "measured_s": t_perm / max(t_fp, 1e-9),
                 "passes": None, "paper_scale_passes":
                 round((n_ind * t_ind + 1) / 3, 1)})
    return rows


if __name__ == "__main__":
    for r in run():
        print(r)
