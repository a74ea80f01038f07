"""Fig. 2: AUC against the number of remaining fields, per selection
method.

Port of ``benchmarks/fig2_fperm.py``.  Methods: F-Permutation
(first-order Taylor), the original Permutation, group LASSO, Gumbel
(FSCD / AutoField style) and random pruning; each ranks the fields, then
the model is pruned to k fields (mask + finetune) and its AUC taken.
Rankings come from ``np.argsort`` of a CPU copy of the scores, least
important first, as in the reference.  The stochastic rankers draw from
generators on the device seeded 0, as the reference's ``PRNGKey(0)``;
``rank_random`` is numpy's, identical to the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.benchmarks.common import (BenchSetup, device_batch,
                                           eval_auc, field_mask_tensor,
                                           generator, grad, make_setup,
                                           train_fp32)
from repro_torch.core import permutation, taylor
from repro_torch.core.baselines import gumbel as gumbel_lib
from repro_torch.core.baselines import lasso as lasso_lib
from repro_torch.core.rowwise_quant import Draw


def _eval_batches(setup: BenchSetup, n=6, start=3000):
    return [device_batch(setup.ds.batch(512, start + i), setup.device)
            for i in range(n)]


def _order(scores: torch.Tensor) -> np.ndarray:
    return np.argsort(scores.detach().cpu().numpy())


def rank_fperm(setup, params):
    scores, _, _ = taylor.fperm_scores(
        lambda p, b: setup.model.embed(p, b), setup.model.loss_from_emb,
        params, _eval_batches(setup), order=1)
    return _order(scores)                       # least important first


def rank_permutation(setup, params, shuffles=3):
    scores, _ = permutation.permutation_scores(
        lambda p, b: setup.model.embed(p, b), setup.model.loss_from_emb,
        params, _eval_batches(setup, n=2), setup.model.spec.num_fields,
        num_shuffles=shuffles, generator=generator(setup.device, 0))
    return _order(scores)


def rank_lasso(setup, params, steps=150):
    """Train per-field gates with proximal SGD on top of the base model."""
    model = setup.model
    gates = lasso_lib.init_gates(model.spec.num_fields, model.spec.dim,
                                 setup.device)
    cfg = lasso_lib.LassoConfig(lam=3e-2, lr=0.05)
    for i in range(steps):
        b = device_batch(setup.ds.batch(setup.batch_size, i), setup.device)

        def loss(g, b=b):
            emb = lasso_lib.apply_gates(model.embed(params, b), g["gates"])
            return model.loss_from_emb(params, emb, b).mean()
        g = grad(loss, {"gates": gates})["gates"]
        gates = lasso_lib.proximal_step(gates, g, cfg)
    return _order(lasso_lib.field_scores(gates))


def rank_gumbel(setup, params, steps=150, *, draw: Draw | None = None):
    """``draw``: the masks' uniform source (see ``gumbel.sample_mask``);
    by default a generator on the device seeded 0."""
    model = setup.model
    cfg = gumbel_lib.GumbelConfig(anneal_steps=steps, lr=0.05)
    logits = gumbel_lib.init_logits(model.spec.num_fields, cfg, setup.device)
    if draw is None:
        draw = generator(setup.device, 0)
    for i in range(steps):
        b = device_batch(setup.ds.batch(setup.batch_size, i), setup.device)
        # computed on the host, filled on the device: no copy, no sync
        tau = torch.full((), float(gumbel_lib.temperature(i, cfg)),
                         dtype=torch.float32, device=setup.device)

        def loss(lg, b=b, tau=tau):
            m = gumbel_lib.sample_mask(lg["logits"], draw, tau)
            emb = gumbel_lib.apply_mask(model.embed(params, b), m)
            task = model.loss_from_emb(params, emb, b).mean()
            return task + 0.5 * gumbel_lib.sparsity_loss(lg["logits"], 0.6)
        g = grad(loss, {"logits": logits})["logits"]
        logits = logits - cfg.lr * g
    return _order(gumbel_lib.field_scores(logits))


def rank_random(setup, params, seed=123):
    return np.random.default_rng(seed).permutation(
        setup.model.spec.num_fields)


METHODS = {
    "f_permutation": rank_fperm,
    "permutation": rank_permutation,
    "lasso": rank_lasso,
    "gumbel": rank_gumbel,
    "random": rank_random,
}


def run(train_steps=800, keep_counts=(8, 6, 4), finetune_steps=150, *,
        device: str | torch.device | None = None) -> list[dict]:
    setup = make_setup(num_fields=10, important=5,
                       train_steps=train_steps, device=device)
    params = train_fp32(setup)
    base_auc = eval_auc(setup, params)
    rows = [{"method": "baseline", "fields": 10, "auc": base_auc}]

    for name, ranker in METHODS.items():
        order = ranker(setup, params)            # least important first
        for keep in keep_counts:
            mask = np.ones(10, bool)
            mask[order[:10 - keep]] = False
            tmask = field_mask_tensor(mask, setup.device)
            tuned = train_fp32(setup, field_mask=tmask,
                               steps=finetune_steps, params=params, seed=2)
            a = eval_auc(setup, tuned, field_mask=tmask)
            rows.append({"method": name, "fields": keep, "auc": a})
    return rows


if __name__ == "__main__":
    for r in run():
        print(r)
