"""Parity of the port's F-Permutation scores and Algorithm 1 with the JAX
package, on the CPU.

The same smoke dlrm-rm2 weights (``convert.params_from_jax``) and the
same ``CriteoSynth`` batches go through ``repro.core.taylor`` /
``repro.core.pruning`` and their ports.  Tolerances: first-order scores
and losses within 1e-5 (autodiff and reductions sum in other orders);
second-order scores, fed the reference's own Rademacher probes, within
1e-4 of the largest |score| (a double-backward Hessian-vector product
against JAX's forward-over-reverse one); ``memory_fraction``,
``rank_correlation``, the prune mask and the ranking exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro import configs as jconfigs
from repro.core import pruning as jpruning
from repro.core import taylor as jtaylor
from repro.core.metrics import auc as jauc
from repro.data.criteo import CriteoConfig, CriteoSynth
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.core import pruning as tpruning
from repro_torch.core import taylor as ttaylor
from repro_torch.core.metrics import auc as tauc


@pytest.fixture(scope="module")
def smoke():
    jm = jconfigs.get("dlrm-rm2").smoke_model
    tm = tconfigs.get("dlrm-rm2").smoke_model
    jparams = jm.init(jax.random.PRNGKey(0))
    ds = CriteoSynth(CriteoConfig(
        num_fields=jm.spec.num_fields,
        cardinalities=tuple(int(c) for c in jm.spec.cardinalities),
        num_dense=5, important_fields=4, seed=3))
    nb = [ds.batch(64, 100 + i) for i in range(3)]
    return {"jm": jm, "tm": tm, "jparams": jparams,
            "tparams": params_from_jax(jax.device_get(jparams)),
            "jb": [{k: jnp.asarray(v) for k, v in b.items()} for b in nb],
            "tb": [{k: torch.from_numpy(v) for k, v in b.items()}
                   for b in nb]}


def test_field_moments_match_jax(smoke):
    jmom = jtaylor.field_moments(smoke["jm"].embed, smoke["jparams"],
                                 smoke["jb"])
    tmom = ttaylor.field_moments(smoke["tm"].embed, smoke["tparams"],
                                 smoke["tb"])
    for name in ("mean", "sq_mean", "count"):
        np.testing.assert_allclose(getattr(tmom, name).numpy(),
                                   np.asarray(getattr(jmom, name)),
                                   rtol=1e-6, atol=1e-7)


def test_fperm_scores_order1_match_jax(smoke):
    js, jl, _ = jtaylor.fperm_scores(smoke["jm"].embed,
                                     smoke["jm"].loss_from_emb,
                                     smoke["jparams"], smoke["jb"])
    ts, tl, _ = ttaylor.fperm_scores(smoke["tm"].embed,
                                     smoke["tm"].loss_from_emb,
                                     smoke["tparams"], smoke["tb"])
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=1e-5)
    assert abs(float(tl) - float(jl)) <= 1e-5
    assert list(np.argsort(ts.numpy())) == list(np.argsort(np.asarray(js)))


def test_fperm_scores_order2_match_jax_with_its_probes(smoke):
    key = jax.random.PRNGKey(0)

    def probes(p, shape):
        return torch.from_numpy(np.array(jax.random.rademacher(
            jax.random.fold_in(key, p), shape, jnp.float32)))

    js, jl, _ = jtaylor.fperm_scores(smoke["jm"].embed,
                                     smoke["jm"].loss_from_emb,
                                     smoke["jparams"], smoke["jb"], order=2,
                                     key=key)
    ts, tl, _ = ttaylor.fperm_scores(smoke["tm"].embed,
                                     smoke["tm"].loss_from_emb,
                                     smoke["tparams"], smoke["tb"], order=2,
                                     rademacher=probes)
    scale = float(np.abs(np.asarray(js)).max())
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=1e-4 * scale)
    assert abs(float(tl) - float(jl)) <= 1e-5
    # the generator's own probes: finite, and first-order-close
    tg, _, _ = ttaylor.fperm_scores(
        smoke["tm"].embed, smoke["tm"].loss_from_emb, smoke["tparams"],
        smoke["tb"], order=2, generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(tg).all() and tg.shape == ts.shape


def test_memory_fraction_and_rank_correlation_exact():
    rng = np.random.default_rng(0)
    for _ in range(5):
        tb = rng.integers(1, 1000, 9).tolist()
        mask = rng.random(9) < 0.6
        assert tpruning.memory_fraction(mask, tb) == \
            jpruning.memory_fraction(mask, tb)
        a, b = rng.permutation(9), rng.permutation(9)
        assert tpruning.rank_correlation(a, b) == \
            jpruning.rank_correlation(a, b)
    assert tpruning.memory_fraction(np.array([True, False, True]),
                                    [100, 300, 100]) == 0.4
    assert tpruning.rank_correlation([0, 1, 2], [2, 1, 0]) == -1.0


def test_table_bytes_match_jax():
    jspec = jconfigs.get("dlrm-rm2").smoke_model.spec
    tspec = tconfigs.get("dlrm-rm2").smoke_model.spec
    assert tspec.table_bytes() == jspec.table_bytes()
    assert tspec.table_bytes(2) == jspec.table_bytes(2)


def _prune_setup(smoke, t_accuracy: float):
    jm, tm = smoke["jm"], smoke["tm"]
    lr = 0.5

    def j_eval(p, mask):
        scores = [jm.forward(p, b, jnp.asarray(mask, jnp.float32))
                  for b in smoke["jb"]]
        labels = [b["labels"] for b in smoke["jb"]]
        return float(jauc(jnp.concatenate(scores), jnp.concatenate(labels)))

    def t_eval(p, mask):
        with torch.no_grad():
            scores = [tm.forward(p, b, mask) for b in smoke["tb"]]
        labels = [b["labels"] for b in smoke["tb"]]
        return float(tauc(torch.cat(scores), torch.cat(labels)))

    def j_finetune(p, mask, steps):
        b = smoke["jb"][0]
        m = jnp.asarray(mask, jnp.float32)
        for _ in range(steps):
            g = jax.grad(lambda q: jm.loss_from_emb(
                q, jm.embed(q, b, m), b).mean())(p)
            p = jax.tree_util.tree_map(lambda x, y: x - lr * y, p, g)
        return p

    def t_finetune(p, mask, steps):
        b = smoke["tb"][0]
        for _ in range(steps):
            with torch.enable_grad():
                leaves = {k: v.detach().requires_grad_()
                          for k, v in _flat(p).items()}
                q = _unflat(leaves)
                loss = tm.loss_from_emb(q, tm.embed(q, b, mask), b).mean()
                grads = torch.autograd.grad(loss, list(leaves.values()))
            p = _unflat({k: (v - lr * g).detach() for (k, v), g
                         in zip(leaves.items(), grads)})
        return p

    cfg = jpruning.PruneConfig(rate_c=0.2, t_accuracy=t_accuracy,
                               finetune_steps=2)
    tcfg = tpruning.PruneConfig(rate_c=0.2, t_accuracy=t_accuracy,
                                finetune_steps=2)
    jres = jpruning.prune_loop(
        smoke["jparams"], jm.embed, jm.loss_from_emb, j_eval, j_finetune,
        lambda: smoke["jb"], jm.spec.table_bytes(), cfg)
    tres = tpruning.prune_loop(
        smoke["tparams"], tm.embed, tm.loss_from_emb, t_eval, t_finetune,
        lambda: smoke["tb"], tm.spec.table_bytes(), tcfg)
    return jres, tres


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflat(flat):
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


@pytest.mark.parametrize("t_accuracy", [0.5, 0.9999])
def test_prune_loop_matches_jax(smoke, t_accuracy):
    """Algorithm 1 end to end: the same pruning order, mask and memory,
    metrics within 1e-5; at t_accuracy 0.9999 the guard trips and both
    roll the last victim back."""
    jres, tres = _prune_setup(smoke, t_accuracy)
    print("ranking", jres.ranking(), tres.ranking(), "metrics",
          jres.base_metric, jres.final_metric, tres.final_metric)
    assert list(tres.ranking()) == list(jres.ranking())
    np.testing.assert_array_equal(tres.field_mask, jres.field_mask)
    assert tres.remaining_memory == jres.remaining_memory
    assert abs(tres.base_metric - jres.base_metric) <= 1e-5
    assert abs(tres.final_metric - jres.final_metric) <= 1e-5
    assert len(tres.log) == len(jres.log) >= 1
    for je, te in zip(jres.log, tres.log):
        np.testing.assert_allclose(te.scores, je.scores, rtol=0, atol=1e-5)
