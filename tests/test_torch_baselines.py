"""The port's baselines, permutation scores, stochastic rounding and tree
row-wise adagrad against the JAX package.

Each case gives both packages the same numpy inputs; where the reference
draws with ``jax.random``, the port is fed those draws through its draw
source.  Tolerances are stated per case.  Stochastic codes must be equal
except where a uniform lies within 1e-6 of the rounded value's fraction
(a last-bit difference in the value can flip such a comparison); those
cases are counted and reported.  The reference's jitted steps scale
int8 by fp32(1/127) (``reciprocal=True``), its eager calls divide.  The
reference's own baseline tests (``tests/test_baselines.py``) and its
F-Permutation against Permutation check (``test_taylor_fperm.py``) run
here as port cases.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro.core import permutation as jperm
from repro.core import qat_store as jqs
from repro.core import rowwise_quant as jrq
from repro.core.baselines import alpt as jalpt
from repro.core.baselines import gumbel as jgumbel
from repro.core.baselines import lasso as jlasso
from repro.core.baselines import mpe as jmpe
from repro.core.baselines import uniform as juniform
from repro.core.priority import PriorityConfig as JPriorityConfig
from repro.core.tiers import TierConfig as JTierConfig
from repro.data.criteo import CriteoConfig as JCriteoConfig
from repro.data.criteo import CriteoSynth as JCriteoSynth
from repro.models import recsys as JR
from repro.optim import rowwise_adagrad as j_rowwise_adagrad

from repro_torch.benchmarks.common import grad as tgrad
from repro_torch.convert import (alpt_state_from_jax, mpe_state_from_jax,
                                 params_from_jax)
from repro_torch.core import permutation as tperm
from repro_torch.core import qat_store as tqs
from repro_torch.core import rowwise_quant as trq
from repro_torch.core import taylor as ttaylor
from repro_torch.core.baselines import alpt as talpt
from repro_torch.core.baselines import gumbel as tgumbel
from repro_torch.core.baselines import lasso as tlasso
from repro_torch.core.baselines import mpe as tmpe
from repro_torch.core.baselines import uniform as tuniform
from repro_torch.core.priority import PriorityConfig
from repro_torch.core.pruning import rank_correlation
from repro_torch.core.tiers import Tier, TierConfig, assign_tiers
from repro_torch.data.criteo import CriteoConfig, CriteoSynth
from repro_torch.models import recsys as TR
from repro_torch.optim import apply_updates, rowwise_adagrad


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _uniform(key, shape) -> np.ndarray:
    return np.asarray(jax.random.uniform(key, shape, jnp.float32))


def _feed(draws):
    """A draw source that hands out ``draws`` (numpy) in order."""
    it = iter(draws)

    def draw(shape):
        u = next(it)
        assert tuple(u.shape) == tuple(shape), (u.shape, shape)
        return _t(u)
    return draw


def _frac(x: np.ndarray) -> np.ndarray:
    return x - np.floor(x)


def _boundary_diffs(a, b, u, frac, tol=1e-6) -> int:
    """Elements where ``a`` and ``b`` differ; each must be a boundary case
    (|u - frac| < tol).  Returns their count."""
    diff = np.asarray(a) != np.asarray(b)
    near = np.abs(np.asarray(u) - np.asarray(frac)) < tol
    assert not (diff & ~near).any(), int((diff & ~near).sum())
    return int(diff.sum())


def _assert_tree_close(a, b, rtol, atol=0.0):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_tree_close(a[k], b[k], rtol, atol)
        return
    np.testing.assert_allclose(_np(b), np.asarray(a), rtol=rtol, atol=atol)


# ------------------------------------------------------------- optimizer

def _bench_params(seed=0):
    ds = JCriteoSynth(JCriteoConfig(num_fields=10, important_fields=5,
                                    num_dense=4, noise=0.3, seed=seed))
    model = JR.make_dlrm(JR.DLRMConfig(
        cardinalities=tuple(int(c) for c in ds.cards), embed_dim=16,
        num_dense=4, bot_mlp=(32, 16), top_mlp=(64, 1)))
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed)))


def test_rowwise_adagrad_matches_reference_on_the_bench_tree():
    """Two updates on the bench DLRM's param tree with the same grads:
    updates and accumulators within rtol 1e-6."""
    params = _bench_params()
    rng = np.random.default_rng(0)
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
        np.float32) * 0.1, params) for _ in range(2)]
    jopt = j_rowwise_adagrad(0.05)
    topt = rowwise_adagrad(0.05)
    jstate = jopt.init(params)
    tparams = params_from_jax(params)
    tstate = topt.init(tparams)
    for g in grads:
        jupd, jstate = jopt.update(g, jstate, params)
        tupd, tstate = topt.update(params_from_jax(g), tstate, tparams)
        _assert_tree_close(jupd, tupd, rtol=1e-6)
        _assert_tree_close(jstate.accum, tstate.accum, rtol=1e-6)
    assert int(tstate.step) == int(jstate.step) == 2
    # rows of the table: one accumulator a row, 1-D params dense
    assert tuple(tstate.accum["embed_table"].shape) == (
        params["embed_table"].shape[0],)
    assert tuple(tstate.accum["net"]["bot"]["l0"]["b"].shape) == (32,)
    new = apply_updates(tparams, tupd)
    assert new["embed_table"].dtype == torch.float32


# ------------------------------------------------------ stochastic rounding

def test_stochastic_round_equals_reference_with_its_draws():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((64, 16)) * 40).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jrq.stochastic_round(jnp.asarray(x), key))
    got = trq.stochastic_round(_t(x), _feed([_uniform(key, x.shape)]))
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("jitted", [True, False], ids=["jit", "eager"])
def test_quantize_rowwise_stochastic_matches_reference(jitted):
    """Codes equal up to the counted |u - frac| < 1e-6 cases and scales
    bit-equal: the jitted reference against ``reciprocal=True``, the eager
    one against the division."""
    rng = np.random.default_rng(2)
    e = (rng.standard_normal((512, 16)) * 0.05).astype(np.float32)
    e[3] = 0.0
    key = jax.random.PRNGKey(5)
    fn = jax.jit(lambda e, k: jrq.quantize_rowwise(e, 8, key=k)) \
        if jitted else (lambda e, k: jrq.quantize_rowwise(e, 8, key=k))
    jq, js = (np.asarray(a) for a in fn(jnp.asarray(e), key))
    u = _uniform(key, e.shape)
    tq, ts = trq.quantize_rowwise(_t(e), 8, draw=_feed([u]),
                                  reciprocal=jitted)
    np.testing.assert_array_equal(_np(ts), js)
    n = _boundary_diffs(_np(tq), jq, u, _frac(e / _np(ts)))
    assert n <= 2, n
    fq = trq.fake_quant_rowwise(_t(e), 8, draw=_feed([u]),
                                reciprocal=jitted)
    np.testing.assert_array_equal(
        _np(fq) == jq.astype(np.float32) * js, _np(tq) == jq)


def test_stochastic_round_from_a_generator_is_unbiased():
    x = torch.full((200_000,), 2.3)
    gen = torch.Generator().manual_seed(0)
    r = trq.stochastic_round(x, gen)
    assert set(r.unique().tolist()) == {2.0, 3.0}
    assert abs(float(r.mean()) - 2.3) < 5e-3


def test_qat_post_step_stochastic_matches_reference():
    """The whole-table snap fed the reference's (V, D) draw: priorities
    equal, tables equal up to the counted boundary cases; without a draw
    it rounds to nearest."""
    rng = np.random.default_rng(4)
    v, d = 1024, 16
    table = (rng.standard_normal((v, d)) * 0.05).astype(np.float32)
    pri = rng.exponential(1.0, v).astype(np.float32)
    idx = rng.integers(0, v, (64, 4)).astype(np.int32)
    labels = rng.integers(0, 2, 64).astype(np.float32)
    jcfg = jqs.FQuantConfig(tiers=JTierConfig(t8=0.5, t16=1.5),
                            priority=JPriorityConfig())
    tcfg = tqs.FQuantConfig(tiers=TierConfig(t8=0.5, t16=1.5),
                            priority=PriorityConfig())
    key = jax.random.PRNGKey(9)
    step = jax.jit(lambda s, i, lab, k: jqs.post_step(s, i, lab, jcfg,
                                                      key=k))
    jout = step(jqs.QATStore(jnp.asarray(table), jnp.asarray(pri)),
                jnp.asarray(idx), jnp.asarray(labels), key)
    u = _uniform(key, (v, d))
    tout = tqs.post_step(tqs.QATStore(_t(table), _t(pri)), _t(idx),
                         _t(labels), tcfg, draw=_feed([u]))
    np.testing.assert_array_equal(_np(tout.priority),
                                  np.asarray(jout.priority))
    scale = _np(trq.rowwise_scale(_t(table), reciprocal=True))
    n = _boundary_diffs(_np(tout.table), np.asarray(jout.table), u,
                        _frac(table / scale))
    assert n <= 2, n
    tiers = _np(assign_tiers(tout.priority, tcfg.tiers))
    assert (tiers == Tier.INT8.value).any() and (tiers == Tier.FP32.value).any()
    rtn = tqs.post_step(tqs.QATStore(_t(table), _t(pri)), _t(idx),
                        _t(labels), tcfg)
    np.testing.assert_array_equal(
        _np(rtn.table), _np(tqs.snap(_t(table), assign_tiers(
            rtn.priority, tcfg.tiers), tcfg, reciprocal=True)))


# ------------------------------------------------------------ permutation

def _small_dlrm(seed=4, steps=0):
    """The reference test's small DLRM (8 fields, dim 8) in both packages,
    the reference's initial params carried across."""
    jds = JCriteoSynth(JCriteoConfig(num_fields=8, important_fields=4,
                                     num_dense=4, noise=0.2, seed=seed))
    kw = dict(embed_dim=8, num_dense=4, bot_mlp=(16, 8), top_mlp=(32, 1))
    jmodel = JR.make_dlrm(JR.DLRMConfig(
        cardinalities=tuple(int(c) for c in jds.cards), **kw))
    tds = CriteoSynth(CriteoConfig(num_fields=8, important_fields=4,
                                   num_dense=4, noise=0.2, seed=seed))
    tmodel = TR.make_dlrm(TR.DLRMConfig(
        cardinalities=tuple(int(c) for c in tds.cards), **kw))
    jparams = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    return jds, jmodel, jparams, tds, tmodel, params_from_jax(jparams)


def _batches(ds, n, start, size):
    return [ds.batch(size, start + i) for i in range(n)]


def test_permuted_loss_matches_reference():
    jds, jmodel, jparams, _, tmodel, tparams = _small_dlrm()
    (b,) = _batches(jds, 1, 2000, 256)
    perm = np.random.default_rng(0).permutation(256)
    for field in (0, 5):
        want = jperm._permuted_loss(
            jparams, {k: jnp.asarray(v) for k, v in b.items()},
            jnp.asarray(perm), field, jmodel.embed, jmodel.loss_from_emb)
        got = tperm._permuted_loss(
            tparams, {k: _t(v) for k, v in b.items()}, _t(perm), field,
            tmodel.embed, tmodel.loss_from_emb)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_permutation_scores_match_reference_with_its_perms():
    """Fed the reference's ``fold_in`` permutations: scores within atol
    1e-5, base loss within rtol 1e-5."""
    jds, jmodel, jparams, _, tmodel, tparams = _small_dlrm()
    raw = _batches(jds, 2, 2000, 256)
    key = jax.random.PRNGKey(7)
    jscores, jbase = jperm.permutation_scores(
        jmodel.embed, jmodel.loss_from_emb, jparams,
        [{k: jnp.asarray(v) for k, v in b.items()} for b in raw], 8,
        num_shuffles=2, key=key)

    def perms(bi, f, t):
        k = jax.random.fold_in(jax.random.fold_in(
            jax.random.fold_in(key, bi), f), t)
        return _t(np.asarray(jax.random.permutation(k, 256)))
    tscores, tbase = tperm.permutation_scores(
        tmodel.embed, tmodel.loss_from_emb, tparams,
        [{k: _t(v) for k, v in b.items()} for b in raw], 8,
        num_shuffles=2, perms=perms)
    np.testing.assert_allclose(_np(tscores), np.asarray(jscores), atol=1e-5)
    np.testing.assert_allclose(float(tbase), float(jbase), rtol=1e-5)


def test_fperm_agrees_with_true_permutation():
    """The port's O(|DATA|) Taylor scores correlate with its O(N T)
    shuffle test (the reference's ``test_taylor_fperm`` case)."""
    _, _, _, ds, model, params = _small_dlrm()
    opt = rowwise_adagrad(0.1)
    state = opt.init(params)
    for i in range(60):
        b = {k: _t(v) for k, v in ds.batch(256, i).items()}
        g = tgrad(lambda p, b=b: model.loss_from_emb(
            p, model.embed(p, b), b).mean(), params)
        upd, state = opt.update(g, state, params)
        params = apply_updates(params, upd)
    batches = [{k: _t(v) for k, v in b.items()}
               for b in _batches(ds, 4, 2000, 512)]
    t_scores, _, _ = ttaylor.fperm_scores(model.embed, model.loss_from_emb,
                                          params, batches, order=1)
    p_scores, _ = tperm.permutation_scores(
        model.embed, model.loss_from_emb, params, batches, num_fields=8,
        num_shuffles=4, generator=torch.Generator().manual_seed(7))
    rho = rank_correlation(np.argsort(_np(t_scores)),
                           np.argsort(_np(p_scores)))
    assert rho > 0.5, (t_scores, p_scores)


# ----------------------------------------------------------------- lasso

def test_lasso_matches_reference():
    rng = np.random.default_rng(5)
    gates = rng.standard_normal((6, 8)).astype(np.float32)
    gr = rng.standard_normal((6, 8)).astype(np.float32)
    emb = rng.standard_normal((4, 6, 8)).astype(np.float32)
    jcfg, tcfg = jlasso.LassoConfig(lam=2.0, lr=0.1), \
        tlasso.LassoConfig(lam=2.0, lr=0.1)
    for want, got in (
            (jlasso.proximal_step(gates, gr, jcfg),
             tlasso.proximal_step(_t(gates), _t(gr), tcfg)),
            (jlasso.field_scores(gates), tlasso.field_scores(_t(gates))),
            (jlasso.apply_gates(emb, gates),
             tlasso.apply_gates(_t(emb), _t(gates)))):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)
    np.testing.assert_array_equal(_np(tlasso.init_gates(6, 8)),
                                  np.asarray(jlasso.init_gates(6, 8)))
    # ties: equal norms keep the lower fields, as the stable argsort
    tied = np.ones((6, 8), np.float32)
    tied[4] = 2.0
    for keep in (1, 3, 5):
        np.testing.assert_array_equal(
            _np(tlasso.select_fields(_t(tied), keep)),
            np.asarray(jlasso.select_fields(tied, keep)))
        np.testing.assert_array_equal(
            _np(tlasso.select_fields(_t(gates), keep)),
            np.asarray(jlasso.select_fields(gates, keep)))


def test_lasso_prox_shrinks_and_selects():
    cfg = tlasso.LassoConfig(lam=2.0, lr=0.1)
    gates = tlasso.init_gates(4, 8)
    for _ in range(40):
        g = torch.zeros((4, 8))
        g[0] = -1.0                                  # pushes field 0 up
        gates = tlasso.proximal_step(gates, g, cfg)
    scores = tlasso.field_scores(gates)
    assert float(scores[0]) > float(scores[1:].max())
    mask = tlasso.select_fields(gates, keep=1)
    assert bool(mask[0]) and int(mask.sum()) == 1


# ---------------------------------------------------------------- gumbel

def test_gumbel_matches_reference_with_its_uniforms():
    cfg = jgumbel.GumbelConfig(anneal_steps=150)
    tcfg = tgumbel.GumbelConfig(anneal_steps=150)
    logits = np.array([2.0, -1.0, 0.3, 4.0, -3.0], np.float32)
    for step in (0, 37, 149, 10_000):
        np.testing.assert_allclose(
            _np(tgumbel.temperature(step, tcfg)),
            np.asarray(jgumbel.temperature(jnp.asarray(step), cfg)),
            rtol=1e-6)
    key = jax.random.PRNGKey(11)
    u = np.asarray(jax.random.uniform(key, (5,), minval=1e-6,
                                      maxval=1 - 1e-6))
    tau = np.float32(0.37)
    want = jgumbel.sample_mask(jnp.asarray(logits), key, jnp.asarray(tau))
    got = tgumbel.sample_mask(_t(logits), _feed([u]), torch.tensor(tau))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(_np(tgumbel.field_scores(_t(logits))),
                               np.asarray(jgumbel.field_scores(logits)),
                               rtol=1e-6)
    np.testing.assert_allclose(
        float(tgumbel.sparsity_loss(_t(logits), 0.6)),
        float(jgumbel.sparsity_loss(jnp.asarray(logits), 0.6)), rtol=1e-6)
    emb = np.random.default_rng(0).standard_normal((3, 5, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(
        _np(tgumbel.apply_mask(_t(emb), got)),
        np.asarray(jgumbel.apply_mask(emb, np.asarray(_np(got)))))
    np.testing.assert_array_equal(_np(tgumbel.init_logits(5, tcfg)),
                                  np.asarray(jgumbel.init_logits(5, cfg)))


def test_gumbel_mask_in_range_and_anneals():
    cfg = tgumbel.GumbelConfig()
    logits = tgumbel.init_logits(5, cfg)
    m = tgumbel.sample_mask(logits, torch.Generator().manual_seed(0),
                            tgumbel.temperature(0, cfg))
    assert bool(((m > 0) & (m < 1)).all())
    t0 = float(tgumbel.temperature(0, cfg))
    t1 = float(tgumbel.temperature(10 ** 6, cfg))
    assert t1 < t0
    mb = tgumbel.sample_mask(logits, torch.Generator().manual_seed(1),
                             torch.tensor(0.01))
    assert bool(((mb < 0.05) | (mb > 0.95)).all())


# ------------------------------------------------------------------- mpe

@pytest.mark.parametrize("policy", ["lfu", "lru"])
def test_mpe_post_step_matches_reference(policy):
    """Four jitted steps (a refresh every second) fed the reference's
    draws: in_cache and priority equal, tables equal up to the counted
    boundary cases."""
    v, d = 2048, 16
    jcfg = jmpe.MPEConfig(capacity=300, policy=policy, refresh_every=2)
    tcfg = tmpe.MPEConfig(capacity=300, policy=policy, refresh_every=2)
    jstate = jmpe.init(jax.random.PRNGKey(0), v, d, jcfg)
    tstate = mpe_state_from_jax(jax.tree.map(np.asarray, jstate))
    step = jax.jit(jmpe.post_step, static_argnums=2)
    rng = np.random.default_rng(6)
    key = jax.random.PRNGKey(1)
    n = 0
    for i in range(4):
        idx = (rng.zipf(1.3, 512) % v).astype(np.int32)
        key, sub = jax.random.split(key)
        u = _uniform(sub, (v, d))
        table = _np(tstate.table)
        jstate = step(jstate, jnp.asarray(idx), jcfg, sub)
        tstate = tmpe.post_step(tstate, _t(idx), tcfg, draw=_feed([u]))
        np.testing.assert_array_equal(_np(tstate.in_cache),
                                      np.asarray(jstate.in_cache))
        np.testing.assert_array_equal(_np(tstate.priority),
                                      np.asarray(jstate.priority))
        assert tstate.step == int(jstate.step) == i + 1
        scale = _np(trq.rowwise_scale(_t(table), reciprocal=True))
        n += _boundary_diffs(_np(tstate.table), np.asarray(jstate.table),
                             u, _frac(table / scale))
        tstate = tstate._replace(table=_t(np.asarray(jstate.table)))
    assert n <= 4, n
    assert int(tstate.in_cache.sum()) >= 300


def test_mpe_lfu_cache_tracks_hot_rows():
    cfg = tmpe.MPEConfig(capacity=4, policy="lfu")
    state = tmpe.init(torch.Generator().manual_seed(0), 32, 8, cfg)
    hot = torch.tensor([1, 2, 3, 30])
    for _ in range(5):
        state = tmpe.post_step(state, hot, cfg)
    assert bool(state.in_cache[hot].all())
    assert float((tmpe.lookup(state, hot) - state.table[hot]).abs().max()) \
        == 0.0


def test_mpe_lru_evicts_stale():
    cfg = tmpe.MPEConfig(capacity=2, policy="lru")
    state = tmpe.init(torch.Generator().manual_seed(0), 16, 4, cfg)
    for row in (5, 6, 7):
        state = tmpe.post_step(state, torch.tensor([row]), cfg)
    assert bool(state.in_cache[6] & state.in_cache[7])
    assert not bool(state.in_cache[5])


def test_mpe_memory_between_int8_and_fp32():
    cfg = tmpe.MPEConfig(capacity=100, policy="lfu")
    m = tmpe.memory_bytes(1000, 64, cfg)
    assert 1000 * 64 * 1 < m < 1000 * 64 * 4
    assert m == jmpe.memory_bytes(1000, 64, jmpe.MPEConfig(capacity=100))


# ------------------------------------------------------------------ alpt

def test_alpt_ste_quant_matches_reference():
    """Forward and both STE gradients within rtol 1e-6 (codes clipped
    on some rows)."""
    rng = np.random.default_rng(7)
    e = (rng.standard_normal((32, 16)) * 0.05).astype(np.float32)
    s = rng.uniform(1e-4, 2e-3, (32, 1)).astype(np.float32)
    w = rng.standard_normal((32, 16)).astype(np.float32)

    def jf(e, s):
        return (jalpt.ste_quant(e, s) * w).sum()
    jv = jalpt.ste_quant(jnp.asarray(e), jnp.asarray(s))
    jge, jgs = jax.grad(jf, argnums=(0, 1))(jnp.asarray(e), jnp.asarray(s))
    te, ts = _t(e).requires_grad_(), _t(s).requires_grad_()
    tv = talpt.ste_quant(te, ts)
    (tv * _t(w)).sum().backward()
    np.testing.assert_allclose(_np(tv), np.asarray(jv), rtol=1e-6)
    np.testing.assert_allclose(_np(te.grad), np.asarray(jge), rtol=1e-6)
    np.testing.assert_allclose(_np(ts.grad), np.asarray(jgs), rtol=1e-6,
                               atol=1e-6)
    assert (np.abs(e / s) > 127).any()


def test_alpt_apply_grads_matches_reference_with_its_draws():
    """Three jitted steps fed the reference's two draws a step (kq, kr):
    scales within rtol 1e-5, codes equal up to counted boundary cases."""
    v, d = 1024, 16
    cfg = jalpt.ALPTConfig(scale_lr=1e-4, init_scale=1e-2)
    tcfg = talpt.ALPTConfig(scale_lr=1e-4, init_scale=1e-2)
    jstate = jalpt.init(jax.random.PRNGKey(2), v, d, cfg)
    tstate = alpt_state_from_jax(jax.tree.map(np.asarray, jstate))
    np.testing.assert_array_equal(_np(talpt.dequant(tstate)),
                                  np.asarray(jalpt.dequant(jstate)))
    step = jax.jit(jalpt.apply_grads, static_argnums=(3, 4))
    rng = np.random.default_rng(8)
    key = jax.random.PRNGKey(3)
    n = 0
    for _ in range(3):
        idx = (rng.zipf(1.3, 700) % v).astype(np.int32)[None]
        g = (rng.standard_normal((1, 700, d)) * 0.01).astype(np.float32)
        key, sub = jax.random.split(key)
        kq, kr = jax.random.split(sub)
        draws = [_uniform(kq, (v, d)), _uniform(kr, (v, d))]
        jstate = step(jstate, jnp.asarray(g), jnp.asarray(idx), 0.05, cfg,
                      sub)
        tout = talpt.apply_grads(tstate, _t(g), _t(idx), 0.05, tcfg,
                                 _feed(draws))
        np.testing.assert_allclose(_np(tout.scale), np.asarray(jstate.scale),
                                   rtol=1e-5)
        new_e = _np(talpt.dequant(tstate))
        np.add.at(new_e, idx.reshape(-1), -0.05 * g.reshape(-1, d))
        n += _boundary_diffs(_np(tout.q), np.asarray(jstate.q), draws[1],
                             _frac(new_e / np.asarray(jstate.scale)))
        tstate = alpt_state_from_jax(jax.tree.map(np.asarray, jstate))
    assert n <= 4, n
    assert talpt.memory_bytes(v, d, tcfg) == jalpt.memory_bytes(v, d, cfg)


def test_alpt_ste_gradients_flow():
    e = (torch.ones((4, 8)) * 0.05).requires_grad_()
    s = torch.full((4, 1), 0.01).requires_grad_()
    talpt.ste_quant(e, s).sum().backward()
    assert bool(torch.isfinite(e.grad).all() & torch.isfinite(s.grad).all())
    np.testing.assert_allclose(_np(e.grad), 1.0)


def test_alpt_training_reduces_quant_error():
    """Learned scales adapt to the weight distribution."""
    cfg = talpt.ALPTConfig(scale_lr=1e-3, init_scale=0.05)
    gen = torch.Generator().manual_seed(0)
    state = talpt.init(gen, 64, 16, cfg, init_std=0.001)   # scale way off
    target = torch.randn((64, 16), generator=gen) * 0.001
    for _ in range(100):
        grad_rows = (talpt.dequant(state) - target)[None]  # pull to target
        state = talpt.apply_grads(state, grad_rows, torch.arange(64)[None],
                                  lr=0.5, cfg=cfg, draw=gen)
    err = float((talpt.dequant(state) - target).abs().mean())
    assert err < 2.5e-3
    assert float(state.scale.mean()) < 0.05


# --------------------------------------------------------------- uniform

def test_uniform_configs_cover_tiers_as_the_reference():
    w = torch.tensor([0.0, 1e4, 1e9])
    for name, want in (("int8", Tier.INT8), ("half", Tier.HALF),
                       ("fp32", Tier.FP32)):
        tcfg = getattr(tuniform, f"all_{name}_config")()
        jcfg = getattr(juniform, f"all_{name}_config")()
        assert isinstance(tcfg, tqs.FQuantConfig)
        assert (_np(assign_tiers(w, tcfg.tiers)) == want.value).all()
        assert (float(tcfg.tiers.t8), float(tcfg.tiers.t16)) == (
            float(jcfg.tiers.t8), float(jcfg.tiers.t16))
        assert tuniform.memory_fraction(name) == \
            juniform.memory_fraction(name)
    assert tuniform.all_int8_config(stochastic=False).stochastic is False
