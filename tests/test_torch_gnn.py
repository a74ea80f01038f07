"""The GNN family (PNA, its graph generators and sampler, the GNN arch
record) beside the reference's, on the CPU.

The generators are numpy in both packages and bit-equal for the same
seed.  With the reference's params carried across (``convert``), the
aggregators are within 1e-6 of the jitted reference's on the same
messages (its std at in-degree 1 is the FMA's rounding residue, which
the port copies).  Both losses are within 1e-5 relative, the forward
within 5e-5 of max(1, |ref|), and the gradients within ``GRAD_TOL`` of
each leaf's largest magnitude: 1e-4, but 2e-3 for the full-batch case
(measured 1.06e-3).  Its block has duplicate edges, so some nodes'
messages are equal and their variance is rounding noise under the 1e-8
floor, where the std (1e-4) and its gradient (1 / (2 std)) turn
last-bit differences into ~1e-3.  The witness: in float64, where that
noise is far below the floor, the two packages' gradients agree within
1e-6 (measured 6e-11 there), and in fp32 the reference's own gradients
are as far from the float64 ones as the port's (6.6e-3 and 5.6e-3).
The first generic step with the
F-Quantization hook on the node-id table is held as
``tests/test_torch_smoke.py`` holds the recsys archs': loss, gradient
norm and priorities within 1e-5 / 1e-5 / 1e-6, the updated dense params
within 1e-4, Adam's moments within 1e-3 (the second squares the
gradients), the table within one int8 step of its row (the int8
tier's stochastic rounding draws differ).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro.configs import common as jcommon
from repro.configs import pna as jpna_cfg
from repro.core.qat_store import FQuantConfig as JFQuantConfig
from repro.data import graphs as jgraphs
from repro.models import gnn as jgnn
from repro.models import layers as jlayers
from repro.optim import optimizers as jopt
from repro.train import steps as jsteps
from repro_torch.configs import common as tcommon
from repro_torch.configs import pna as tpna_cfg
from repro_torch.convert import params_from_jax
from repro_torch.data import graphs as tgraphs
from repro_torch.models import gnn as tgnn
from repro_torch.models import layers as tlayers
from repro_torch.optim import optimizers as topt
from repro_torch.train import steps as tsteps


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x, np.float64)


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol * max(np.abs(want).max() if want.size else 0.0,
                            1.0), err


def _close_leaves(got, want, tol):
    """Each leaf within ``tol`` of its own largest magnitude, and a leaf
    that is 0 but for rounding within 1e-6 of the largest of all."""
    got = [_np(x) for x in got]
    want = [_np(x) for x in want]
    assert len(got) == len(want)
    scale = max(np.abs(w).max() for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        top = np.abs(w).max()
        err = np.abs(g - w).max()
        assert err <= (tol * top if top >= 1e-6 * scale
                       else 1e-6 * scale), (i, err, top)


# ------------------------------------------------------------- generators

@pytest.mark.parametrize("power_law", [True, False])
@pytest.mark.parametrize("feat_dim", [0, 12])
def test_random_graph_bit_equal(power_law, feat_dim):
    want = jgraphs.random_graph(300, 7, feat_dim, seed=5,
                                power_law=power_law)
    got = tgraphs.random_graph(300, 7, feat_dim, seed=5,
                               power_law=power_law)
    for f in ("indptr", "indices", "features", "labels"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert got.num_edges == want.num_edges == 2100
    for a, b in zip(tgraphs.to_edge_list(got), jgraphs.to_edge_list(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("fanouts,seed", [((4, 3), 1), ((15, 10), 2),
                                          ((5,), 0)])
def test_padded_subgraph_bit_equal(fanouts, seed):
    g = jgraphs.random_graph(500, 6, 8, seed=3)
    # an isolated node among the seeds exercises the self-loop fallback
    g.indptr[-1] = g.indptr[-2]
    g.indices = g.indices[:g.indptr[-1]]
    seeds = np.concatenate([np.arange(20), [499]])
    want = jgraphs.padded_subgraph(g, seeds, fanouts, seed=seed)
    got = tgraphs.padded_subgraph(tgraphs.Graph(g.indptr, g.indices,
                                                g.features, g.labels),
                                  seeds, fanouts, seed=seed)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


def test_molecule_batch_bit_equal():
    want = jgraphs.molecule_batch(6, 30, 64, 16, seed=4)
    got = tgraphs.molecule_batch(6, 30, 64, 16, seed=4)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k


# ------------------------------------------------------------ aggregators

def test_aggregate_empty_and_single_segments():
    rng = np.random.default_rng(0)
    e, d, n = 40, 6, 9
    msg = rng.standard_normal((e, d)).astype(np.float32)
    dst = rng.integers(0, 6, e).astype(np.int32)
    dst[0] = 7                  # node 7: in-degree 1; node 8: none
    want_agg, want_deg = jax.jit(jgnn._aggregate, static_argnums=2)(
        jnp.asarray(msg), jnp.asarray(dst), n)
    got_agg, got_deg = tgnn._aggregate(torch.from_numpy(msg),
                                       torch.from_numpy(dst).long(), n)
    assert float(got_deg[8]) == 0.0 and float(got_deg[7]) == 1.0
    assert np.array_equal(_np(got_deg), _np(want_deg))
    assert np.abs(_np(got_agg) - _np(want_agg)).max() <= 1e-6
    # the empty segment's max and min are 0, not -inf / +inf
    assert np.all(_np(got_agg)[8, d:3 * d] == 0.0)


# --------------------------------------------------- forward, loss, grads

def _node_batch():
    g = jgraphs.random_graph(400, 6, 12, seed=3)
    return jgraphs.padded_subgraph(g, np.arange(16), (4, 3), seed=1)


CASES = {
    "node": (dict(d_in=12, d_hidden=16, n_layers=2, node_vocab=400),
             _node_batch, "node_loss"),
    "full": (dict(d_in=12, d_hidden=16, n_layers=3),
             lambda: {**{k: v for k, v in _node_batch().items()
                         if k not in ("node_ids", "seed_local", "labels")},
                      "labels": np.arange(88, dtype=np.int32) % 16},
             "node_loss"),
    "molecule": (dict(d_in=16, d_hidden=12, n_layers=2,
                      graph_readout=True),
                 lambda: jgraphs.molecule_batch(4, 10, 20, 16, seed=2),
                 "graph_loss"),
}


# each leaf's gradient within this of its largest magnitude (module note)
GRAD_TOL = {"node": 1e-4, "full": 2e-3, "molecule": 1e-4}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    kw, make_batch, loss_name = CASES[request.param]
    jcfg, tcfg = jgnn.PNAConfig(**kw), tgnn.PNAConfig(**kw)
    jp = jgnn.init_params(jax.random.PRNGKey(0), jcfg)
    nb = make_batch()
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    jloss = getattr(jgnn, loss_name)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(p, jcfg, b)))(jp, jb)
    jfwd = jax.jit(lambda p, b: jgnn.forward(p, jcfg, b))(jp, jb)
    return dict(name=request.param, jcfg=jcfg, tcfg=tcfg, jp=jp, jb=jb,
                tb=tb, jl=jl, jg=jg, jfwd=jfwd, loss_name=loss_name)


def test_forward_loss_and_grads_match(case):
    tp = params_from_jax(jax.device_get(case["jp"]))
    tcfg, tb = case["tcfg"], case["tb"]
    with torch.no_grad():
        out = tgnn.forward(tp, tcfg, tb)
    _close(out, case["jfwd"], 5e-5)
    p = topt.tree_map(lambda x: x.detach().clone().requires_grad_(), tp)
    loss = getattr(tgnn, case["loss_name"])(p, tcfg, tb)
    grads = torch.autograd.grad(loss, topt.tree_leaves(p), allow_unused=True)
    _close(loss, case["jl"], 1e-5)
    want = topt.tree_leaves(params_from_jax(jax.device_get(case["jg"])))
    grads = [torch.zeros_like(x) if gr is None else gr
             for x, gr in zip(topt.tree_leaves(p), grads)]
    _close_leaves(grads, want, GRAD_TOL[case["name"]])


def _port_grads(tp, case, batch):
    p = topt.tree_map(lambda x: x.detach().clone().requires_grad_(), tp)
    loss = getattr(tgnn, case["loss_name"])(p, case["tcfg"], batch)
    grads = torch.autograd.grad(loss, topt.tree_leaves(p), allow_unused=True)
    return [torch.zeros_like(x) if gr is None else gr
            for x, gr in zip(topt.tree_leaves(p), grads)]


def _gap(got, want):
    """The largest leaf gap, relative to the leaf's largest magnitude."""
    return max(np.abs(_np(g) - _np(w)).max() / max(np.abs(_np(w)).max(),
                                                  1e-30)
               for g, w in zip(got, want))


def test_float64_grads_agree(case, monkeypatch):
    """Both packages in float64: their gradients agree within 1e-6, and
    the port's fp32 gradients are no further from them than the
    reference's own fp32 gradients.  ``dense_bias`` and ``layernorm``
    compute in fp32 whatever their input; here they keep its dtype (the
    same formulas), so the whole forward is float64."""
    def jdense_bias(params, x):
        return jnp.dot(x, params["w"]) + params["b"]

    def jlayernorm(params, x, eps=1e-6):
        mu = jnp.mean(x, axis=-1, keepdims=True)
        var = jnp.var(x, axis=-1, keepdims=True)
        return ((x - mu) * jax.lax.rsqrt(var + eps) * params["g"]
                + params["b"])

    def tlayernorm(params, x, eps=1e-6):
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
        return (x - mu) * torch.rsqrt(var + eps) * params["g"] + params["b"]

    tp = params_from_jax(jax.device_get(case["jp"]))
    f32 = _port_grads(tp, case, case["tb"])
    nb = {k: np.array(v) for k, v in case["jb"].items()}
    nb = {k: v.astype(np.float64) if v.dtype == np.float32 else v
          for k, v in nb.items()}
    monkeypatch.setattr(jlayers, "dense_bias", jdense_bias)
    monkeypatch.setattr(jlayers, "layernorm", jlayernorm)
    monkeypatch.setattr(tlayers, "layernorm", tlayernorm)
    jloss = getattr(jgnn, case["loss_name"])
    jcfg = dataclasses.replace(case["jcfg"], param_dtype=jnp.float64)
    with jax.enable_x64(True):
        jp = jax.tree_util.tree_map(
            lambda x: jnp.asarray(np.asarray(x), jnp.float64), case["jp"])
        jg = jax.jit(jax.grad(lambda p, b: jloss(p, jcfg, b)))(
            jp, {k: jnp.asarray(v) for k, v in nb.items()})
        want = topt.tree_leaves(params_from_jax(jax.device_get(jg)))
    got = _port_grads(topt.tree_map(lambda x: x.double(), tp), case,
                      {k: torch.from_numpy(v) for k, v in nb.items()})
    assert all(g.dtype == w.dtype == torch.float64
               for g, w in zip(got, want))
    assert _gap(got, want) <= 1e-6
    ref32 = topt.tree_leaves(params_from_jax(jax.device_get(case["jg"])))
    assert _gap(f32, want) <= 1.5 * _gap(ref32, want)


def test_first_generic_step_with_the_hook_matches():
    jarch, tarch = jpna_cfg.arch(), tpna_cfg.arch()
    kw = dict(d_in=12, d_hidden=16, n_layers=2, node_vocab=400)
    jcfg, tcfg = jgnn.PNAConfig(**kw), tgnn.PNAConfig(**kw)
    jp = jgnn.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.device_get(jp))
    nb = _node_batch()
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    jhook = jsteps.FQuantHook(
        cfg=JFQuantConfig(), table_path="embed_table",
        indices_fn=lambda b: b["node_ids"],
        labels_fn=lambda b: jnp.ones(b["node_ids"].shape[0], jnp.float32))
    thook = tarch._fquant_hook()
    jo, to = jopt.adam(0.01), topt.adam(0.01)
    jstate = jsteps.init_state(jp, jo, jhook)
    tstate = tsteps.init_state(tp, to, thook)
    jstate, jmet = jax.jit(jsteps.make_train_step(
        lambda p, b: jgnn.node_loss(p, jcfg, b), jo, jhook))(jstate, jb)
    tstate, tmet = tsteps.make_train_step(
        lambda p, b: tgnn.node_loss(p, tcfg, b), to, thook)(tstate, tb)
    _close(tmet["loss"], jmet["loss"], 1e-5)
    _close(tmet["grad_norm"], jmet["grad_norm"], 1e-5)
    _close(tstate.priority, jstate.priority, 1e-6)
    jnew = params_from_jax(jax.device_get(jstate.params))
    dense = sorted(k for k in tstate.params if k != "embed_table")
    _close_leaves(topt.tree_leaves({k: tstate.params[k] for k in dense}),
                  topt.tree_leaves({k: jnew[k] for k in dense}), 1e-4)
    for f in ("mu", "nu"):
        _close_leaves(topt.tree_leaves(getattr(tstate.opt, f)),
                      topt.tree_leaves(params_from_jax(jax.device_get(
                          getattr(jstate.opt, f)))), 1e-3)
    # the snapped table: the touched rows within one int8 step (the
    # stochastic rounding's draws differ), the rest as the reference's
    jt = jnew["embed_table"].double()
    tt = tstate.params["embed_table"].double()
    step = jt.abs().amax(dim=1, keepdim=True) / 127.0
    assert bool(((tt - jt).abs() <= 1.01 * step + 1e-7).all())
    assert jarch.cells() == tarch.cells()


# ---------------------------------------------------------- the arch record

def test_shapes_and_block_shapes_equal_the_reference():
    assert tcommon.GNN_SHAPES == jcommon.GNN_SHAPES
    jarch, tarch = jpna_cfg.arch(), tpna_cfg.arch()
    assert (tarch.name, tarch.family) == (jarch.name, jarch.family)
    for shape in jcommon.GNN_SHAPES:
        assert tarch._block_shape(shape) == jarch._block_shape(shape)
        jc, tc = jarch._cfg(shape), tarch._cfg(shape)
        for f in ("d_in", "d_hidden", "n_layers", "num_classes", "delta",
                  "node_vocab", "graph_readout"):
            assert getattr(tc, f) == getattr(jc, f), (shape, f)
    assert tarch._cfg("minibatch_lg").node_vocab == 233_472
    assert tarch._block_shape("minibatch_lg") == (169_984, 168_960, 1024)


@pytest.mark.parametrize("top", [0, 1, 65_535, 65_536, 232_964, 2 ** 40])
def test_stable_argsort_is_numpys(top):
    rng = np.random.default_rng(top % 97)
    keys = rng.integers(0, top + 1, 5_000)
    keys[:50] = top             # ties, and the largest key
    assert np.array_equal(tgraphs.stable_argsort(keys),
                          np.argsort(keys, kind="stable"))
