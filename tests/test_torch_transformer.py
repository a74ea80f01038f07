"""The LM family (transformer, its configs, the token stream, the arch
record) beside the reference's, on the CPU, at the five smoke configs.

With the reference's params carried across (``convert``) and one numpy
token batch, in fp32 (the smoke configs' compute dtype), the jitted
reference and the port agree: the loss within 1e-5 relative (2-3
layers of fp32 GEMMs, softmax and norms, summed in another order), each
gradient leaf within 1e-4 of its largest magnitude (1e-6 of the largest
of all for a leaf that is 0 but for rounding), prefill logits and caches
within 1e-5 of max(1, |ref|), and decode logits and caches within 1e-5
step by step from the same empty cache (linear for all five, rolling for
mixtral).  The generic step with the F-Quantization hook on ``embed`` is
held as ``tests/test_torch_smoke.py`` holds the recsys archs' (Adam's
moments within 1e-4, the table within one int8 step of its row: the
stochastic rounding's draws differ).  Parameter counts, shapes, cells
and the token stream are equal exactly.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro import configs as jconfigs
from repro.configs import common as jcommon
from repro.core.qat_store import FQuantConfig as JFQuantConfig
from repro.data import lm as jlm
from repro.models import transformer as JT
from repro.optim import optimizers as jopt
from repro.train import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch.configs import common as tcommon
from repro_torch.convert import params_from_jax
from repro_torch.data import lm as tlm
from repro_torch.models import transformer as TT
from repro_torch.optim import optimizers as topt
from repro_torch.train import steps as tsteps

# bf16 keeps 8 significant bits, a unit roundoff of 2^-9.  The port and the
# reference rounded op by op (``STRICT`` below) round alike, but XLA's dot
# and torch's matmul add an fp32 product in other orders, and a last-bit
# difference flips a bf16 rounding now and then (deepseek-v2-lite's first
# layer: 0.4% of its outputs); the next layers carry it, to 2.7 units of
# its logits and caches.  Four units, 2^-7:
TOL_BF16 = 2.0 ** -7

LMS = ("smollm-135m", "qwen3-8b", "deepseek-coder-33b", "mixtral-8x22b",
       "deepseek-v2-lite-16b")


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


def _tokens(vocab: int, b: int = 2, t: int = 16, seed: int = 1):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


@pytest.fixture(scope="module", params=LMS)
def lm(request):
    """One smoke config's reference params, token batch, and the jitted
    reference's loss, gradients and prefill."""
    jcfg = jconfigs.get(request.param).smoke_cfg
    tcfg = tconfigs.get(request.param).smoke_cfg
    jp = jax.jit(lambda k: JT.init_params(k, jcfg))(jax.random.PRNGKey(0))
    toks = _tokens(jcfg.vocab)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, t: JT.lm_loss(p, jcfg, t)))(jp, jnp.asarray(toks))
    jlogits, jcaches = jax.jit(lambda p, t: JT.prefill(p, jcfg, t))(
        jp, jnp.asarray(toks))
    return dict(name=request.param, jcfg=jcfg, tcfg=tcfg, jp=jp,
                tp=params_from_jax(jax.device_get(jp)), toks=toks, jl=jl,
                jg=jg, jlogits=jlogits, jcaches=jcaches)


def test_config_fields_equal_the_reference(lm):
    jcfg, tcfg = lm["jcfg"], lm["tcfg"]
    for f in dataclasses.fields(tcfg):
        want = getattr(jcfg, f.name)
        got = getattr(tcfg, f.name)
        if f.name in ("param_dtype", "compute_dtype"):
            assert str(got).split(".")[-1] == jnp.dtype(want).name
        elif f.name == "moe" and want is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        else:
            assert got == want, f.name


def test_lm_loss_and_grads_match(lm):
    tp, tcfg = lm["tp"], lm["tcfg"]
    p = topt.tree_map(lambda x: x.detach().clone().requires_grad_(), tp)
    loss = TT.lm_loss(p, tcfg, torch.from_numpy(lm["toks"]))
    grads = torch.autograd.grad(loss, topt.tree_leaves(p))
    _close(loss, lm["jl"], 1e-5)
    _close_leaves(grads, topt.tree_leaves(params_from_jax(
        jax.device_get(lm["jg"]))), 1e-4)


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_remat_policies_give_the_same_numbers(lm, remat):
    """``full`` (the configs' default), ``dots`` and ``none``: the same
    loss and gradients, bit for bit on the CPU."""
    tp, toks = lm["tp"], torch.from_numpy(lm["toks"])

    def run(cfg):
        p = topt.tree_map(lambda x: x.detach().clone().requires_grad_(), tp)
        loss = TT.lm_loss(p, cfg, toks)
        return [loss] + list(torch.autograd.grad(loss, topt.tree_leaves(p)))

    assert lm["tcfg"].remat == "full"
    for a, b in zip(run(lm["tcfg"]),
                    run(dataclasses.replace(lm["tcfg"], remat=remat))):
        assert torch.equal(a, b)


def test_prefill_matches(lm):
    with torch.no_grad():
        logits, (dense, (k, v)) = TT.prefill(lm["tp"], lm["tcfg"],
                                             torch.from_numpy(lm["toks"]))
    jlogits, (jdense, (jk, jv)) = lm["jlogits"], lm["jcaches"]
    _close(logits, jlogits, 1e-5)
    assert logits.dtype == torch.float32
    _close(k, jk, 1e-5)
    _close(v, jv, 1e-5)
    assert len(dense) == len(jdense) == lm["tcfg"].first_dense
    for (a, b), (ja, jb) in zip(dense, jdense):
        _close(a, ja, 1e-5)
        _close(b, jb, 1e-5)


def test_decode_steps_match(lm):
    jcfg, tcfg = lm["jcfg"], lm["tcfg"]
    rolling = jcfg.window is not None
    size = jcfg.window if rolling else 12
    jstep = jax.jit(lambda p, t, c, n: JT.decode_step(p, jcfg, t, c, n))
    jcache = JT.init_cache(jcfg, 2, size, jnp.float32, rolling=rolling)
    tcache = TT.init_cache(tcfg, 2, size, torch.float32, rolling=rolling)
    toks = _tokens(jcfg.vocab, t=size + 4 if rolling else 6, seed=2)
    for i in range(toks.shape[1]):
        tok = toks[:, i:i + 1]
        jlog, jcache = jstep(lm["jp"], jnp.asarray(tok), jcache,
                             jnp.asarray(i))
        with torch.no_grad():
            tlog, tcache = TT.decode_step(lm["tp"], tcfg,
                                          torch.from_numpy(tok), tcache, i)
        _close(tlog, jlog, 1e-5)
        for key in jcache:
            if key == "pos":
                assert np.array_equal(tcache[key].numpy(),
                                      np.asarray(jcache[key]))
            else:
                _close(tcache[key], jcache[key], 1e-5)


# ------------------------------------------------------------ bf16 compute

BF16 = ("qwen3-8b", "mixtral-8x22b", "deepseek-v2-lite-16b")


def _bf16_cfgs(name):
    return (dataclasses.replace(jconfigs.get(name).smoke_cfg,
                                compute_dtype=jnp.bfloat16),
            dataclasses.replace(tconfigs.get(name).smoke_cfg,
                                compute_dtype=torch.bfloat16))


def _bf16_first_layer(caches):
    """The first layer's prefill caches: ``dense_layer_0``'s where there
    is one, else the stack's layer 0."""
    dense, (k, v) = caches
    return dense[0] if dense else (k[0], v[0])


def _bits(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


# XLA keeps fp32 between the ops it fuses unless told to round each op to
# its dtype as the code writes; so told, the jitted reference equals the
# reference run op by op (``jax.disable_jit``) bit for bit, which is how
# the port's eager torch rounds
STRICT = {"xla_allow_excess_precision": False}


def _strict(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=STRICT)


@pytest.fixture(scope="module", params=BF16)
def lm_bf16(request):
    """A dense GQA, a MoE with a rolling cache, and the MLA + MoE config
    at ``compute_dtype=bfloat16``: the jitted reference's loss, prefill
    and 4 decode steps from an empty cache, rounded op by op
    (``STRICT``), and its loss as XLA fuses it by default."""
    jcfg, tcfg = _bf16_cfgs(request.param)
    jp = jax.jit(lambda k: JT.init_params(k, jcfg))(jax.random.PRNGKey(0))
    np_toks = _tokens(jcfg.vocab)
    toks = jnp.asarray(np_toks)
    rolling = jcfg.window is not None
    size = jcfg.window if rolling else 8
    steps = _tokens(jcfg.vocab, t=4, seed=2)

    def loss(p, t):
        return JT.lm_loss(p, jcfg, t)

    def prefill(p, t):
        return JT.prefill(p, jcfg, t)

    def decode(p, t, c, i):
        return JT.decode_step(p, jcfg, t, c, i)

    cache = JT.init_cache(jcfg, 2, size, rolling=rolling)
    step = _strict(decode, jp, jnp.asarray(steps[:, :1]), cache,
                   jnp.asarray(0))
    dec = []
    for i in range(steps.shape[1]):
        log, cache = step(jp, jnp.asarray(steps[:, i:i + 1]), cache,
                          jnp.asarray(i))
        dec.append((log, cache))
    logits, caches = _strict(prefill, jp, toks)(jp, toks)
    return dict(jcfg=jcfg, tcfg=tcfg, toks=np_toks,
                tp=params_from_jax(jax.device_get(jp)), rolling=rolling,
                size=size, steps=steps, decode=dec, logits=logits,
                caches=caches, loss=_strict(loss, jp, toks)(jp, toks),
                fused_loss=jax.jit(loss)(jp, toks))


def _bf16_prefill(lm_bf16):
    with torch.no_grad():
        return TT.prefill(lm_bf16["tp"], lm_bf16["tcfg"],
                          torch.from_numpy(lm_bf16["toks"]))


def test_bf16_first_layer_caches_are_the_references(lm_bf16):
    """The first layer's caches come from the embedding through rmsnorm,
    ``dense`` and RoPE: bit-equal to the reference's.  ``dense`` must
    upcast the bf16 activations and round the fp32 product once; casting
    ``w`` to bf16 moves ~20% of them (the next test)."""
    _, caches = _bf16_prefill(lm_bf16)
    for a, b in zip(_bf16_first_layer(caches),
                    _bf16_first_layer(lm_bf16["caches"])):
        assert a.dtype == torch.bfloat16
        assert np.array_equal(_bits(a), _bits(b))


def test_bf16_weight_cast_fails_the_first_layer_check(lm_bf16,
                                                      monkeypatch):
    """The check above catches a ``dense`` that casts ``w`` down to bf16
    (a bf16 GEMM) instead of upcasting ``x``."""
    from repro_torch.models import layers as TL
    monkeypatch.setattr(TL, "dense", lambda params, x: torch.matmul(
        x, params["w"].to(x.dtype)))
    _, caches = _bf16_prefill(lm_bf16)
    moved = [np.mean(_bits(a) != _bits(b)) for a, b in zip(
        _bf16_first_layer(caches), _bf16_first_layer(lm_bf16["caches"]))]
    assert min(moved) > 0.05, moved


def test_bf16_prefill_and_decode_match(lm_bf16):
    """Prefill logits (fp32 on both sides: ``logits_fn`` upcasts the bf16
    operands) and every layer's caches, then 4 decode steps from an empty
    cache, within TOL_BF16 of max(1, |ref|) of the reference rounded op
    by op; the loss within 1e-4 relative of it (deepseek-v2-lite's flips
    move it by 8e-6), and within 1e-3 of the reference as XLA fuses it (its fp32 intermediates move the bf16
    hidden states by a unit in ~1/3 of their entries, the mean loss by
    ~6e-5)."""
    logits, caches = _bf16_prefill(lm_bf16)
    assert logits.dtype == torch.float32
    assert lm_bf16["logits"].dtype == jnp.float32
    _close(logits, lm_bf16["logits"], TOL_BF16)
    (dense, (k, v)), (jdense, (jk, jv)) = caches, lm_bf16["caches"]
    for a, b in [(k, jk), (v, jv)] + [p for pair in zip(dense, jdense)
                                      for p in zip(*pair)]:
        assert a.dtype == torch.bfloat16
        _close(a.float(), jnp.asarray(b, jnp.float32), TOL_BF16)
    tcfg, tp = lm_bf16["tcfg"], lm_bf16["tp"]
    cache = TT.init_cache(tcfg, 2, lm_bf16["size"],
                          rolling=lm_bf16["rolling"])
    steps = lm_bf16["steps"]
    for i, (jlog, jcache) in enumerate(lm_bf16["decode"]):
        with torch.no_grad():
            log, cache = TT.decode_step(tp, tcfg, torch.from_numpy(
                steps[:, i:i + 1]), cache, i)
        assert log.dtype == torch.float32
        _close(log, jlog, TOL_BF16)
        for key in jcache:
            if key != "pos":
                assert cache[key].dtype == torch.bfloat16
                _close(cache[key].float(),
                       jnp.asarray(jcache[key], jnp.float32), TOL_BF16)
    with torch.no_grad():
        loss = TT.lm_loss(tp, tcfg, torch.from_numpy(lm_bf16["toks"]))
    _close(loss, lm_bf16["loss"], 1e-4)
    _close(loss, lm_bf16["fused_loss"], 1e-3)


@pytest.mark.parametrize("name", LMS)
@pytest.mark.parametrize("rolling", [False, True])
def test_init_cache_layouts(name, rolling):
    for which in ("smoke_cfg", "lm_cfg"):
        jcfg = getattr(jconfigs.get(name), which)
        tcfg = getattr(tconfigs.get(name), which)
        want = jax.eval_shape(lambda: JT.init_cache(jcfg, 3, 8,
                                                    rolling=rolling))
        got = TT.init_cache(tcfg, 3, 8, rolling=rolling, device="meta")
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, (which, k)
            assert str(got[k].dtype).split(".")[-1] == want[k].dtype.name
    cache = TT.init_cache(tconfigs.get(name).smoke_cfg, 1, 4, rolling=True)
    assert cache["pos"].tolist() == [2 ** 30] * 4


@pytest.mark.parametrize("name", LMS)
def test_param_counts_equal_the_reference(name):
    for which in ("smoke_cfg", "lm_cfg"):
        jcfg = getattr(jconfigs.get(name), which)
        tcfg = getattr(tconfigs.get(name), which)
        assert TT.param_count(tcfg) == JT.param_count(jcfg)
        assert TT.active_param_count(tcfg) == JT.active_param_count(jcfg)
    smoke = tconfigs.get(name).smoke_cfg
    gen = torch.Generator()
    gen.manual_seed(0)
    from repro_torch.models.layers import count_params
    assert count_params(TT.init_params(gen, smoke, torch.device("cpu"))) \
        == TT.param_count(smoke)


def test_full_param_counts():
    assert TT.param_count(tconfigs.get("smollm-135m").lm_cfg) == 134_515_008
    assert TT.param_count(tconfigs.get("qwen3-8b").lm_cfg) == 8_190_735_360


@pytest.mark.parametrize("seed,vocab,zipf", [(0, 512, 1.1), (3, 8192, 1.1),
                                             (1, 300, 0.9)])
def test_lm_synth_bit_equal(seed, vocab, zipf):
    jcfg = jlm.LMConfig(vocab=vocab, seq_len=40, zipf_a=zipf, seed=seed)
    tcfg = tlm.LMConfig(vocab=vocab, seq_len=40, zipf_a=zipf, seed=seed)
    for step in (0, 7):
        want = jlm.LMSynth(jcfg).batch(4, step)
        got = tlm.LMSynth(tcfg).batch(4, step)
        assert got["tokens"].dtype == want["tokens"].dtype
        assert np.array_equal(got["tokens"], want["tokens"])


def test_shapes_cells_and_names_equal_the_reference():
    assert tcommon.LM_SHAPES == jcommon.LM_SHAPES
    assert tconfigs.names() == jconfigs.names()
    for name in jconfigs.names():
        jarch, tarch = jconfigs.get(name), tconfigs.get(name)
        assert (tarch.name, tarch.family) == (jarch.name, jarch.family)
        if jarch.family != "recsys":
            assert tarch.cells() == jarch.cells(), name
        if jarch.family == "lm":
            assert (tarch.supports_long, tarch.rolling_window, tarch.lr,
                    tarch.fquant) == (jarch.supports_long,
                                      jarch.rolling_window, jarch.lr,
                                      jarch.fquant)


@pytest.mark.parametrize("name", ["smollm-135m", "mixtral-8x22b"])
def test_first_generic_step_with_the_hook_matches(name):
    jcfg = jconfigs.get(name).smoke_cfg
    tarch = tconfigs.get(name)
    tcfg = tarch.smoke_cfg
    jp = jax.jit(lambda k: JT.init_params(k, jcfg))(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.device_get(jp))
    toks = _tokens(jcfg.vocab)
    jhook = jsteps.FQuantHook(
        cfg=JFQuantConfig(), table_path="embed",
        indices_fn=lambda b: b["tokens"],
        labels_fn=lambda b: jnp.ones(b["tokens"].shape[0], jnp.float32))
    thook = tarch._fquant_hook()
    jo, to = jopt.adam(1e-3), topt.adam(1e-3)
    jstate, jmet = jax.jit(jsteps.make_train_step(
        lambda p, b: JT.lm_loss(p, jcfg, b["tokens"]), jo, jhook))(
        jsteps.init_state(jp, jo, jhook), {"tokens": jnp.asarray(toks)})
    tstate, tmet = tsteps.make_train_step(
        lambda p, b: TT.lm_loss(p, tcfg, b["tokens"]), to, thook)(
        tsteps.init_state(tp, to, thook), {"tokens": torch.from_numpy(toks)})
    _close(tmet["loss"], jmet["loss"], 1e-5)
    _close(tmet["grad_norm"], jmet["grad_norm"], 1e-5)
    _close(tstate.priority, jstate.priority, 1e-6)
    jnew = params_from_jax(jax.device_get(jstate.params))
    rest = sorted(k for k in tstate.params if k != "embed")
    _close_leaves(topt.tree_leaves({k: tstate.params[k] for k in rest}),
                  topt.tree_leaves({k: jnew[k] for k in rest}), 1e-4)
    for f in ("mu", "nu"):
        _close_leaves(topt.tree_leaves(getattr(tstate.opt, f)),
                      topt.tree_leaves(params_from_jax(jax.device_get(
                          getattr(jstate.opt, f)))), 1e-4)
    jt = jnew["embed"].double()
    tt = tstate.params["embed"].double()
    step = jt.abs().amax(dim=1, keepdim=True) / 127.0
    assert bool(((tt - jt).abs() <= 1.01 * step + 1e-7).all())
