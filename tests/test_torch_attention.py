"""Attention (chunked softmax, GQA, MLA, their decode paths) and the MoE
FFN beside the reference's, on the CPU.

The inputs are numpy draws from a seed, fed to both packages in fp32;
params are the reference's, carried across with ``convert``. Tolerances:
attention outputs within 1e-5 of max(1, |ref|) (the same fp32
recurrence; the products sum in another order), its input gradients
within 1e-4 relative to each one's largest magnitude; decode outputs and
the caches they write within 1e-5 of the reference's decode on the same
cache; the MoE output within 1e-5 and its aux loss within 1e-6 (the same
routing: the expert ids are checked equal first, and the low-capacity
cases are checked to drop assignments). The reference's ``test_attention.py`` cases are the cases here.  The
MoE FFN in bf16 is bit-equal to the reference run op by op.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import moe as JM
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM

TOL = 1e-5
# the reference's decode steps, jitted once a shape (cfg is static)
J_GQA_DECODE = jax.jit(JA.gqa_decode, static_argnums=1)
J_MLA_DECODE = jax.jit(JA.mla_decode, static_argnums=1)


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x, np.float64)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1.0), err


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def _attend_both(q, k, v, tq_pos, kv_pos, **kw):
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    want = JA.chunked_attention(jq, jk, jv, q_positions=jnp.asarray(tq_pos),
                                kv_positions=jnp.asarray(kv_pos), **kw)
    got = TA.chunked_attention(tq, tk, tv,
                               q_positions=torch.from_numpy(tq_pos),
                               kv_positions=torch.from_numpy(kv_pos), **{
                                   k_: (torch.from_numpy(np.asarray(v_))
                                        if k_ == "kv_valid" else v_)
                                   for k_, v_ in kw.items()})
    return got, want


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (9, 3)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunk", [16, 64, 1000])
def test_chunked_attention_matches(hq, hkv, causal, chunk):
    b, t, dh = 2, 50, 16
    q, k, v = _draw(0, (b, t, hq, dh), (b, t, hkv, dh), (b, t, hkv, dh))
    pos = np.arange(t, dtype=np.int32)
    got, want = _attend_both(q, k, v, pos, pos, causal=causal, chunk=chunk)
    _close(got, want)


@pytest.mark.parametrize("window", [1, 8, 33])
def test_sliding_window_matches(window):
    b, t, h, dh = 1, 40, 2, 8
    q, k, v = _draw(1, (b, t, h, dh), (b, t, h, dh), (b, t, h, dh))
    pos = np.arange(t, dtype=np.int32)
    got, want = _attend_both(q, k, v, pos, pos, causal=True, window=window,
                             chunk=16)
    _close(got, want)


def test_value_dim_differs_from_key_dim():
    q, k, v = _draw(2, (2, 24, 4, 24), (2, 24, 4, 24), (2, 24, 4, 16))
    pos = np.arange(24, dtype=np.int32)
    got, want = _attend_both(q, k, v, pos, pos, chunk=8, scale=0.2)
    assert tuple(got.shape) == (2, 24, 4, 16)
    _close(got, want)


def test_kv_valid_and_fully_masked_rows():
    """Cache slots past each sequence's length are masked; a query whose
    window holds no key gets 0, finite, in both packages."""
    b, s = 2, 20
    q, k, v = _draw(3, (b, 1, 4, 8), (b, s, 2, 8), (b, s, 2, 8))
    valid = np.arange(s)[None, :] < np.array([[13], [5]])
    got, want = _attend_both(q, k, v, np.array([12], np.int32),
                             np.arange(s, dtype=np.int32), causal=True,
                             chunk=8, kv_valid=valid)
    _close(got, want)
    got, want = _attend_both(q, k, v, np.array([100], np.int32),
                             np.arange(s, dtype=np.int32), causal=True,
                             window=2, chunk=8)
    assert bool(torch.isfinite(got).all())
    _close(got, want)
    assert float(got.abs().max()) == 0.0


def test_chunked_attention_grads_match():
    b, t, hq, hkv, dh = 2, 30, 4, 2, 8
    q, k, v, ct = _draw(4, (b, t, hq, dh), (b, t, hkv, dh), (b, t, hkv, dh),
                        (b, t, hq, dh))
    pos = np.arange(t, dtype=np.int32)

    def jf(q, k, v):
        out = JA.chunked_attention(q, k, v, q_positions=jnp.asarray(pos),
                                   kv_positions=jnp.asarray(pos),
                                   causal=True, window=9, chunk=8)
        return jnp.sum(out * jnp.asarray(ct))

    want = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = TA.chunked_attention(tq, tk, tv, q_positions=torch.from_numpy(pos),
                               kv_positions=torch.from_numpy(pos),
                               causal=True, window=9, chunk=8)
    got = torch.autograd.grad((out * torch.from_numpy(ct)).sum(),
                              (tq, tk, tv))
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


# ------------------------------------------------------------------ decode

def _gqa(window=None, chunk=8):
    jcfg = JA.GQAConfig(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
                        qk_norm=True, window=window, chunk=chunk)
    tcfg = TA.GQAConfig(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
                        qk_norm=True, window=window, chunk=chunk)
    jp = JA.gqa_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_jax(jax.device_get(jp))


def test_gqa_attend_and_linear_decode_match():
    jcfg, tcfg, jp, tp = _gqa()
    b, t, s = 2, 12, 16
    (x,) = _draw(5, (b, t, 32))
    jrope, trope = JL.rope_inv_freq(8), TL.rope_inv_freq(8)
    jfull, (jk, jv) = JA.gqa_attend(jp, jcfg, jnp.asarray(x), jrope,
                                    jnp.arange(t))
    with torch.no_grad():
        tfull, (tk, tv) = TA.gqa_attend(tp, tcfg, torch.from_numpy(x),
                                        trope, torch.arange(t))
    _close(tfull, jfull)
    _close(tk, jk)
    _close(tv, jv)
    jck = jcv = jnp.zeros((b, s, 2, 8))
    tck, tcv = torch.zeros((b, s, 2, 8)), torch.zeros((b, s, 2, 8))
    for i in range(t):
        jo, jck, jcv = J_GQA_DECODE(jp, jcfg, jnp.asarray(x[:, i:i + 1]),
                                     jck, jcv, jnp.asarray(i), jrope)
        with torch.no_grad():
            to, tck, tcv = TA.gqa_decode(tp, tcfg,
                                         torch.from_numpy(x[:, i:i + 1]),
                                         tck, tcv, i, trope)
        _close(to, jo)
        _close(tck, jck)
        _close(tcv, jcv)


def test_gqa_rolling_decode_matches():
    w = 4
    jcfg, tcfg, jp, tp = _gqa(window=w, chunk=4)
    b, t = 1, 10
    (x,) = _draw(6, (b, t, 32))
    jrope, trope = JL.rope_inv_freq(8), TL.rope_inv_freq(8)
    jrk = jrv = jnp.zeros((b, w, 2, 8))
    trk, trv = torch.zeros((b, w, 2, 8)), torch.zeros((b, w, 2, 8))
    jpos = jnp.full((w,), 2 ** 30, jnp.int32)
    tpos = torch.full((w,), 2 ** 30, dtype=torch.int32)
    for i in range(t):
        jo, jrk, jrv = J_GQA_DECODE(jp, jcfg, jnp.asarray(x[:, i:i + 1]),
                                     jrk, jrv, jnp.asarray(i), jrope,
                                     jpos, jnp.asarray(i % w))
        jpos = jpos.at[i % w].set(i)
        with torch.no_grad():
            to, trk, trv = TA.gqa_decode(tp, tcfg,
                                         torch.from_numpy(x[:, i:i + 1]),
                                         trk, trv, i, trope,
                                         kv_positions=tpos,
                                         write_slot=i % w)
        tpos[i % w] = i
        _close(to, jo)
        _close(trk, jrk)


def test_mla_attend_and_decode_match():
    kw = dict(d_model=32, n_heads=2, kv_lora_rank=16, qk_nope_dim=8,
              qk_rope_dim=4, v_head_dim=8, chunk=8)
    jcfg, tcfg = JA.MLAConfig(**kw), TA.MLAConfig(**kw)
    jp = JA.mla_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.device_get(jp))
    jrope, trope = JL.rope_inv_freq(4), TL.rope_inv_freq(4)
    b, t, s = 2, 9, 12
    (x,) = _draw(7, (b, t, 32))
    jfull, (jc, jr) = JA.mla_attend(jp, jcfg, jnp.asarray(x), jrope,
                                    jnp.arange(t))
    with torch.no_grad():
        tfull, (tc, tr) = TA.mla_attend(tp, tcfg, torch.from_numpy(x),
                                        trope, torch.arange(t))
    _close(tfull, jfull)
    _close(tc, jc)
    _close(tr, jr)
    jckv, jckr = jnp.zeros((b, s, 16)), jnp.zeros((b, s, 4))
    tckv, tckr = torch.zeros((b, s, 16)), torch.zeros((b, s, 4))
    for i in range(t):
        jo, jckv, jckr = J_MLA_DECODE(jp, jcfg, jnp.asarray(x[:, i:i + 1]),
                                       jckv, jckr, jnp.asarray(i), jrope)
        with torch.no_grad():
            to, tckv, tckr = TA.mla_decode(tp, tcfg,
                                           torch.from_numpy(x[:, i:i + 1]),
                                           tckv, tckr, i, trope)
        _close(to, jo)
        _close(tckv, jckv)


# --------------------------------------------------------------------- MoE

@pytest.mark.parametrize("blocks,cf,shared", [(1, 1.25, 0), (1, 0.5, 1),
                                              (4, 0.75, 2)])
def test_moe_ffn_matches(blocks, cf, shared):
    kw = dict(d_model=16, d_ff=24, num_experts=4, top_k=2,
              num_shared=shared, capacity_factor=cf, dispatch_blocks=blocks)
    jcfg, tcfg = JM.MoEConfig(**kw), TM.MoEConfig(**kw)
    jp = JM.moe_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.device_get(jp))
    (x,) = _draw(8, (2, 16, 16))
    jout, jaux = jax.jit(lambda p, x: JM.moe_ffn(p, jcfg, x))(
        jp, jnp.asarray(x))
    with torch.no_grad():
        tout, taux = TM.moe_ffn(tp, tcfg, torch.from_numpy(x))
    # the same routing: expert ids, and which assignments were dropped
    logits = x.reshape(-1, 16) @ np.asarray(jp["router"]["w"])
    je, _, _ = JM._routing(jnp.asarray(logits), jcfg)
    te, _, _ = TM._routing(torch.from_numpy(logits), tcfg)
    assert np.array_equal(np.asarray(je), te.numpy())
    if cf < 1:       # capacity below the load: some assignments dropped
        n = x.shape[0] * x.shape[1] // blocks
        cap = int(max(1, round(n * 2 / 4 * cf)))
        loads = [np.bincount(blk, minlength=4).max()
                 for blk in te.numpy().reshape(blocks, -1)]
        assert max(loads) > cap
    _close(tout, jout)
    assert abs(float(taux) - float(jaux)) <= 1e-6


@pytest.mark.parametrize("blocks,cf", [(1, 1.25), (2, 0.75)])
def test_moe_ffn_bf16_adds_as_the_reference(blocks, cf):
    """bf16 activations, deepseek-v2-lite's top_k 6 with 2 shared experts:
    bit-equal to the jitted reference compiled to round each op to its
    dtype as the code writes (``xla_allow_excess_precision`` off, which
    equals the reference run op by op, as eager torch runs), so each
    token's six contributions are added in the reference's order with a
    bf16 rounding after each add.  As XLA fuses by default it keeps fp32
    between fused ops (a third of the outputs move): within 2^-6 of
    max(1, |ref|), a few bf16 units."""
    kw = dict(d_model=32, d_ff=24, num_experts=16, top_k=6, num_shared=2,
              capacity_factor=cf, dispatch_blocks=blocks)
    jcfg, tcfg = JM.MoEConfig(**kw), TM.MoEConfig(**kw)
    jp = JM.moe_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.device_get(jp))
    (x,) = _draw(8, (2, 16, 32))
    jx = jnp.asarray(x, jnp.bfloat16)
    fn = jax.jit(lambda p, x: JM.moe_ffn(p, jcfg, x))
    eout, eaux = fn.lower(jp, jx).compile(compiler_options={
        "xla_allow_excess_precision": False})(jp, jx)
    jout, _ = fn(jp, jx)
    with torch.no_grad():
        tout, taux = TM.moe_ffn(tp, tcfg, torch.from_numpy(x).bfloat16())
    assert tout.dtype == torch.bfloat16
    assert np.array_equal(tout.float().numpy(),
                          np.asarray(eout.astype(jnp.float32)))
    assert abs(float(taux) - float(eaux)) <= 1e-6
    _close(tout.float(), jout.astype(jnp.float32), 2.0 ** -6)


def test_top_k_breaks_ties_toward_the_lower_index():
    x = np.array([[0.25, 0.5, 0.25, 0.5], [0.1, 0.1, 0.1, 0.7]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 3)
    tv, ti = TM.top_k(torch.from_numpy(x), 3)
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert np.array_equal(np.asarray(jv), tv.numpy())
