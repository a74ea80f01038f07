"""The port's row-wise int8 quantizer against the JAX package, on the CPU.

Same numpy inputs through both packages, bit for bit (tolerance 0):

* the reciprocal form (``reciprocal=True``) against the reference's
  Pallas kernel in interpret mode: that kernel is jitted, so XLA turns
  its ``max_abs / 127`` into ``max_abs * fp32(1/127)``;
* the dividing form against the eager jnp oracle ``quantize_rowwise_ref``
  and ``core.rowwise_quant.quantize_rowwise``, which divide;
* stochastic rounding with the same noise, the full mode (127.5), all-
  zero rows (the 1e-12 floor), values on exact .5 multiples of the scale
  (half to even) and V that no 256-row block divides;
* rows holding NaN or inf: NaN and inf scales, codes 0, as both
  references give them.

The packed store's int8 tier now goes through this op: its packs stay
leaf-equal to the reference's (``test_torch_dlrm_serve.py``,
``test_torch_online_serve.py``) and to the torch expression here.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro.core import rowwise_quant as jrq
from repro.kernels.rowwise_quant.kernel import quantize_rowwise_pallas
from repro.kernels.rowwise_quant.ref import quantize_rowwise_ref as j_ref
from repro_torch.core import packed_store as tps
from repro_torch.core import qat_store as tqs
from repro_torch.core import rowwise_quant as trq
from repro_torch.core.tiers import Tier
from repro_torch.kernels import cases
from repro_torch.kernels.rowwise_quant import kernel as tkernel
from repro_torch.kernels.rowwise_quant import ops as tops


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    a = np.asarray(x)
    return a.view({1: np.uint8, 4: np.uint32}[a.dtype.itemsize])


def _rows(v: int, d: int, seed: int) -> np.ndarray:
    """Pareto-scaled rows, an all-zero row, and a row whose values sit on
    exact .5 multiples of its scale."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((v, d))
         * (rng.pareto(1.2, (v, 1)) + 1e-3)).astype(np.float32)
    x[1] = 0.0
    half = (np.arange(d) % 9 - 4).astype(np.float32) + 0.5
    x[2] = half * np.float32(0.25)
    x[2, 0] = np.float32(127 * 0.25)        # max_abs -> scale 0.25 exactly
    return x


SHAPES = [(300, 64), (257, 32), (33, 10), (1000, 8)]


@pytest.mark.parametrize("v,d", SHAPES)
@pytest.mark.parametrize("mode", ["narrow", "full"])
@pytest.mark.parametrize("stochastic", [False, True])
def test_reciprocal_form_bit_equal_to_interpret_kernel(v, d, mode,
                                                       stochastic):
    x = _rows(v, d, v + d)
    noise = (np.random.default_rng(d).random((v, d)).astype(np.float32)
             if stochastic else None)
    wq, ws = quantize_rowwise_pallas(
        jnp.asarray(x), None if noise is None else jnp.asarray(noise),
        mode=mode, interpret=True)
    tkernel.reset_launches()
    q, s = tops.quantize_rowwise(
        torch.from_numpy(x), None if noise is None else torch.from_numpy(
            noise), mode, reciprocal=True)
    assert tkernel.total_launches() == 0        # CPU tensors: plain version
    assert q.dtype == torch.int8 and s.shape == (v, 1)
    np.testing.assert_array_equal(bits(ws), bits(s))
    np.testing.assert_array_equal(bits(wq), bits(q))


@pytest.mark.parametrize("v,d", SHAPES)
@pytest.mark.parametrize("mode", ["narrow", "full"])
@pytest.mark.parametrize("stochastic", [False, True])
def test_dividing_form_bit_equal_to_eager_reference(v, d, mode, stochastic):
    x = _rows(v, d, 2 * v + d)
    noise = (np.random.default_rng(d + 1).random((v, d)).astype(np.float32)
             if stochastic else None)
    tx = torch.from_numpy(x)
    tn = None if noise is None else torch.from_numpy(noise)
    q, s = tops.quantize_rowwise(tx, tn, mode, reciprocal=False)
    wq, ws = j_ref(jnp.asarray(x), None if noise is None
                   else jnp.asarray(noise), mode)
    np.testing.assert_array_equal(bits(ws), bits(s))
    np.testing.assert_array_equal(bits(wq), bits(q))
    if not stochastic:
        cq, cs = jrq.quantize_rowwise(jnp.asarray(x), 8, mode=mode)
        np.testing.assert_array_equal(bits(cs), bits(s))
        np.testing.assert_array_equal(bits(cq), bits(q))
        pq, ps = trq.quantize_rowwise(tx, 8, mode=mode)
        np.testing.assert_array_equal(bits(pq), bits(q))
        np.testing.assert_array_equal(bits(ps), bits(s))


def test_the_two_scale_forms_differ_in_the_last_bit():
    """On 4,096 pareto-scaled rows some scales differ: the caller's form
    matters (the eager reference divides, the jitted one multiplies)."""
    x = torch.from_numpy(_rows(4096, 16, 3))
    _, div = tops.quantize_rowwise(x, reciprocal=False)
    _, mul = tops.quantize_rowwise(x, reciprocal=True)
    differ = int((bits(div) != bits(mul)).sum())
    assert 0 < differ < 4096
    assert torch.allclose(div, mul, rtol=1e-6, atol=0)


def _non_finite(x: np.ndarray) -> np.ndarray:
    """Rows 3-5 with a NaN, a +inf and all -inf."""
    x = x.copy()
    x[3, 1] = np.nan
    x[4, 0] = np.inf
    x[5, :] = -np.inf
    return x


@pytest.mark.parametrize("reciprocal", [False, True])
@pytest.mark.parametrize("stochastic", [False, True])
def test_non_finite_rows_follow_the_reference(reciprocal, stochastic):
    """A NaN row's scale is NaN and an inf row's inf; their codes are 0
    (NaN cast to int8), as in both references."""
    v, d = 40, 12
    x = _non_finite(_rows(v, d, 7))
    noise = (np.random.default_rng(8).random((v, d)).astype(np.float32)
             if stochastic else None)
    jn = None if noise is None else jnp.asarray(noise)
    if reciprocal:
        wq, ws = quantize_rowwise_pallas(jnp.asarray(x), jn, interpret=True)
    else:
        wq, ws = j_ref(jnp.asarray(x), jn)
    q, s = tops.quantize_rowwise(
        torch.from_numpy(x), None if noise is None else torch.from_numpy(
            noise), reciprocal=reciprocal)
    assert np.isnan(s[3, 0]) and np.isinf(s[4, 0]) and np.isinf(s[5, 0])
    assert not q[3:6].any()
    np.testing.assert_array_equal(np.asarray(ws), s.numpy())   # NaN == NaN
    np.testing.assert_array_equal(bits(wq), bits(q))


def test_zero_rows_and_half_multiples():
    x = _rows(8, 18, 4)
    q, s = tops.quantize_rowwise(torch.from_numpy(x))
    assert float(s[1, 0]) == np.float32(1e-12) / np.float32(127)
    assert not q[1].any()
    # x[2] = (k + 0.5) * 0.25 with scale 0.25: ties go to the even integer
    want = np.round((np.arange(18) % 9 - 4) + 0.5)
    want[0] = 127
    np.testing.assert_array_equal(q[2].numpy(), want.astype(np.int8))


def test_int8_tier_quantizer_is_the_kernel_op():
    """``_quantize_tier`` routes 8-bit int8 rows through the op (dividing
    form) and other widths through the torch expression; both equal what
    ``pack`` always made."""
    x = torch.from_numpy(_rows(100, 12, 5))
    for mode in ("narrow", "full"):
        cfg = tqs.FQuantConfig(mode=mode)
        q, s = tps._quantize_tier(x, Tier.INT8, cfg)
        wq, ws = trq.quantize_rowwise(x, 8, mode=mode)
        np.testing.assert_array_equal(bits(wq), bits(q))
        np.testing.assert_array_equal(bits(ws[:, 0]), bits(s))
    cfg4 = tqs.FQuantConfig(bits=4)
    q4, s4 = tps._quantize_tier(x, Tier.INT8, cfg4)
    wq4, ws4 = trq.quantize_rowwise(x, 4)
    assert int(q4.abs().max()) <= 8
    np.testing.assert_array_equal(bits(wq4), bits(q4))
    np.testing.assert_array_equal(bits(ws4[:, 0]), bits(s4))


def test_empty_input_and_cuda_wrapper_refuses_cpu_tensors():
    q, s = tops.quantize_rowwise(torch.zeros((0, 8)))
    assert q.shape == (0, 8) and s.shape == (0, 1)
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.quantize_rowwise_cuda(torch.zeros((4, 8)))


def _scales_equal(want, got) -> None:
    """Bit for bit, any NaN equal to any NaN."""
    want, got = np.asarray(want), np.asarray(got)
    nan = np.isnan(want)
    np.testing.assert_array_equal(nan, np.isnan(got))
    np.testing.assert_array_equal(bits(want[~nan]), bits(got[~nan]))


@pytest.mark.parametrize("name", cases.QUANT_CASE_NAMES)
@pytest.mark.parametrize("reciprocal", [False, True])
def test_plain_bit_equal_on_the_kernel_cases(name, reciprocal):
    """The card check's adversarial inputs (``kernels/cases.py``) in both
    modes, round to nearest and stochastic: the reciprocal form against
    the interpret kernel, the dividing form against the eager jnp
    oracle, codes and scales bit for bit."""
    c = {c.name: c for c in cases.quant_cases("cpu")}[name]
    x, noise = c.x.numpy(), c.noise.numpy()
    for mode in ("narrow", "full"):
        for nz in (None, noise):
            jn = None if nz is None else jnp.asarray(nz)
            if reciprocal:
                wq, ws = quantize_rowwise_pallas(jnp.asarray(x), jn,
                                                 mode=mode, interpret=True)
            else:
                wq, ws = j_ref(jnp.asarray(x), jn, mode)
            q, s = tops.quantize_rowwise(
                c.x, None if nz is None else c.noise, mode,
                reciprocal=reciprocal)
            np.testing.assert_array_equal(bits(wq), bits(q))
            _scales_equal(ws, s.numpy())
            assert bool(s[5, 0].isnan()) and bool(s[6, 0].isinf())
            assert not q[5].any() and not q[9].any() and not q[10].any()
