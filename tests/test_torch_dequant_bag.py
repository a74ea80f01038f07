"""Parity of the port's dequant-bag ops with the JAX package, on the CPU.

On the CPU the port's ops take the plain version (``ref.py``), which the
CUDA kernel is held to bit for bit on the card (``chip_smoke.py``).  Here
it is held bit for bit to the reference's Pallas kernel run in interpret
mode, as ``tests/test_kernels.py`` runs it, and to the jnp oracle.
"""

from __future__ import annotations

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro.core import packed_store as jps
from repro.core import qat_store as jqs
from repro.kernels.dequant_bag.kernel import dequant_bag_pallas
from repro.kernels.dequant_bag.ops import packed_bag_lookup as j_bag_lookup
from repro_torch.convert import packed_from_jax, to_tensor
from repro_torch.core import packed_store as tps
from repro_torch.kernels import cases
from repro_torch.kernels.dequant_bag import kernel as tkernel
from repro_torch.kernels.dequant_bag import ops as tops
from repro_torch.kernels.dequant_bag.ref import fma_f32


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    a = np.asarray(x)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _payload(dtype: str, v: int, d: int, rng) -> np.ndarray:
    if dtype == "int8":
        return rng.integers(-128, 128, (v, d)).astype(np.int8)
    x = (rng.standard_normal((v, d)) * 0.1).astype(np.float32)
    if dtype == "bfloat16":
        return np.asarray(jnp.asarray(x, jnp.bfloat16)).view(np.uint16)
    return x


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("v,d,b,k", [(64, 16, 7, 4), (40, 9, 5, 1)])
def test_dequant_bag_bit_equal_to_pallas_interpret(dtype, v, d, b, k):
    rng = np.random.default_rng(0)
    payload = _payload(dtype, v, d, rng)
    scales = (rng.random(v) * 0.01).astype(np.float32)
    idx = rng.integers(0, v, (b, k)).astype(np.int32)
    w = rng.random((b, k)).astype(np.float32)
    w[rng.random((b, k)) < 0.4] = 0.0             # masked slots
    jpay = jnp.asarray(payload).view(jnp.bfloat16) \
        if dtype == "bfloat16" else jnp.asarray(payload)
    want = dequant_bag_pallas(jpay, jnp.asarray(scales), jnp.asarray(idx),
                              jnp.asarray(w), interpret=True)
    tkernel.reset_launches()
    got = tops.dequant_bag(to_tensor(payload), torch.from_numpy(scales),
                           torch.from_numpy(idx), torch.from_numpy(w))
    np.testing.assert_array_equal(bits(want), bits(got))
    assert tkernel.total_launches() == 0      # CPU tensors: plain version


def _packed_pair(v: int = 96, d: int = 16):
    """A reference PackedStore with all three tiers live, and its port."""
    rng = np.random.default_rng(2)
    cfg = jqs.FQuantConfig(stochastic=False)
    table = (rng.standard_normal((v, d)) * 0.05).astype(np.float32)
    pri = np.repeat(np.array([0.0, 1e4, 1e6], np.float32), v // 3)
    rng.shuffle(pri)
    st = jqs.QATStore(jnp.asarray(table), jnp.asarray(pri))
    st = st._replace(table=jqs.snap(st.table, jqs.current_tiers(st, cfg),
                                    cfg))
    jpacked = jps.pack(st, cfg)
    host = jps.PackedStore(*(np.asarray(x) for x in jpacked))
    host = host._replace(payload16=host.payload16.view(np.uint16))
    return jpacked, packed_from_jax(host)


@pytest.mark.parametrize("shape", [(17,), (6, 7), (2, 3, 4)])
def test_packed_lookup_fused_bit_equal_to_jax_lookup(shape):
    jpacked, tpacked = _packed_pair()
    idx = np.random.default_rng(3).integers(0, 96, shape).astype(np.int32)
    want = jps.lookup(jpacked, jnp.asarray(idx))
    got = tops.packed_lookup_fused(tpacked, torch.from_numpy(idx))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(bits(want), bits(got))
    np.testing.assert_array_equal(bits(want), bits(
        tps.lookup(tpacked, torch.from_numpy(idx))))
    np.testing.assert_array_equal(bits(want), bits(
        tps.lookup_fused(tpacked, torch.from_numpy(idx))))


def test_packed_bag_lookup_k4_masked_bit_equal_to_pallas_interpret():
    jpacked, tpacked = _packed_pair()
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 96, (9, 4)).astype(np.int32)
    w = rng.random((9, 4)).astype(np.float32)
    w[rng.random((9, 4)) < 0.3] = 0.0
    want = j_bag_lookup(jpacked, jnp.asarray(idx), jnp.asarray(w),
                        use_pallas=True, interpret=True)
    got = tops.packed_bag_lookup(tpacked, torch.from_numpy(idx),
                                 torch.from_numpy(w))
    np.testing.assert_array_equal(bits(want), bits(got))


def test_cuda_wrapper_refuses_cpu_tensors(monkeypatch):
    """The wrapper refuses a CPU tensor, and the op sends every tensor that
    is neither on the CPU nor on ``meta`` to it (a meta tensor stands in
    for one once the dry run's meta branch is patched away; unpatched, the
    op on meta returns the (B, D) shape and launches nothing)."""
    from repro_torch.core import op_counter
    rng = np.random.default_rng(5)
    payload = torch.from_numpy(_payload("int8", 8, 16, rng))
    idx = torch.zeros((2, 1), dtype=torch.int32)
    w = torch.ones((2, 1))
    tkernel.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.dequant_bag_cuda(payload, torch.ones(8), idx, w)
    out = tops.dequant_bag(payload.to("meta"), None, idx.to("meta"),
                           w.to("meta"))
    assert out.device.type == "meta" and out.shape == (2, 16)
    monkeypatch.setattr(op_counter, "on_meta", lambda t: False)
    with pytest.raises(ValueError, match="CUDA"):      # not a CPU tensor
        tops.dequant_bag(payload.to("meta"), None, idx.to("meta"),
                         w.to("meta"))
    assert tkernel.total_launches() == 0


def _fma_exact(a: np.float32, b: np.float32, c: np.float32) -> np.float32:
    """fp32 fma by exact rationals: the fp32 nearest to a*b + c, ties to
    even, found among the neighbours of a float32 near it."""
    x = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda y: (abs(Fraction(float(y)) - x),
                                     int(np.array(y).view(np.uint32)) & 1))


def test_fma_f32_is_the_exact_fp32_fma():
    rng = np.random.default_rng(6)
    a = (rng.standard_normal(400) * 10.0 ** rng.integers(-8, 8, 400)
         ).astype(np.float32)
    b = rng.standard_normal(400).astype(np.float32)
    c = (rng.standard_normal(400) * 10.0 ** rng.integers(-8, 8, 400)
         ).astype(np.float32)
    c[:100] = -(a[:100] * b[:100])        # near-total cancellation
    c[100:150] = 0.0
    got = fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                  torch.from_numpy(c)).numpy()
    want = np.array([_fma_exact(*t) for t in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _to_jax(t: torch.Tensor):
    """A CPU tensor as a jax array of the same dtype (bf16 through its
    bits)."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _nan_bits_equal(want, got) -> None:
    """Bit for bit, except that a NaN equals any NaN (its payload bits
    are the arithmetic's)."""
    w, g = np.asarray(want), got.numpy()
    np.testing.assert_array_equal(np.isnan(w), np.isnan(g))
    np.testing.assert_array_equal(bits(np.where(np.isnan(w), 0, w)),
                                  bits(np.where(np.isnan(g), 0, g)))


@pytest.mark.parametrize("name", cases.GATHER_CASE_NAMES)
def test_plain_bit_equal_to_pallas_on_gather_cases(name):
    """The kernel's cases (every dtype at D 1/10/32/33/64/128, K 1/8/40,
    B of 61/37/64, 30% zero weights, a NaN row under zero weights,
    payload views off 16-byte alignment): the plain version against the
    reference kernel in interpret mode, bit for bit, and finite."""
    c = {c.name: c for c in cases.gather_cases("cpu")}[name]
    scales = (torch.ones(c.payload.shape[0]) if c.scales is None
              else c.scales)
    want = dequant_bag_pallas(_to_jax(c.payload), _to_jax(scales),
                              _to_jax(c.indices), _to_jax(c.weights),
                              interpret=True)
    tkernel.reset_launches()
    got = tops.dequant_bag(c.payload, c.scales, c.indices, c.weights)
    assert tkernel.total_launches() == 0      # CPU tensors: plain version
    assert bool(torch.isfinite(got).all())
    np.testing.assert_array_equal(bits(want), bits(got))


@pytest.mark.parametrize("name", cases.TIERED_CASE_NAMES)
def test_packed_bag_lookup_bit_equal_to_pallas_on_tiered_cases(name):
    """The tiered entry's cases (int32 and int64 ids, K 1/8/40 with zero
    weights, fp16 half tiers, D 10 and 33, an empty int8 and an empty
    fp32 tier, NaN and inf weights): the plain composition against the
    reference's packed_bag_lookup with its kernel in interpret mode, bit
    for bit; a non-finite weight makes its bag NaN in every column."""
    c = {c.name: c for c in cases.tiered_cases("cpu")}[name]
    packed = tps.PackedStore(*c.leaves)
    jpacked = jps.PackedStore(*(_to_jax(x) for x in c.leaves))
    w = c.weights
    want = j_bag_lookup(jpacked, jnp.asarray(c.ids.numpy()),
                        None if w is None else _to_jax(w), use_pallas=True,
                        interpret=True)
    tkernel.reset_launches()
    got = tops.packed_bag_lookup(packed, c.ids, w)
    assert tkernel.total_launches() == 0
    _nan_bits_equal(want, got)
    bad = (torch.zeros(c.ids.shape[0], dtype=torch.bool) if w is None
           else ~torch.isfinite(w).all(1))
    assert bool(torch.isnan(got[bad]).all())
    assert bool(torch.isfinite(got[~bad]).all())
    assert int(bad.sum()) == (3 if name.startswith("nan") else 0)
    if w is None and c.ids.shape[1] == 1:
        np.testing.assert_array_equal(bits(got), bits(
            tps.lookup(packed, c.ids[:, 0])))


def test_tiered_wrapper_refuses_cpu_tensors():
    c = cases.tiered_cases("cpu")[0]
    tkernel.reset_launches()
    indirect, leaves = c.leaves[5], c.leaves[:5]
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.dequant_bag_tiered_cuda(indirect, *leaves, c.ids)
    assert tkernel.total_launches() == 0
