"""Parity of the port's fused bag -> matmul with the JAX package, on the CPU.

On the CPU the port's ops take the plain version (``ref.py``), which the
CUDA kernel is held to bit for bit on the card (``chip_smoke.py``).  Here
the plain version is held bit for bit to the reference's Pallas kernel run
in interpret mode (int8 / bf16 / fp32 payloads, K = 1 and K > 1, dead
slots, B and H that no block divides).  Two comparisons are by tolerance,
``|d| <= 1e-6 * sum_{k,d} |rows * w3|``: ``scale_after`` (the interpret
kernel's scale-after epilogue is not the plain multiply-then-add at
every element) and the reference's unfused einsum, which sums in XLA's
order.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro.core import packed_store as jps
from repro.core import qat_store as jqs
from repro.core.tiers import TierConfig
from repro.kernels.bag_matmul.kernel import bag_matmul_pallas
from repro.kernels.bag_matmul.ops import packed_bag_matmul as j_packed_bm
from repro.kernels.bag_matmul.ref import bag_matmul_ref as j_bm_ref
from repro_torch.convert import packed_from_jax, to_tensor
from repro_torch.core import packed_store as tps
from repro_torch.kernels.bag_matmul import kernel as tkernel
from repro_torch.kernels.bag_matmul import ops as tops
from repro_torch.kernels.bag_matmul.ref import bag_matmul_ref, slot_rows


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).view(np.uint32)


def _inputs(dtype: str, v: int, d: int, b: int, k: int, h: int, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        payload = rng.integers(-128, 128, (v, d)).astype(np.int8)
    else:
        payload = (rng.standard_normal((v, d)) * 0.1).astype(np.float32)
    scales = (rng.random(v) * 0.01 + 1e-3).astype(np.float32)
    idx = rng.integers(0, v, (b, k)).astype(np.int32)
    w = rng.random((b, k)).astype(np.float32) + 0.5
    w[rng.random((b, k)) < 0.3] = 0.0                 # dead slots
    w3 = rng.standard_normal((k, d, h)).astype(np.float32)
    jpay = jnp.asarray(payload)
    if dtype == "bfloat16":
        jpay = jpay.astype(jnp.bfloat16)
    tpay = (to_tensor(np.asarray(jpay).view(np.uint16))
            if dtype == "bfloat16" else torch.from_numpy(payload))
    return jpay, tpay, scales, idx, w, w3


def _abs_terms(tpay, scales, idx, w, w3, scale_after=False) -> np.ndarray:
    """sum_{k,d} |rows[b,k,d] * w3[k,d,h]| in float64: (B, H)."""
    rows = slot_rows(tpay, torch.from_numpy(scales), torch.from_numpy(idx),
                     torch.from_numpy(w), scale_after).double()
    if scale_after:
        coeff = (torch.from_numpy(scales)[torch.from_numpy(idx).long()]
                 * torch.from_numpy(w)).double()
        rows = rows * coeff[..., None]
    return torch.einsum("bkd,kdh->bh", rows.abs(),
                        torch.from_numpy(w3).double().abs()).numpy()


def _within(want, got, terms, rel=1e-6):
    want = np.asarray(want, np.float64)
    got = got.detach().numpy().astype(np.float64)
    assert want.shape == got.shape
    assert np.all(np.abs(got - want) <= rel * terms + 1e-30)


# (V, D, B, K, H): K = 1 and K > 1; B = 7, 13 and H = 33, 70, 130 divide
# none of the reference's blocks (its grid pads them)
SHAPES = [(50, 8, 7, 1, 33), (60, 16, 13, 3, 70), (40, 5, 9, 4, 130)]


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("v,d,b,k,h", SHAPES)
def test_plain_bit_equal_to_pallas_interpret(dtype, v, d, b, k, h):
    jpay, tpay, scales, idx, w, w3 = _inputs(dtype, v, d, b, k, h)
    want = bag_matmul_pallas(jpay, jnp.asarray(scales), jnp.asarray(idx),
                             jnp.asarray(w), jnp.asarray(w3),
                             interpret=True)
    tkernel.reset_launches()
    got = tops.bag_matmul(tpay, torch.from_numpy(scales),
                          torch.from_numpy(idx), torch.from_numpy(w),
                          torch.from_numpy(w3))
    assert tkernel.total_launches() == 0            # CPU: plain version
    np.testing.assert_array_equal(bits(want), bits(got))
    # the unfused einsum oracle sums in another order: by tolerance
    oracle = j_bm_ref(jpay, jnp.asarray(scales), jnp.asarray(idx),
                      jnp.asarray(w), jnp.asarray(w3))
    _within(oracle, got, _abs_terms(tpay, scales, idx, w, w3))


@pytest.mark.parametrize("v,d,b,k,h", SHAPES[1:])
def test_scale_after_within_tolerance(v, d, b, k, h):
    jpay, tpay, scales, idx, w, w3 = _inputs("int8", v, d, b, k, h, seed=3)
    want = bag_matmul_pallas(jpay, jnp.asarray(scales), jnp.asarray(idx),
                             jnp.asarray(w), jnp.asarray(w3),
                             interpret=True, scale_after=True)
    got = bag_matmul_ref(tpay, torch.from_numpy(scales),
                         torch.from_numpy(idx), torch.from_numpy(w),
                         torch.from_numpy(w3), scale_after=True)
    _within(want, got, _abs_terms(tpay, scales, idx, w, w3, True))
    # the plain scale-before form computes the same function
    before = bag_matmul_ref(tpay, torch.from_numpy(scales),
                            torch.from_numpy(idx), torch.from_numpy(w),
                            torch.from_numpy(w3))
    _within(before.numpy(), got, _abs_terms(tpay, scales, idx, w, w3), 2e-6)


def test_unit_scales_equal_none():
    _, tpay, scales, idx, w, w3 = _inputs("float32", 60, 16, 13, 3, 70)
    ones = torch.ones(60)
    a = bag_matmul_ref(tpay, ones, torch.from_numpy(idx),
                       torch.from_numpy(w), torch.from_numpy(w3))
    b = bag_matmul_ref(tpay, None, torch.from_numpy(idx),
                       torch.from_numpy(w), torch.from_numpy(w3))
    np.testing.assert_array_equal(bits(a), bits(b))


@pytest.fixture(scope="module")
def mixed_store():
    """A smoke-size store with rows in all three tiers."""
    rng = np.random.default_rng(5)
    v, d = 600, 8
    table = (rng.standard_normal((v, d)) * 0.05).astype(np.float32)
    pri = (rng.random(v) * 2e5).astype(np.float32)
    cfg = jqs.FQuantConfig(tiers=TierConfig(5e4, 1.5e5), stochastic=False)
    store = jqs.QATStore(jnp.asarray(table), jnp.asarray(pri))
    store = store._replace(table=jqs.snap(
        store.table, jqs.current_tiers(store, cfg), cfg))
    packed = jps.pack(store, cfg)
    host = jps.PackedStore(*(np.asarray(x) for x in packed))
    host = host._replace(payload16=host.payload16.view(np.uint16))
    assert all(c > 50 for c in jps.live_counts(packed))
    return packed, packed_from_jax(host)


def test_packed_bag_matmul_matches_jax(mixed_store):
    jpacked, tpacked = mixed_store
    rng = np.random.default_rng(6)
    b, f, d, h = 11, 5, 8, 37
    idx = rng.integers(0, 600, (b, f)).astype(np.int32)
    w = rng.standard_normal((f * d, h)).astype(np.float32)
    got = tps.bag_matmul(tpacked, torch.from_numpy(idx), torch.from_numpy(w))
    # the reference's kernel path, one interpret-mode launch per tier
    want = j_packed_bm(jpacked, jnp.asarray(idx), jnp.asarray(w),
                       use_pallas=True, interpret=True)
    np.testing.assert_array_equal(bits(want), bits(got))
    # what the reference computes on the CPU by default: the einsum
    # branch (use_pallas=None under interpretation), by tolerance
    einsum = j_packed_bm(jpacked, jnp.asarray(idx), jnp.asarray(w))
    emb = tps.lookup(tpacked, torch.from_numpy(idx)).double()
    terms = torch.einsum("bkd,kdh->bh", emb.abs(),
                         torch.from_numpy(w).double().abs().reshape(
                             f, d, h)).numpy()
    _within(einsum, got, terms)


def test_as_w3_and_wrapper_checks():
    w = torch.zeros((12, 5))
    assert tops._as_w3(w, 3, 4).shape == (3, 4, 5)
    with pytest.raises(ValueError, match="K\\*D"):
        tops._as_w3(w, 5, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.bag_matmul_cuda(torch.zeros((4, 3), dtype=torch.int8), None,
                                torch.zeros((2, 1), dtype=torch.int32),
                                torch.ones((2, 1)), torch.zeros((1, 3, 5)))
