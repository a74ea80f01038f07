"""The port's hashed gather against the JAX package, on the CPU.

Same numpy inputs through both packages.  Bit for bit: ``hash_slots``
and ``slot_plan``; the plain ``hashed_gather`` against the reference's
Pallas kernel in interpret mode (XLA on the CPU fuses its
``out += (row * s) * w`` into one FMA, which the port's kernel and plain
version write out), and against the reference's jnp oracle at K = 1 with
+-1 signs (every product exact); the training twin's pool gradient
against the reference's ``custom_vjp`` with the interpret-mode kernels.
Within a tolerance: the jnp oracle on weighted bags, which sums rounded
terms (``|d| <= 1e-6 * sum |terms|``), and the coefficient gradient
(``1e-6 * sum |terms|``: an einsum, reduced in another order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro.kernels.hashed_gather import autodiff as jad
from repro.kernels.hashed_gather import ops as jops
from repro.kernels.hashed_gather.kernel import hashed_gather_pallas
from repro.kernels.hashed_gather.ref import hash_slots as j_hash_slots
from repro.kernels.hashed_gather.ref import hashed_gather_ref as j_ref
from repro_torch import kernels as tkernels
from repro_torch.kernels import cases
from repro_torch.kernels.hashed_gather import autodiff as tad
from repro_torch.kernels.hashed_gather import kernel as tkernel
from repro_torch.kernels.hashed_gather import ops as tops
from repro_torch.kernels.hashed_gather import ref as tref


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    a = np.asarray(x)
    return a.view({1: np.uint8, 4: np.uint32}[a.dtype.itemsize])


def _pool(rng, s, z, dtype):
    if dtype == "int8":
        pool = rng.integers(-128, 128, (s, z)).astype(np.int8)
        scales = (rng.random(s) * 0.02 + 1e-3).astype(np.float32)
    else:
        pool = (rng.standard_normal((s, z)) * 0.1).astype(np.float32)
        scales = np.ones(s, np.float32)
    return pool, scales


@pytest.mark.parametrize("seed", [0, 7, 123456789])
@pytest.mark.parametrize("num_slots", [2048, 1797, 3])
def test_hash_slots_bit_equal(seed, num_slots):
    rng = np.random.default_rng(seed % 1000)
    ids = np.concatenate([
        rng.integers(0, 2 ** 31 - 1, 500),
        np.arange(2 ** 31 - 40, 2 ** 31, dtype=np.int64),
        np.arange(40)]).astype(np.int32).reshape(-1, 4)
    js, jg = j_hash_slots(jnp.asarray(ids), num_chunks=3, num_hashes=2,
                          num_slots=num_slots, seed=seed)
    ts, tg = tref.hash_slots(torch.from_numpy(ids), num_chunks=3,
                             num_hashes=2, num_slots=num_slots, seed=seed)
    assert ts.dtype == torch.int32 and tg.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(bits(jg), bits(tg))
    assert set(np.unique(tg.numpy())) <= {-1.0, 1.0}


@pytest.mark.parametrize("weighted", [False, True])
def test_slot_plan_bit_equal(weighted):
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 10 ** 6, (33, 5)).astype(np.int32)
    w = rng.random((33, 5)).astype(np.float32) if weighted else None
    js, jc = jops.slot_plan(jnp.asarray(idx),
                            None if w is None else jnp.asarray(w),
                            num_chunks=4, num_hashes=2, num_slots=5003,
                            seed=3)
    ts, tc = tops.slot_plan(torch.from_numpy(idx),
                            None if w is None else torch.from_numpy(w),
                            num_chunks=4, num_hashes=2, num_slots=5003,
                            seed=3)
    assert ts.shape == (33, 4 * 5 * 2) and ts.is_contiguous()
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(bits(jc), bits(tc))


def _bag_case(rng, b, k, c, nh, s, z, dtype, zero_frac=0.3):
    pool, scales = _pool(rng, s, z, dtype)
    idx = rng.integers(0, 10 ** 5, (b, k)).astype(np.int32)
    w = rng.standard_normal((b, k)).astype(np.float32)
    w[rng.random((b, k)) < zero_frac] = 0.0
    slots, coeff = jops.slot_plan(jnp.asarray(idx), jnp.asarray(w),
                                  num_chunks=c, num_hashes=nh, num_slots=s)
    return pool, scales, np.array(slots), np.array(coeff)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("b,k,c,z", [(13, 5, 4, 8), (7, 3, 2, 5),
                                     (9, 1, 3, 4)])
def test_plain_bit_equal_to_interpret_kernel(dtype, b, k, c, z):
    """Weighted K > 1 bags with 30% zero coefficients, int8 and fp32
    pools, a B that no kernel block divides."""
    rng = np.random.default_rng(b * 31 + k)
    pool, scales, slots, coeff = _bag_case(rng, b, k, c, 2, 211, z, dtype)
    want = hashed_gather_pallas(jnp.asarray(pool), jnp.asarray(scales),
                                jnp.asarray(slots), jnp.asarray(coeff),
                                num_chunks=c, interpret=True)
    tkernels.reset_launches()
    got = tops.hashed_gather(torch.from_numpy(pool),
                             torch.from_numpy(scales),
                             torch.from_numpy(slots),
                             torch.from_numpy(coeff), num_chunks=c)
    assert tkernel.total_launches() == 0       # CPU tensors: plain version
    np.testing.assert_array_equal(bits(want), bits(got))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_plain_equals_jnp_oracle_at_k1_and_within_tol_weighted(dtype):
    rng = np.random.default_rng(5)
    pool, scales = _pool(rng, 307, 8, dtype)
    ids = rng.integers(0, 10 ** 6, (64, 1)).astype(np.int32)
    slots, coeff = jops.slot_plan(jnp.asarray(ids), None, num_chunks=4,
                                  num_hashes=2, num_slots=307)
    want = j_ref(jnp.asarray(pool), jnp.asarray(scales), slots, coeff,
                 num_chunks=4)
    got = tops.hashed_gather(torch.from_numpy(pool),
                             torch.from_numpy(scales),
                             torch.from_numpy(np.asarray(slots)),
                             torch.from_numpy(np.asarray(coeff)),
                             num_chunks=4)
    np.testing.assert_array_equal(bits(want), bits(got))

    pool, scales, slots, coeff = _bag_case(rng, 40, 5, 4, 2, 307, 8, dtype)
    want = np.asarray(j_ref(jnp.asarray(pool), jnp.asarray(scales),
                            jnp.asarray(slots), jnp.asarray(coeff),
                            num_chunks=4), np.float64)
    got = tops.hashed_gather(torch.from_numpy(pool),
                             torch.from_numpy(scales),
                             torch.from_numpy(slots),
                             torch.from_numpy(coeff), num_chunks=4)
    terms = np.abs(pool[slots].astype(np.float64)
                   * scales[slots][..., None] * coeff[..., None])
    mag = terms.reshape(40, 4, 10, 8).sum(2).reshape(40, 32)
    assert np.all(np.abs(got.numpy() - want) <= 1e-6 * mag)
    assert not np.array_equal(bits(want.astype(np.float32)), bits(got))


def test_empty_bags_and_zero_coefficients_give_exact_zeros():
    rng = np.random.default_rng(6)
    pool, scales = _pool(rng, 50, 4, "int8")
    slots = rng.integers(0, 50, (5, 6)).astype(np.int32)
    coeff = np.zeros((5, 6), np.float32)
    got = tops.hashed_gather(torch.from_numpy(pool), torch.from_numpy(scales),
                             torch.from_numpy(slots),
                             torch.from_numpy(coeff), num_chunks=2)
    assert got.shape == (5, 8)
    np.testing.assert_array_equal(bits(got), np.zeros((5, 8), np.uint32))
    none = tops.hashed_gather(torch.from_numpy(pool), None,
                              torch.zeros((0, 6), dtype=torch.int32),
                              torch.zeros((0, 6)), num_chunks=2)
    assert none.shape == (0, 8)
    slots, coeff = tops.slot_plan(torch.zeros((0, 3), dtype=torch.int32),
                                  None, num_chunks=2, num_hashes=2,
                                  num_slots=50)
    assert slots.shape == coeff.shape == (0, 12)


def test_hashed_grad_ref_matches_segment_sum_at_sign_coefficients():
    rng = np.random.default_rng(9)
    g = rng.standard_normal((30, 16)).astype(np.float32)
    ids = rng.integers(0, 1000, (30, 1)).astype(np.int32)
    slots, coeff = jops.slot_plan(jnp.asarray(ids), None, num_chunks=2,
                                  num_hashes=2, num_slots=17)
    from repro.kernels.hashed_gather.ref import hashed_grad_ref as j_grad
    want = j_grad(jnp.asarray(g), None, slots, coeff, 17, num_chunks=2)
    got = tref.hashed_grad_ref(torch.from_numpy(g), None,
                               torch.from_numpy(np.asarray(slots)),
                               torch.from_numpy(np.asarray(coeff)), 17,
                               num_chunks=2)
    np.testing.assert_array_equal(bits(want), bits(got))


@pytest.mark.parametrize("k", [1, 3])
def test_training_twin_gradients_match_jax_custom_vjp(k):
    """Pool gradient bit for bit against the reference's ``custom_vjp``
    with the interpret-mode kernels; coefficient (weights) gradient
    within 1e-6 of sum |terms|."""
    rng = np.random.default_rng(10 + k)
    s, z, c, b = 97, 4, 3, 21
    pool = (rng.standard_normal((s, z)) * 0.1).astype(np.float32)
    idx = rng.integers(0, 5000, (b, k)).astype(np.int32)
    w = rng.random((b, k)).astype(np.float32)
    w[rng.random((b, k)) < 0.3] = 0.0
    ct = rng.standard_normal((b, c * z)).astype(np.float32)

    def jloss(p, wt):
        out = jad.hashed_bag_lookup_train(p, jnp.asarray(idx), wt,
                                          num_chunks=c, num_hashes=2,
                                          use_pallas=True, interpret=True)
        return jnp.sum(out * ct), out
    (_, jout), (jgp, jgw) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(pool),
                                             jnp.asarray(w))

    tp = torch.from_numpy(pool.copy()).requires_grad_(True)
    tw = torch.from_numpy(w.copy()).requires_grad_(True)
    out = tad.hashed_bag_lookup_train(tp, torch.from_numpy(idx), tw,
                                      num_chunks=c, num_hashes=2)
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_array_equal(bits(jout), bits(out))
    np.testing.assert_array_equal(bits(jgp), bits(tp.grad))
    slots, _ = tops.slot_plan(torch.from_numpy(idx), None, num_chunks=c,
                              num_hashes=2, num_slots=s)
    rows = np.abs(pool[slots.numpy()].reshape(b, c, k, 2, z))
    mag = (rows * np.abs(ct).reshape(b, c, 1, 1, z)).sum((1, 3, 4))
    assert np.all(np.abs(tw.grad.numpy() - np.asarray(jgw))
                  <= 1e-6 * mag + 1e-30)


def test_lookup_train_is_the_k1_bag():
    rng = np.random.default_rng(12)
    pool = torch.from_numpy(rng.standard_normal((31, 4)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 900, (6, 5)).astype(np.int32))
    out = tad.hashed_lookup_train(pool, idx, num_chunks=2, num_hashes=2)
    assert out.shape == (6, 5, 8)
    slots, coeff = tops.slot_plan(idx.reshape(-1, 1), None, num_chunks=2,
                                  num_hashes=2, num_slots=31)
    want = tref.hashed_gather_ref(pool, None, slots, coeff, num_chunks=2)
    np.testing.assert_array_equal(bits(want.reshape(6, 5, 8)), bits(out))


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.hashed_gather_cuda(torch.zeros((4, 8)), None,
                                   torch.zeros((2, 2), dtype=torch.int32),
                                   torch.zeros((2, 2)), num_chunks=1)


@pytest.mark.parametrize("name", cases.HASH_CASE_NAMES)
def test_ids_entry_plain_bit_equal_to_interpret_kernel_on_cases(name):
    """The hashed cases (Z 4/5/8, T 1/2/6, int8 and fp32 pools of S rows
    that are no power of two, seeds 0 and 7, weighted K = 3 with zero
    weights, int64 ids past 2^32): the ids op's plain version and the
    plan op on the port's slot plan, against the reference's slot plan
    through its kernel in interpret mode, bit for bit."""
    c = {c.name: c for c in cases.hashed_cases("cpu")}[name]
    s = c.pool.shape[0]
    scales = c.scales if c.scales is not None else torch.ones(s)
    low = (c.ids.to(torch.int64) & 0xFFFFFFFF).numpy().astype(np.uint32)
    w = None if c.weights is None else c.weights.numpy()
    js, jc = jops.slot_plan(jnp.asarray(low),
                            None if w is None else jnp.asarray(w),
                            num_chunks=c.num_chunks,
                            num_hashes=c.num_hashes, num_slots=s,
                            seed=c.seed)
    want = hashed_gather_pallas(jnp.asarray(c.pool.numpy()),
                                jnp.asarray(scales.numpy()), js, jc,
                                num_chunks=c.num_chunks, interpret=True)
    tkernels.reset_launches()
    got = tops.hashed_gather_ids(c.pool, c.scales, c.ids, c.weights,
                                 num_chunks=c.num_chunks,
                                 num_hashes=c.num_hashes, seed=c.seed)
    slots, coeff = tops.slot_plan(c.ids, c.weights, num_chunks=c.num_chunks,
                                  num_hashes=c.num_hashes, num_slots=s,
                                  seed=c.seed)
    plan = tops.hashed_gather(c.pool, c.scales, slots, coeff,
                              num_chunks=c.num_chunks)
    assert tkernel.total_launches() == 0       # CPU tensors: plain version
    np.testing.assert_array_equal(np.asarray(js), slots.numpy())
    np.testing.assert_array_equal(bits(jc), bits(coeff))
    np.testing.assert_array_equal(bits(want), bits(got))
    np.testing.assert_array_equal(bits(want), bits(plan))


def test_ids_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.hashed_gather_ids_cuda(torch.zeros((4, 8)), None,
                                       torch.zeros((2, 1),
                                                   dtype=torch.int64),
                                       None, num_chunks=1, num_hashes=2)
