"""Parity of the port's scatter-add backward with the JAX package, on the CPU.

On the CPU ``bag_grad`` takes its plain version (``ref.bag_grad_ref``),
which the CUDA kernel is held to bit for bit on the card
(``chip_smoke.py``, ``test_torch_cuda.py``).  Here it is held bit for bit
to the reference's Pallas kernel run in interpret mode, as the
reference's own tests run it; the autograd twin of ``lookup_train`` is
held to ``jax.grad`` through the reference's ``lookup_train``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro.kernels.dequant_bag import autodiff as jad
from repro.kernels.dequant_bag.kernel import bag_grad_pallas
from repro.kernels.dequant_bag.ref import bag_grad_ref as j_bag_grad_ref
from repro_torch.kernels import cases
from repro_torch.kernels.dequant_bag import autodiff as tad
from repro_torch.kernels.dequant_bag import kernel as tkernel
from repro_torch.kernels.dequant_bag import ops as tops
from repro_torch.kernels.dequant_bag.ref import bag_grad_ref


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).view(np.uint32)


def _case(seed, v, d, b, k, masked, scaled):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((b, d)).astype(np.float32)
    idx = rng.integers(0, v, (b, k)).astype(np.int32)
    w = (rng.random((b, k)) * 2).astype(np.float32)
    if masked:
        w[rng.random((b, k)) < 0.4] = 0.0
    s = (rng.random(v) * 3).astype(np.float32) if scaled else None
    return g, s, idx, w


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("v", [5, 200], ids=["dup_rows", "sparse_rows"])
def test_bag_grad_ref_bit_equal_to_pallas_interpret(k, scaled, masked, v):
    g, s, idx, w = _case(k * 7 + v, v, 16, 13, k, masked, scaled)
    want = bag_grad_pallas(jnp.asarray(g),
                           None if s is None else jnp.asarray(s),
                           jnp.asarray(idx), jnp.asarray(w), v,
                           interpret=True)
    tkernel.reset_launches()
    got = tops.bag_grad(torch.from_numpy(g),
                        None if s is None else torch.from_numpy(s),
                        torch.from_numpy(idx), torch.from_numpy(w), v)
    assert tkernel.bag_grad_launches["float32"] == 0     # CPU: plain
    assert got.shape == (v, 16)
    np.testing.assert_array_equal(bits(got), bits(want))


def test_bag_grad_ref_empty_and_all_masked():
    g = torch.zeros((0, 8))
    idx = torch.zeros((0, 2), dtype=torch.int32)
    out = bag_grad_ref(g, None, idx, None, 6)
    assert out.shape == (6, 8) and not out.any()
    g = torch.ones((3, 8))
    idx = torch.tensor([[1, 2], [2, 2], [5, 0]], dtype=torch.int32)
    out = bag_grad_ref(g, None, idx, torch.zeros((3, 2)), 6)
    assert not out.any()


def test_bag_grad_cuda_refuses_cpu_tensors():
    g = torch.zeros((2, 4))
    idx = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.bag_grad_cuda(g, idx, torch.ones((2, 1)),
                              torch.zeros((3, 4)))


@pytest.mark.parametrize("v", [6, 300], ids=["dup_rows", "sparse_rows"])
def test_lookup_train_grad_bit_equal_to_jax(v):
    rng = np.random.default_rng(v)
    table = (rng.standard_normal((v, 16)) * 0.1).astype(np.float32)
    idx = rng.integers(0, v, (24, 5)).astype(np.int32)
    cot = rng.standard_normal((24, 5, 16)).astype(np.float32)

    def jloss(t):
        return jnp.sum(jad.lookup_train(t, jnp.asarray(idx), use_pallas=True)
                       * cot)

    want_out = jad.lookup_train(jnp.asarray(table), jnp.asarray(idx),
                                use_pallas=True)
    want = jax.grad(jloss)(jnp.asarray(table))

    t = torch.from_numpy(table).requires_grad_()
    out = tad.lookup_train(t, torch.from_numpy(idx))
    np.testing.assert_array_equal(bits(out), bits(want_out))
    np.testing.assert_array_equal(bits(out), bits(table[idx]))
    (got,) = torch.autograd.grad(out, t, torch.from_numpy(cot))
    np.testing.assert_array_equal(bits(got), bits(want))


def test_bag_lookup_train_weight_grads_match_jax():
    rng = np.random.default_rng(5)
    v, b, k, d = 9, 10, 4, 8
    table = (rng.standard_normal((v, d)) * 0.1).astype(np.float32)
    idx = rng.integers(0, v, (b, k)).astype(np.int32)
    w = rng.random((b, k)).astype(np.float32)
    w[rng.random((b, k)) < 0.3] = 0.0
    cot = rng.standard_normal((b, d)).astype(np.float32)

    def jloss(t, ww):
        return jnp.sum(jad.bag_lookup_train(t, jnp.asarray(idx), ww,
                                            use_pallas=True) * cot)

    jt, jw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(table),
                                             jnp.asarray(w))
    t = torch.from_numpy(table).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = tad.bag_lookup_train(t, torch.from_numpy(idx), tw)
    gt, gw = torch.autograd.grad(out, (t, tw), torch.from_numpy(cot))
    # the table cotangent is the bag_grad kernel's: bit for bit
    np.testing.assert_array_equal(bits(gt), bits(jt))
    # the weight cotangent is a length-8 dot; XLA and torch sum it in
    # different orders
    np.testing.assert_allclose(gw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)


def _hot_row_case():
    """Row 0 holds 2,000 slots among 39 short rows, K = 2, 30% zero
    weights; one bag's weights are both 0 and its cotangent is NaN."""
    rng = np.random.default_rng(16)
    v, d, k = 40, 8, 2
    lengths = [2000] + [int(x) for x in rng.integers(1, 30, v - 1)]
    lengths[1] += sum(lengths) % k
    rows = np.repeat(np.arange(v), lengths)
    rng.shuffle(rows)
    idx = rows.reshape(-1, k).astype(np.int32)
    b = idx.shape[0]
    g = rng.standard_normal((b, d)).astype(np.float32)
    w = (rng.random((b, k)) + 0.5).astype(np.float32)
    w[rng.random((b, k)) < 0.3] = 0.0
    nan_bag = int(np.nonzero(idx[:, 0] == 0)[0][0])
    w[nan_bag] = 0.0
    g[nan_bag] = np.nan
    return g, idx, w, v, nan_bag


def test_bag_grad_ref_hot_row_matches_jax_plain_reference():
    g, idx, w, v, nan_bag = _hot_row_case()
    got = bag_grad_ref(torch.from_numpy(g), None, torch.from_numpy(idx),
                       torch.from_numpy(w), v).numpy()
    # zero weights skip their slots, as the reference's Pallas kernel
    # does: the NaN cotangent never reaches a row
    assert np.isfinite(got).all()
    # the reference's plain version multiplies it by 0 instead: NaN rows
    want_nan = np.asarray(j_bag_grad_ref(jnp.asarray(g), None,
                                         jnp.asarray(idx), jnp.asarray(w), v))
    assert np.isnan(want_nan[np.unique(idx[nan_bag])]).all()
    # with that cotangent zeroed, the two sum the same n products of a
    # row in different orders: the port as one FMA chain ((n - 1)
    # roundings), the reference as rounded products summed by XLA (at
    # most 2n - 1 roundings); each rounding is within eps/2 of the sum of
    # |c g| so far, hence |got - want| <= 2 n eps sum |c g|
    g0 = g.copy()
    g0[nan_bag] = 0.0
    want = np.asarray(j_bag_grad_ref(jnp.asarray(g0), None, jnp.asarray(idx),
                                     jnp.asarray(w), v))
    terms = np.abs(w.reshape(-1, 1) * np.repeat(g0, idx.shape[1], axis=0))
    absum = np.zeros((v, g.shape[1]))
    np.add.at(absum, idx.reshape(-1), terms)
    n = np.bincount(idx.reshape(-1), minlength=v)[:, None]
    tol = 2 * n * np.finfo(np.float32).eps * absum
    assert n.max() == 2000 and (np.abs(got - want) <= tol).all()
    got0 = bag_grad_ref(torch.from_numpy(g0), None, torch.from_numpy(idx),
                        torch.from_numpy(w), v).numpy()
    np.testing.assert_array_equal(bits(got0), bits(got))


@pytest.mark.parametrize("k", [1, 2, 5])
def test_plan_slots_groups_each_row_in_bk_order(k):
    rng = np.random.default_rng(k)
    idx = torch.from_numpy(rng.integers(0, 30, (200, k)).astype(np.int32))
    plan = tkernel.plan_slots(idx)
    flat = idx.reshape(-1)
    assert plan.rows.dtype == torch.int32 and plan.slots.dtype == torch.int64
    # every slot once, its row beside it, the rows sorted
    assert torch.equal(torch.sort(plan.slots).values,
                       torch.arange(flat.numel()))
    assert torch.equal(plan.rows, flat[plan.slots])
    assert bool((plan.rows[1:] >= plan.rows[:-1]).all())
    # within a row the slots keep their (b, k) order
    same = plan.rows[1:] == plan.rows[:-1]
    assert bool((plan.slots[1:][same] > plan.slots[:-1][same]).all())
    # the plain version needs no grouping: a plan changes nothing there
    g = torch.from_numpy(rng.standard_normal((200, 8)).astype(np.float32))
    w = torch.from_numpy(rng.random((200, k)).astype(np.float32))
    tkernel.reset_launches()
    with_plan = tops.bag_grad(g, None, idx, w, 30, plan=plan)
    assert tkernel.bag_grad_launches["float32"] == 0
    np.testing.assert_array_equal(bits(with_plan),
                                  bits(tops.bag_grad(g, None, idx, w, 30)))


def test_card_check_cases_cover_the_schedules():
    heavy = tkernel.HEAVY_RUN
    by_name = {c.name: c for c in cases.bag_grad_cases(torch.device("cpu"),
                                                       heavy)}
    assert by_name["one_row"].indices.shape == (65_536, 1)
    assert set(torch.unique(by_name["one_row"].indices).tolist()) == {3}
    for d in (64, 8):
        c = by_name[f"threshold_d{d}"]
        runs = set(torch.bincount(c.indices.reshape(-1).long()).tolist())
        assert {heavy - 1, heavy, heavy + 1, 16 * heavy,
                16 * heavy + 1} <= runs
        assert c.g.shape[1] == d
    c = by_name["zeros_nan"]
    nan_bags = torch.isnan(c.g).any(1)
    assert int(nan_bags.sum()) == 1 and not c.coeff[nan_bags].any()
    assert int(torch.bincount(c.indices.reshape(-1).long()).max()) == 3000
    assert float((c.coeff == 0).float().mean()) > 0.2
    for d in (1, 8, 10, 64, 128):
        c = by_name[f"misaligned_d{d}"]
        assert c.g.shape[1] == d and c.g.is_contiguous()
        assert c.g.data_ptr() % 16 and c.out.data_ptr() % 16
    shapes = [tuple(x.shape[i] for x, i in ((m.indices, 0), (m.indices, 1),
                                             (m.payload, 1), (m.w3, 2)))
              for m in cases.bag_matmul_cases(torch.device("cpu"),
                                              torch.int8)]
    for axis, values in enumerate(((1, 31, 512, 513), (1, 39, 40),
                                   (1, 10, 32, 384), (1, 63, 400, 1024))):
        assert set(values) <= {s_[axis] for s_ in shapes}
    dead = cases.bag_matmul_cases(torch.device("cpu"), torch.float32)[-1]
    assert not dead.weights[:, 2].any() and not dead.weights[:, 5].any()
    assert torch.isnan(dead.w3[5]).any()
