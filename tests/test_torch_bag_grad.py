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

from repro.kernels.dequant_bag import autodiff as jad
from repro.kernels.dequant_bag.kernel import bag_grad_pallas
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
