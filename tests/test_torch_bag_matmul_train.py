"""The fused head's training twin (``kernels.bag_matmul.bag_matmul_train``)
beside the reference's, on the CPU.

B 6, K 3, D 8, H 16, V 50 with repeated indices (one row in several
slots and bags).  The forward is the port's ``bag_matmul`` bit for bit
and within 1e-6 of the reference's ``bag_matmul_train(use_pallas=False)``;
the gradients of the table, the slot weights and w3 are within 1e-5
relative of ``jax.grad`` of the reference.  On the card the forward is
the ``bag_matmul.cu`` kernel and the table's gradient the ``bag_grad.cu``
kernel (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 20(d)).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro.kernels.bag_matmul import bag_matmul_train as j_bmt
from repro_torch.kernels.bag_matmul import bag_matmul_train
from repro_torch.kernels.bag_matmul.ops import bag_matmul

B, K, D, H, V = 6, 3, 8, 16, 50


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    table = (rng.standard_normal((V, D)) * 0.5).astype(np.float32)
    idx = rng.integers(0, 7, (B, K)).astype(np.int32)     # many repeats
    idx[0] = idx[1] = (3, 3, 5)
    w = (rng.random((B, K)) + 0.25).astype(np.float32)
    w3 = rng.standard_normal((K, D, H)).astype(np.float32)
    r = rng.standard_normal((B, H)).astype(np.float32)   # the cotangent
    return table, idx, w, w3, r


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("w_2d", [False, True])
def test_forward_equals_bag_matmul_and_the_reference(w_2d):
    table, idx, w, w3, _ = _inputs()
    tw = torch.from_numpy(w3.reshape(K * D, H) if w_2d else w3)
    out = bag_matmul_train(torch.from_numpy(table), torch.from_numpy(idx),
                           tw, torch.from_numpy(w))
    plain = bag_matmul(torch.from_numpy(table), None, torch.from_numpy(idx),
                       torch.from_numpy(w), torch.from_numpy(w3))
    assert torch.equal(out.view(torch.int32), plain.view(torch.int32))
    want = j_bmt(jnp.asarray(table), jnp.asarray(idx),
                 jnp.asarray(w3.reshape(K * D, H) if w_2d else w3),
                 jnp.asarray(w), use_pallas=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6 * max(1.0, float(
                                   np.abs(np.asarray(want)).max())))


def test_gradients_match_jax_grad_of_the_reference():
    table, idx, w, w3, r = _inputs(1)

    def jloss(t, wt, m):
        out = j_bmt(t, jnp.asarray(idx), m, wt, use_pallas=False)
        return jnp.sum(out * jnp.asarray(r))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(table), jnp.asarray(w), jnp.asarray(w3))
    tt = torch.from_numpy(table).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tm = torch.from_numpy(w3).requires_grad_()
    out = bag_matmul_train(tt, torch.from_numpy(idx), tm, tw)
    torch.sum(out * torch.from_numpy(r)).backward()
    for got, want in ((tt.grad, jg[0]), (tw.grad, jg[1]), (tm.grad, jg[2])):
        assert got.shape == want.shape
        assert _rel(got.numpy(), want) <= 1e-5
    # untouched rows get exactly zero; the indices get no gradient
    untouched = np.setdiff1d(np.arange(V), idx)
    assert not tt.grad[torch.from_numpy(untouched)].any()


def test_only_the_asked_gradients_are_computed():
    table, idx, w, w3, r = _inputs(2)
    tt = torch.from_numpy(table).requires_grad_()
    out = bag_matmul_train(tt, torch.from_numpy(idx), torch.from_numpy(w3))
    (g,) = torch.autograd.grad(torch.sum(out * torch.from_numpy(r)), tt)
    jg = jax.grad(lambda t: jnp.sum(j_bmt(
        t, jnp.asarray(idx), jnp.asarray(w3), use_pallas=False)
        * jnp.asarray(r)))(jnp.asarray(table))
    assert _rel(g.numpy(), jg) <= 1e-5
