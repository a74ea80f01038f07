"""Parity of the port's CIN layer with the JAX package, on the CPU.

On the CPU ``kernels.cin.ops.cin_layer`` takes the plain version, which
the CUDA kernel is held to bit for bit on the card (``chip_smoke.py``).
The reference's Pallas kernel contracts the flattened (h, m) axis in one
dot of XLA's order, and its ``models.recsys.cin_layer`` is an einsum
pair, so neither is bit-equal to the port's pinned FMA chain: both are
held to ``|d| <= 1e-6 * sum_{h,m} |W * xk * x0|``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro.kernels.cin.kernel import cin_layer_pallas
from repro.models.recsys import cin_layer as j_cin_layer
from repro_torch.kernels import cases
from repro_torch.kernels.cin import kernel as tkernel
from repro_torch.kernels.cin import ops as tops
from repro_torch.kernels.cin.ref import cin_layer_ref
from repro_torch.models.recsys import cin_layer as t_cin_layer

TOL = 1e-6


def _inputs(b, o, h, m, d, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((o, h, m)) / np.sqrt(h * m)).astype(np.float32)
    xk = rng.standard_normal((b, h, d)).astype(np.float32)
    x0 = rng.standard_normal((b, m, d)).astype(np.float32)
    return w, xk, x0


def _abs_terms(w, xk, x0) -> np.ndarray:
    return np.einsum("ohm,bhd,bmd->bod", np.abs(w).astype(np.float64),
                     np.abs(xk).astype(np.float64),
                     np.abs(x0).astype(np.float64))


# (B, O, H, M, D): xDeepFM's first layer at its published widths
# (H = M = 39 fields, D = 10), a deeper layer (H = O of the last), and
# shapes that no block divides
@pytest.mark.parametrize("b,o,h,m,d", [(3, 20, 39, 39, 10),
                                       (8, 24, 20, 39, 10),
                                       (5, 7, 9, 8, 6)])
def test_plain_within_tolerance_of_pallas_and_jnp(b, o, h, m, d):
    w, xk, x0 = _inputs(b, o, h, m, d)
    tkernel.reset_launches()
    got = tops.cin_layer(torch.from_numpy(w), torch.from_numpy(xk),
                         torch.from_numpy(x0))
    assert tkernel.total_launches() == 0            # CPU: plain version
    assert got.shape == (b, o, d) and got.dtype == torch.float32
    terms = _abs_terms(w, xk, x0)
    g = got.numpy().astype(np.float64)
    for want in (cin_layer_pallas(jnp.asarray(w), jnp.asarray(xk),
                                  jnp.asarray(x0), interpret=True),
                 j_cin_layer(jnp.asarray(w), jnp.asarray(xk),
                             jnp.asarray(x0))):
        want = np.asarray(want, np.float64)
        assert want.shape == g.shape
        assert np.all(np.abs(g - want) <= TOL * terms)
    np.testing.assert_array_equal(
        t_cin_layer(torch.from_numpy(w), torch.from_numpy(xk),
                    torch.from_numpy(x0)).numpy().view(np.uint32),
        got.numpy().view(np.uint32))


def test_plain_pins_the_h_major_fma_chain():
    """One output element by hand: round each term, then the fp32 FMA
    chain over (h, m) in h-major order."""
    w, xk, x0 = _inputs(1, 1, 3, 4, 1, seed=2)
    acc = np.float32(0)
    for h in range(3):
        for m in range(4):
            t = np.float32(xk[0, h, 0] * x0[0, m, 0])
            acc = np.float32(np.float64(w[0, h, m]) * np.float64(t)
                             + np.float64(acc))
    got = cin_layer_ref(torch.from_numpy(w), torch.from_numpy(xk),
                        torch.from_numpy(x0))
    # float64 holds the product exactly; the sum rounds once to float64
    # and again to fp32, which equals the fp32 FMA away from ties
    assert float(got[0, 0, 0]) == float(acc)


def test_wrapper_checks():
    w, xk, x0 = (torch.from_numpy(a) for a in _inputs(2, 3, 4, 5, 6))
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.cin_layer_cuda(w, xk, x0)


@pytest.mark.parametrize("name", cases.CIN_CASE_NAMES)
def test_plain_within_tolerance_on_the_kernel_cases(name):
    """The card check's adversarial shapes (``kernels/cases.py``): the
    plain version the kernel is held to is within tolerance of the
    reference's Pallas kernel (interpret mode) and its einsum pair; a
    NaN in W is NaN in the same outputs of all three."""
    c = {c.name: c for c in cases.cin_cases("cpu")}[name]
    assert (c.w.data_ptr() % 16 != 0) == (name == "w_off_k72")
    w, xk, x0 = (t.numpy() for t in c[1:])
    got = tops.cin_layer(c.w, c.xk, c.x0).numpy().astype(np.float64)
    terms = _abs_terms(w, xk, x0)
    nan = np.isnan(terms)
    assert nan.any() == (name == "nan_w")
    for want in (cin_layer_pallas(jnp.asarray(w), jnp.asarray(xk),
                                  jnp.asarray(x0), interpret=True),
                 j_cin_layer(jnp.asarray(w), jnp.asarray(xk),
                             jnp.asarray(x0))):
        want = np.asarray(want, np.float64)
        assert want.shape == got.shape
        np.testing.assert_array_equal(np.isnan(want), nan)
        np.testing.assert_array_equal(np.isnan(got), nan)
        assert np.all(np.abs(got - want)[~nan] <= TOL * terms[~nan])
