"""Plain PyTorch version of the fused row-wise int8 quantizer.

Port of ``repro/kernels/rowwise_quant/kernel.py::_quant_kernel`` (and of
its jnp oracle ``ref.py``), held to ``csrc/rowwise_quant.cu`` bit for
bit.  Per row of x (V, D) fp32:

    scale = max(max_abs(row), 1e-12) / denom      denom 127 ("narrow")
                                                  or 127.5 ("full")
    y     = x / scale
    q     = clip(round_half_even(y), -128, 127)            or, with noise,
    q     = clip(floor(y) + (noise < y - floor(y)), -128, 127)

``reciprocal`` picks how the scale divides by ``denom``: True multiplies
by fp32(1 / denom), as the reference's Pallas kernel computes it (it is
jitted, and XLA folds the division by the constant into that multiply);
False divides, as the eager ``quantize_rowwise_ref``,
``core.rowwise_quant`` and ``store.hashed.quantize_pool`` compute it.
The two differ in the last bit of the scale for some rows.  ``x / scale``
is an IEEE division in both.  Round to nearest is
``core.rowwise_quant.quantize_rowwise`` itself (scale, divide, round,
clip), so the port has one plain int8 quantizer; only the stochastic
branch is written here, on the same scale.  A NaN in a row makes its
scale NaN and its codes 0 (the float -> int8 cast of NaN).
"""

from __future__ import annotations

import torch

from repro_torch.core import rowwise_quant as rq


def quantize_rowwise_ref(x: torch.Tensor, noise: torch.Tensor | None = None,
                         mode: str = "narrow", *, reciprocal: bool = False
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (V, D) -> (q int8 (V, D), scale fp32 (V, 1)); ``noise`` (V, D)
    uniforms in [0, 1) select stochastic rounding, None round to nearest
    (half to even): ``core.rowwise_quant`` at 8 bits."""
    x = x.to(torch.float32)
    if noise is None:
        return rq.quantize_rowwise(x, 8, mode=mode, reciprocal=reciprocal)
    scale = rq.rowwise_scale(x, 8, mode, reciprocal=reciprocal)
    y = x / scale
    lo = torch.floor(y)
    r = lo + (noise < (y - lo)).to(torch.float32)
    return r.clamp_(-128, 127).to(torch.int8), scale
