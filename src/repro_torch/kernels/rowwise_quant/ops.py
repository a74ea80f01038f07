"""Public op: fused row-wise int8 quantization.

Port of ``repro/kernels/rowwise_quant/ops.py``.  ``quantize_rowwise``
takes the plain version for CPU tensors and launches the CUDA kernel for
CUDA tensors (it raises for anything the kernel does not take).
"""

from __future__ import annotations

import torch

from repro_torch.core import op_counter
from repro_torch.kernels.rowwise_quant.kernel import quantize_rowwise_cuda
from repro_torch.kernels.rowwise_quant.ref import quantize_rowwise_ref


def quantize_rowwise(x: torch.Tensor, noise: torch.Tensor | None = None,
                     mode: str = "narrow", *, reciprocal: bool = False
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (V, D) -> (q int8 (V, D), scale fp32 (V, 1)); ``noise`` (V, D)
    selects stochastic rounding; ``reciprocal`` the jitted reference's
    scale (see ``ref``).  Dispatch is by ``x``'s device."""
    if x.device.type == "cpu":
        return quantize_rowwise_ref(x, noise, mode, reciprocal=reciprocal)
    if op_counter.on_meta(x):
        v, d = x.shape
        # 4 B read + 1 B written an element (+ 4 B of noise), 4 B a row
        op_counter.report_kernel(
            "rowwise_quant", (x, noise),
            nbytes=v * d * (5 + (0 if noise is None else 4)) + v * 4)
        return (op_counter.meta_like((v, d), torch.int8),
                op_counter.meta_like((v, 1)))
    return quantize_rowwise_cuda(
        x.to(torch.float32).contiguous(),
        None if noise is None else noise.to(torch.float32).contiguous(),
        mode, reciprocal=reciprocal)
