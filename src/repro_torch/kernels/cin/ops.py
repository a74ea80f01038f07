"""Public op: the xDeepFM CIN layer.

Port of ``repro/kernels/cin/ops.py``.  ``cin_layer`` takes the plain
version for CPU tensors and launches the CUDA kernel for CUDA tensors
(it raises for anything the kernel does not take).
"""

from __future__ import annotations

import torch

from repro_torch.core import op_counter
from repro_torch.kernels.cin.kernel import cin_layer_cuda
from repro_torch.kernels.cin.ref import cin_layer_ref


def cin_layer(w: torch.Tensor, x_k: torch.Tensor, x_0: torch.Tensor
              ) -> torch.Tensor:
    """(O, H, M), (B, H, D), (B, M, D) -> (B, O, D) fp32:
    ``out[b,o,d] = sum_{h,m} W[o,h,m] * x_k[b,h,d] * x_0[b,m,d]``.
    Dispatch is by ``x_k``'s device."""
    if x_k.device.type == "cpu":
        return cin_layer_ref(w, x_k, x_0)
    if op_counter.on_meta(x_k):
        (o, h, m), (b, _, d) = w.shape, x_k.shape
        # operations: 2 B O H M D; bytes: the three inputs, the output
        op_counter.report_kernel(
            "cin", (w, x_k, x_0), flops=2.0 * b * o * h * m * d,
            nbytes=4 * (w.numel() + x_k.numel() + x_0.numel() + b * o * d))
        return op_counter.meta_like((b, o, d))
    return cin_layer_cuda(w.to(torch.float32).contiguous(),
                          x_k.to(torch.float32).contiguous(),
                          x_0.to(torch.float32).contiguous())
