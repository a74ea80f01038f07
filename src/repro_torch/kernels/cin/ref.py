"""Plain PyTorch version of the xDeepFM CIN layer.

    X^{k+1}[b, o, d] = sum_{h, m} W[o, h, m] * X^k[b, h, d] * X^0[b, m, d]

The CUDA kernel (``csrc/cin.cu``) is held to this bit for bit, so it pins
one order: each outer-product term ``xk[b,h,d] * x0[b,m,d]`` is rounded
to fp32 first, then one fp32 FMA chain runs over (h, m), h-major and m
ascending within h:

    acc = fma(W[o,h,m], f32(xk[b,h,d] * x0[b,m,d]), acc),  acc0 = 0

The reference's Pallas kernel contracts the flattened (h, m) axis in one
dot whose order XLA chooses, so the port meets it within a stated
tolerance, not bit for bit (``tests/test_torch_cin.py``).  ``fma_f32``
computes each fp32 FMA exactly in float64.  Vectorised over (B, O, D):
H * M steps.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.dequant_bag.ref import fma_f32


def cin_layer_ref(w: torch.Tensor, x_k: torch.Tensor, x_0: torch.Tensor
                  ) -> torch.Tensor:
    """w (O, H, M), x_k (B, H, D), x_0 (B, M, D), fp32 -> (B, O, D) fp32."""
    o, h, m = w.shape
    b, _, d = x_k.shape
    w = w.to(torch.float32)
    xk = x_k.to(torch.float32)
    x0 = x_0.to(torch.float32)
    acc = torch.zeros((b, o, d), dtype=torch.float32, device=x_k.device)
    for hh in range(h):
        for mm in range(m):
            outer = (xk[:, hh] * x0[:, mm])[:, None, :].expand(b, o, d)
            acc = fma_f32(w[:, hh, mm][None, :, None].expand(b, o, d),
                          outer, acc)
    return acc
