"""Plain PyTorch version of the fused dequant-bag -> first-matmul kernel.

The CUDA kernel (``csrc/bag_matmul.cu``) is held to this bit for bit, so
it pins one order of the fp32 arithmetic rather than the shortest
expression.  It is the order the reference's Pallas kernel computes where
its tests run it (interpret mode, XLA on the CPU):

    rows[b, k, :] = (f32(payload[i_bk]) * scale[i_bk]) * w_bk   (two
                    rounded products; exact zeros where w_bk == 0)
    prod_k[b, h]  = fma(rows[b,k,D-1], w3[k,D-1,h], ... fma(rows[b,k,0],
                    w3[k,0,h], 0))                       (d ascending)
    out[b, h]     = (((0 + prod_0) + prod_1) + ...) + prod_{K-1}

With ``scale_after`` the product runs on the raw converted rows and is
multiplied by ``scale * weight`` per output row before the add (the
reference's int8-direct specialisation).  ``fma_f32`` computes each fp32
FMA exactly in float64.  Vectorised over (B, H): K * D steps.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.dequant_bag.ref import fma_f32


def slot_rows(payload: torch.Tensor, scales: torch.Tensor | None,
              indices: torch.Tensor, weights: torch.Tensor,
              scale_after: bool = False) -> torch.Tensor:
    """The (B, K, D) fp32 rows the kernel stages per field: ``(row * s) *
    w`` (raw ``row`` under ``scale_after``), zeros for dead slots."""
    idx = indices.to(torch.int64)
    rows = payload[idx].to(torch.float32)
    w = weights.to(torch.float32)[..., None]
    if not scale_after:
        if scales is not None:
            rows = rows * scales[idx][..., None]
        rows = rows * w
    return torch.where(w != 0, rows, torch.zeros((), device=rows.device))


def bag_matmul_ref(payload: torch.Tensor, scales: torch.Tensor | None,
                   indices: torch.Tensor, weights: torch.Tensor,
                   w3: torch.Tensor, *, scale_after: bool = False
                   ) -> torch.Tensor:
    """payload (V, D) int8|bf16|fp16|fp32, scales (V,) fp32 or None (unit
    scales), indices (B, K) in [0, V), weights (B, K) fp32, w3 (K, D, H)
    fp32 -> (B, H) fp32 in the order of the module docstring."""
    b, k = indices.shape
    d, h = w3.shape[1], w3.shape[2]
    rows = slot_rows(payload, scales, indices, weights, scale_after)
    w3 = w3.to(torch.float32)
    out = torch.zeros((b, h), dtype=torch.float32, device=payload.device)
    if scale_after:
        s = (torch.ones((b, k), dtype=torch.float32, device=payload.device)
             if scales is None else scales[indices.to(torch.int64)])
        coeff = s * weights.to(torch.float32)
    for kk in range(k):
        prod = torch.zeros((b, h), dtype=torch.float32,
                           device=payload.device)
        for dd in range(d):
            prod = fma_f32(rows[:, kk, dd, None].expand(b, h),
                           w3[kk, dd][None, :].expand(b, h), prod)
        if scale_after:
            prod = prod * coeff[:, kk, None]
        out = out + prod
    return out
