"""Differentiable fused bag -> matmul: training runs the serving kernel.

Port of ``repro/kernels/bag_matmul/autodiff.py``.  ``BagMatmulTrain`` is
the ``torch.autograd.Function`` twin of the reference's ``_bm_train``
(``jax.custom_vjp``), one fusion level above
``dequant_bag.autodiff.BagTrain``: the forward is the serving
``bag_matmul`` over the fp32 tier-exact table with unit scales (the
hand-written kernel on the card).  Cotangents:

  * table   — each slot's row cotangent ``weight[b,k] * (g[b] @ w3[k]^T)``
              scattered by ``bag_grad`` (the ``bag_grad.cu`` kernel on the
              card) with every slot its own one-index bag and its weight
              as the coefficient,
  * w3      — ``einsum("bkd,bh->kdh", rows * w, g)``,
  * weights — ``einsum("bkd,kdh,bh->bk", rows, w3, g)``,
  * indices — none (integer).

The two einsums are dense and run outside the kernels, as the
reference computes them outside Pallas; each is computed only when
autograd asks for it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.bag_matmul.ops import bag_matmul
from repro_torch.kernels.dequant_bag.ops import bag_grad


class BagMatmulTrain(torch.autograd.Function):
    """table (V, D) fp32, indices (B, K) int32, weights (B, K) fp32, w3
    (K, D, H) fp32 -> (B, H) fp32."""

    @staticmethod
    def forward(ctx, table, indices, weights, w3):
        ctx.save_for_backward(table, indices, weights, w3)
        return bag_matmul(table, None, indices, weights, w3)

    @staticmethod
    def backward(ctx, g):
        table, indices, weights, w3 = ctx.saved_tensors
        b, k = indices.shape
        v, d = table.shape
        g = g.to(torch.float32).contiguous()
        w3f = w3.to(torch.float32)
        wf = weights.to(torch.float32)
        dtable = dweights = dw3 = None
        if ctx.needs_input_grad[0]:
            # per-slot row cotangent g'[b,k] = g[b] @ w3[k]^T, scattered
            # with the slot weight as the coefficient
            gk = torch.einsum("bh,kdh->bkd", g, w3f)
            dtable = bag_grad(gk.reshape(b * k, d).contiguous(), None,
                              indices.reshape(-1, 1), wf.reshape(-1, 1),
                              v).to(table.dtype)
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            rows = table[indices.to(torch.int64)].to(torch.float32)
            if ctx.needs_input_grad[3]:
                dw3 = torch.einsum("bkd,bh->kdh", rows * wf[..., None],
                                   g).to(w3.dtype)
            if ctx.needs_input_grad[2]:
                dweights = torch.einsum("bkd,kdh,bh->bk", rows, w3f, g)
        return dtable, None, dweights, dw3


def bag_matmul_train(table: torch.Tensor, indices: torch.Tensor,
                     w: torch.Tensor, weights: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """Differentiable fused bag -> matmul through the serving kernels.

    table (V, D) fp32, indices (B, K), w (K*D, H) or (K, D, H) -> (B, H)
    fp32.  Equals ``bag_lookup-per-field.reshape(B, K*D) @ w`` with the
    (B, K*D) activations never materialised; the table's gradient runs
    the ``bag_grad`` kernel on the card.
    """
    b, k = indices.shape
    d = table.shape[1]
    if weights is None:
        weights = torch.ones((b, k), dtype=torch.float32,
                             device=indices.device)
    w3 = w.reshape(k, d, -1) if w.dim() == 2 else w
    return BagMatmulTrain.apply(table, indices.to(torch.int32).contiguous(),
                                weights.to(torch.float32).contiguous(),
                                w3.contiguous())
