"""Differentiable fused embedding bag: the training gather.

Port of ``repro/kernels/dequant_bag/autodiff.py``.  ``BagTrain`` is the
``torch.autograd.Function`` twin of the reference's ``_bag_train``
(``jax.custom_vjp``): the forward is the serving kernel ``dequant_bag``
with unit scales over the fp32 tier-exact table, the backward is the
scatter-add kernel ``bag_grad``.  Cotangents:

  * table   — ``bag_grad`` (a dense (V, D) gradient, untouched rows
              exactly zero, as the reference's),
  * indices — none (integer),
  * weights — the per-slot dot ``rows . g``, computed only when autograd
              asks for it (the training gather's weights are constant
              ones, so it never does there).

Both directions dispatch by device like every op of the port: the plain
versions on the CPU, the CUDA kernels on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.dequant_bag.ops import bag_grad, dequant_bag


class BagTrain(torch.autograd.Function):
    """table (V, D) fp32, indices (B, K) int32, weights (B, K) fp32 ->
    (B, D) fp32 bag sums."""

    @staticmethod
    def forward(ctx, table, indices, weights):
        ctx.save_for_backward(table, indices, weights)
        return dequant_bag(table, None, indices, weights)

    @staticmethod
    def backward(ctx, g):
        table, indices, weights = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        dtable = dweights = None
        if ctx.needs_input_grad[0]:
            dtable = bag_grad(g, None, indices, weights,
                              table.shape[0]).to(table.dtype)
        if ctx.needs_input_grad[2]:
            rows = table[indices.to(torch.int64)].to(torch.float32)
            dweights = torch.einsum("bkd,bd->bk", rows, g)
        return dtable, None, dweights


def bag_lookup_train(table: torch.Tensor, indices: torch.Tensor,
                     weights: torch.Tensor | None = None) -> torch.Tensor:
    """Differentiable embedding bag through the serving kernels.

    table (V, D) fp32, indices (B, K) -> (B, D) fp32; ``weights`` (B, K)
    multiply per slot (0 skips the slot in both directions).
    """
    if weights is None:
        weights = torch.ones(indices.shape, dtype=torch.float32,
                             device=indices.device)
    return BagTrain.apply(table, indices.to(torch.int32).contiguous(),
                          weights.contiguous())


def lookup_train(table: torch.Tensor, indices: torch.Tensor
                 ) -> torch.Tensor:
    """Differentiable gather: int (...,) -> fp32 (..., D).

    The K = 1 bag: the forward equals ``table[indices]`` bit for bit and
    the backward is a pure scatter-add.
    """
    out = bag_lookup_train(table, indices.reshape(-1, 1))
    return out.reshape(*indices.shape, table.shape[1])
