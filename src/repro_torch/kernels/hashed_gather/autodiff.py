"""Differentiable hashed gather: the training twin of the serving kernel.

Port of ``repro/kernels/hashed_gather/autodiff.py``.  ``HashedTrain`` is
the ``torch.autograd.Function`` twin of the reference's
``_hashed_train`` (``jax.custom_vjp``): the forward is the serving
kernel ``hashed_gather`` with unit scales over the fp32 training pool.
Cotangents:

  * pool   -- each (bag, chunk) is one T-slot bag over the (S, Z) pool,
              so the pool gradient is ``bag_grad`` on the (B*C, Z) /
              (B*C, T) reshape: a deterministic scatter in (b, c, t)
              order, the reference's ``bag_grad_pallas`` arithmetic;
  * coeff  -- the per-slot chunk dot ``rows . g_chunk`` (an einsum); it
              flows on to the bag weights through ``slot_plan``'s sign
              fold, outside the Function, as in the reference;
  * slots  -- none (integer).

Both directions dispatch by device like every op of the port.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.dequant_bag.ops import bag_grad
from repro_torch.kernels.hashed_gather.ops import hashed_gather, slot_plan


class HashedTrain(torch.autograd.Function):
    """pool (S, Z) fp32, slots (B, C*T) int32, coeff (B, C*T) fp32 ->
    (B, C*Z) fp32."""

    @staticmethod
    def forward(ctx, pool, slots, coeff, num_chunks):
        ctx.save_for_backward(pool, slots, coeff)
        ctx.num_chunks = num_chunks
        return hashed_gather(pool, None, slots, coeff, num_chunks=num_chunks)

    @staticmethod
    def backward(ctx, g):
        pool, slots, coeff = ctx.saved_tensors
        nc = ctx.num_chunks
        b, z = slots.shape[0], pool.shape[1]
        t = slots.shape[1] // nc
        g = g.to(torch.float32).contiguous()
        dpool = dcoeff = None
        if ctx.needs_input_grad[0]:
            dpool = bag_grad(g.reshape(b * nc, z), None,
                             slots.reshape(b * nc, t),
                             coeff.reshape(b * nc, t),
                             pool.shape[0]).to(pool.dtype)
        if ctx.needs_input_grad[2]:
            rows = pool[slots.to(torch.int64)].to(torch.float32)
            dcoeff = torch.einsum("bcez,bctz->bct", g.reshape(b, nc, 1, z),
                                  rows.reshape(b, nc, t, z)
                                  ).reshape(b, nc * t)
        return dpool, None, dcoeff, None


def hashed_bag_lookup_train(pool: torch.Tensor, indices: torch.Tensor,
                            weights: torch.Tensor | None = None, *,
                            num_chunks: int, num_hashes: int,
                            seed: int = 0) -> torch.Tensor:
    """Differentiable hashed embedding bag through the serving kernel.

    pool (S, Z) fp32, indices (B, K) -> (B, C*Z) fp32 bag sums;
    ``weights`` (B, K) multiply per slot (0 skips the slot in both
    directions) and receive a gradient through the sign fold.
    """
    slots, coeff = slot_plan(indices, weights, num_chunks=num_chunks,
                             num_hashes=num_hashes,
                             num_slots=pool.shape[0], seed=seed)
    return HashedTrain.apply(pool, slots, coeff, num_chunks)


def hashed_lookup_train(pool: torch.Tensor, indices: torch.Tensor, *,
                        num_chunks: int, num_hashes: int, seed: int = 0
                        ) -> torch.Tensor:
    """Differentiable hashed gather: int (...,) -> fp32 (..., C*Z), the
    K = 1 bag (bit-identical to the serving materialisation)."""
    out = hashed_bag_lookup_train(pool, indices.reshape(-1, 1),
                                  num_chunks=num_chunks,
                                  num_hashes=num_hashes, seed=seed)
    return out.reshape(*indices.shape, out.shape[-1])
