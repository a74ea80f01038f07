"""Public ops: the slot plan and the fused hashed gather.

Port of ``repro/kernels/hashed_gather/ops.py``.  ``slot_plan`` turns bag
indices into the kernel's addressing (per-(bag, chunk) pool slots and
sign-folded coefficients), in torch on the indices' device, as the
reference builds it outside its kernel.  ``hashed_gather`` takes the
plain version for CPU tensors and launches the CUDA kernel for CUDA
tensors (it raises for anything the kernel does not take).
``hashed_gather_ids`` is ``slot_plan`` and ``hashed_gather`` in one op,
with the same dispatch: on CUDA one launch of the kernel's ids entry,
which hashes the plan in registers; its plain version
``hashed_gather_ids_ref`` builds the plan and gathers.  The
reference's block-size resolution has no counterpart: the CUDA kernel
has a fixed thread block.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.hashed_gather.kernel import (hashed_gather_cuda,
                                                      hashed_gather_ids_cuda)
from repro_torch.kernels.hashed_gather.ref import (hash_slots,
                                                   hashed_gather_ref)


def slot_plan(indices: torch.Tensor, weights: torch.Tensor | None, *,
              num_chunks: int, num_hashes: int, num_slots: int,
              seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Bag indices (B, K) [+ weights (B, K)] -> (slots int32, coeff fp32),
    both (B, C*K*NH): chunk-major slot columns (chunk c's K*NH draws
    contiguous) and sign-folded coefficients."""
    b, k = indices.shape
    cols = num_chunks * k * num_hashes
    slots, signs = hash_slots(indices, num_chunks=num_chunks,
                              num_hashes=num_hashes, num_slots=num_slots,
                              seed=seed)
    # (B, K, C, NH) -> (B, C, K, NH) -> (B, C*K*NH)
    slots = slots.permute(0, 2, 1, 3).reshape(b, cols)
    coeff = (signs if weights is None else
             signs * weights.to(torch.float32)[:, :, None, None])
    return slots.contiguous(), coeff.permute(0, 2, 1, 3).reshape(
        b, cols).contiguous()


def hashed_gather(pool: torch.Tensor, scales: torch.Tensor | None,
                  slots: torch.Tensor, coeff: torch.Tensor, *,
                  num_chunks: int) -> torch.Tensor:
    """pool (S, Z), scales (S,) or None, slots/coeff (B, C*T) -> (B, C*Z)
    fp32: ``out[b, cZ:(c+1)Z] = sum_t (pool[slot] * scale) * coeff`` in t
    order, zero coefficients skipped.  Dispatch is by ``pool``'s device."""
    if pool.device.type == "cpu":
        return hashed_gather_ref(pool, scales, slots, coeff,
                                 num_chunks=num_chunks)
    return hashed_gather_cuda(
        pool.contiguous(), scales, slots.to(torch.int32).contiguous(),
        coeff.to(torch.float32).contiguous(), num_chunks=num_chunks)


def hashed_gather_ids_ref(pool: torch.Tensor, scales: torch.Tensor | None,
                          indices: torch.Tensor,
                          weights: torch.Tensor | None = None, *,
                          num_chunks: int, num_hashes: int, seed: int = 0
                          ) -> torch.Tensor:
    """The plain version of ``hashed_gather_ids``: ``slot_plan`` over the
    pool's S rows, then ``hashed_gather_ref``."""
    slots, coeff = slot_plan(indices, weights, num_chunks=num_chunks,
                             num_hashes=num_hashes, num_slots=pool.shape[0],
                             seed=seed)
    return hashed_gather_ref(pool, scales, slots, coeff,
                             num_chunks=num_chunks)


def hashed_gather_ids(pool: torch.Tensor, scales: torch.Tensor | None,
                      indices: torch.Tensor,
                      weights: torch.Tensor | None = None, *,
                      num_chunks: int, num_hashes: int, seed: int = 0
                      ) -> torch.Tensor:
    """pool (S, Z), scales (S,) or None, bag ids (B, K) [+ weights (B,
    K)] -> (B, C*Z) fp32: ``hashed_gather`` on ``slot_plan(indices,
    weights, num_slots=S)``, bit for bit.  Dispatch is by ``pool``'s
    device."""
    if pool.device.type == "cpu":
        return hashed_gather_ids_ref(pool, scales, indices, weights,
                                     num_chunks=num_chunks,
                                     num_hashes=num_hashes, seed=seed)
    if indices.dtype not in (torch.int32, torch.int64):
        indices = indices.to(torch.int64)
    return hashed_gather_ids_cuda(
        pool.contiguous(), scales, indices.contiguous(),
        None if weights is None else weights.to(torch.float32).contiguous(),
        num_chunks=num_chunks, num_hashes=num_hashes, seed=seed)
