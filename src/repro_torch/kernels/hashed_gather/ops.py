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
``hashed_gather_ids_ref`` builds the plan and gathers.  On CUDA both
resolve the kernel's tiling as the reference's ``resolve_hashed_block_b``
(``ops.py:39-55``): an explicit ``tiling``, then a hit in the measured
autotune cache (key ``hashed_gather`` by pool dtype, ``(B, T, Z)``, T
the slots a (bag, chunk)), then the analytic pick; every tiling is
bit-equal.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import autotune
from repro_torch.kernels.dequant_bag.ops import dtype_name
from repro_torch.kernels.hashed_gather.kernel import (
    hashed_gather_cuda, hashed_gather_ids_cuda, hashed_gather_tiling_ok)
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


def resolve_tiling(pool: torch.Tensor, b: int, t: int, num_chunks: int,
                   tiling: tuple[int, int] | None) -> tuple[int, int]:
    """The kernel's tiling for B bags of T slots a chunk over ``pool``."""
    z = pool.shape[1]
    return autotune.resolve_tiling(
        "hashed_gather", dtype_name(pool.dtype), b, t, z, tiling,
        device=pool.device,
        valid=lambda tl: hashed_gather_tiling_ok(tl, num_chunks, z))


def hashed_gather(pool: torch.Tensor, scales: torch.Tensor | None,
                  slots: torch.Tensor, coeff: torch.Tensor, *,
                  num_chunks: int, tiling: tuple[int, int] | None = None
                  ) -> torch.Tensor:
    """pool (S, Z), scales (S,) or None, slots/coeff (B, C*T) -> (B, C*Z)
    fp32: ``out[b, cZ:(c+1)Z] = sum_t (pool[slot] * scale) * coeff`` in t
    order, zero coefficients skipped.  Dispatch is by ``pool``'s device;
    on CUDA at ``tiling``, else the autotune cache's or the analytic
    one."""
    if pool.device.type == "cpu":
        return hashed_gather_ref(pool, scales, slots, coeff,
                                 num_chunks=num_chunks)
    tiling = resolve_tiling(pool, slots.shape[0],
                            slots.shape[1] // max(num_chunks, 1), num_chunks,
                            tiling)
    return hashed_gather_cuda(
        pool.contiguous(), scales, slots.to(torch.int32).contiguous(),
        coeff.to(torch.float32).contiguous(), num_chunks=num_chunks,
        tiling=tiling)


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
                      num_chunks: int, num_hashes: int, seed: int = 0,
                      tiling: tuple[int, int] | None = None
                      ) -> torch.Tensor:
    """pool (S, Z), scales (S,) or None, bag ids (B, K) [+ weights (B,
    K)] -> (B, C*Z) fp32: ``hashed_gather`` on ``slot_plan(indices,
    weights, num_slots=S)``, bit for bit.  Dispatch is by ``pool``'s
    device; on CUDA at ``tiling`` as ``hashed_gather``."""
    if pool.device.type == "cpu":
        return hashed_gather_ids_ref(pool, scales, indices, weights,
                                     num_chunks=num_chunks,
                                     num_hashes=num_hashes, seed=seed)
    if indices.dtype not in (torch.int32, torch.int64):
        indices = indices.to(torch.int64)
    tiling = resolve_tiling(pool, indices.shape[0],
                            indices.shape[1] * num_hashes, num_chunks, tiling)
    return hashed_gather_ids_cuda(
        pool.contiguous(), scales, indices.contiguous(),
        None if weights is None else weights.to(torch.float32).contiguous(),
        num_chunks=num_chunks, num_hashes=num_hashes, seed=seed,
        tiling=tiling)
