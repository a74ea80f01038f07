"""Plain PyTorch version of the hashed gather, and the slot hash family.

Port of ``repro/kernels/hashed_gather/ref.py``.  ``hash_slots`` is the
contract every layer shares (the fit, the serving gather, the cache
rebuild): row ``r``'s chunk ``c`` is the signed sum of ``num_hashes``
pool rows picked by a uint32 murmur3 finalizer over ``(r, c, j)``.  The
uint32 arithmetic runs in int64, masked to 32 bits after every multiply
and add (a wrapped int64 product keeps its low 32 bits), as
``core.qat_store._hash_uniform`` does, so slots and signs equal the
reference's bit for bit.

``hashed_gather_ref`` follows the kernel's contract (``csrc/
hashed_gather.cu``), not the reference's jnp oracle: per (bag, chunk) it
walks the T slots in order, skips zero coefficients, and accumulates
``acc = fma(row * scale, coeff, acc)``.  That is what the reference's
Pallas kernel computes where its tests run it (interpret mode: XLA on
the CPU fuses ``out += (row * s) * w`` into that FMA); the jnp oracle
sums the rounded terms instead.  The two agree bit for bit at K = 1 with
+-1 sign coefficients (every product is exact), which is the serving
lookup and the fit.  ``hashed_grad_ref`` is the scatter transpose.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.dequant_bag.ref import bag_grad_ref, fma_f32

_U32 = 0xFFFFFFFF
_GOLD = 0x9E3779B1       # 2^32 / golden ratio
_KNUTH = 2654435761      # Knuth multiplicative constant
_MIX1 = 0x85EBCA6B       # murmur3 finalizer constants
_MIX2 = 0xC2B2AE35


def _mix(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = (h * _MIX1) & _U32
    h = h ^ (h >> 13)
    h = (h * _MIX2) & _U32
    return h ^ (h >> 16)


def salt(seed: int) -> int:
    """The hash's per-store salt: ``seed * 0x9E3779B1`` mod 2^32."""
    return (int(seed) * _GOLD) & _U32


def hash_slots(indices: torch.Tensor, *, num_chunks: int, num_hashes: int,
               num_slots: int, seed: int = 0
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Row ids -> (slots, signs), shapes ``indices.shape + (C, NH)``.

    slots int32 in [0, num_slots); signs fp32 in {-1, +1}, from a second
    finalizer pass so the sign is independent of the slot residue.
    """
    dev = indices.device
    idx = (indices.to(torch.int64) & _U32)[..., None, None]
    c = torch.arange(num_chunks, dtype=torch.int64, device=dev)[:, None]
    j = torch.arange(num_hashes, dtype=torch.int64, device=dev)[None, :]
    key = ((idx * _KNUTH) & _U32) + ((c * _MIX1) & _U32) + (
        (j * _MIX2) & _U32) + salt(seed)
    h = _mix(key & _U32)
    slots = (h % int(num_slots)).to(torch.int32)
    g = _mix((h + _GOLD) & _U32)
    signs = torch.where((g >> 31) == 0, 1.0, -1.0).to(torch.float32)
    return slots, signs


def hashed_gather_ref(pool: torch.Tensor, scales: torch.Tensor | None,
                      slots: torch.Tensor, coeff: torch.Tensor, *,
                      num_chunks: int) -> torch.Tensor:
    """pool (S, Z) fp32|int8, scales (S,) fp32 or None (unit scales),
    slots/coeff (B, C*T) -> (B, C*Z) fp32:

        out[b, c*Z:(c+1)*Z] = sum_t (f32(pool[slot]) * scale[slot]) * coeff

    summed over t in order as ``fma(row * s, coeff, acc)``, skipping
    slots with coeff == 0.
    """
    b = slots.shape[0]
    z = pool.shape[1]
    t = slots.shape[1] // num_chunks
    sl = slots.to(torch.int64).reshape(b, num_chunks, t)
    w = coeff.to(torch.float32).reshape(b, num_chunks, t)
    acc = torch.zeros((b, num_chunks, z), dtype=torch.float32,
                      device=pool.device)
    for tt in range(t):
        s = sl[:, :, tt]
        rows = pool[s].to(torch.float32)
        if scales is not None:
            rows = rows * scales[s][..., None]
        wt = w[:, :, tt][..., None]
        acc = torch.where(wt != 0, fma_f32(rows, wt.expand_as(rows), acc),
                          acc)
    return acc.reshape(b, num_chunks * z)


def hashed_grad_ref(g: torch.Tensor, scales: torch.Tensor | None,
                    slots: torch.Tensor, coeff: torch.Tensor,
                    num_pool_slots: int, *, num_chunks: int) -> torch.Tensor:
    """Scatter transpose: d pool from the chunked cotangent.

    g (B, C*Z) fp32 -> (S, Z) fp32: each (bag, chunk) is one T-slot bag
    over the pool, so this is ``bag_grad_ref`` on the (B*C, Z) / (B*C, T)
    reshape, ``coeff * scale[slot]`` per slot, summed per pool row in
    (b, c, t) order.
    """
    b = g.shape[0]
    z = g.shape[1] // num_chunks
    t = slots.shape[1] // num_chunks
    return bag_grad_ref(g.to(torch.float32).reshape(b * num_chunks, z),
                        scales, slots.reshape(b * num_chunks, t),
                        coeff.reshape(b * num_chunks, t), num_pool_slots)
