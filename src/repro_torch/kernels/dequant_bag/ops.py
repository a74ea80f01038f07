"""Public op: fused dequant embedding-bag over the tier-partitioned store.

Port of ``repro/kernels/dequant_bag/ops.py``.  ``dequant_bag`` takes the
plain version for CPU tensors and launches the CUDA kernel for CUDA
tensors (it raises for anything the kernel does not take).
``packed_bag_lookup`` is the bag over a packed store, with the same
dispatch: on CUDA one launch of the kernel's tiered entry, on the CPU
``packed_bag_lookup_tiers``, the reference's composition (one bag per
tier with tier-local indices, slots of other tiers at weight 0, the
three partial bags summed in the reference's order), which is the tiered
entry's plain version and, launched on the card, its yardstick; with a
shard window (``firsts``) both are one shard of a row-sharded store
(``dist.packed``: the reference's per-shard composition).
``packed_lookup_fused`` is the K = 1 serving gather, bit-identical to
``packed_store.lookup``.  ``bag_grad`` is the scatter-add backward, with
the same dispatch; ``plan_slots`` groups its slots once for callers that
scatter over the same indices many times.  ``dequant_bag_rowgrid`` and ``bag_grad_rowgrid`` are
the reference's (B, K)-grid tiling oracles of the two, with the same
dispatch; no serving or training path calls them.

On CUDA ``dequant_bag`` and ``bag_grad`` resolve their kernel's tiling
as the reference's ``resolve_block_sizes`` does (``ops.py:97-147``): an
explicit ``tiling``, then a hit in the measured autotune cache
(``kernels.autotune``, keys ``dequant_bag`` by payload dtype and
``bag_grad``), then the analytic pick.  Every tiling is bit-equal, so
the cache moves times only.  The reference's ``REPRO_DEQUANT_BLOCK_B/D``
overrides are not ported.  The tiered entry keeps its analytic pick.
"""

from __future__ import annotations

import torch

from repro_torch.core import op_counter
from repro_torch.core.packed_store import PackedStore, _split
from repro_torch.kernels import autotune
from repro_torch.kernels.dequant_bag.kernel import (
    SlotPlan, access_width, bag_grad_cuda, bag_grad_rowgrid_cuda,
    bag_grad_tiling_ok, dequant_bag_cuda, dequant_bag_rowgrid_cuda,
    dequant_bag_tiered_cuda, plan_slots)
from repro_torch.kernels.dequant_bag.ref import (
    bag_grad_coeff, bag_grad_ref, bag_grad_rowgrid_ref, dequant_bag_ref,
    dequant_bag_rowgrid_ref)


def dtype_name(dtype: torch.dtype) -> str:
    """A tensor dtype as the cache keys name it (``int8``, ``bfloat16``,
    ...), the reference's ``str(payload.dtype)``."""
    return str(dtype).removeprefix("torch.")


def dequant_bag(payload: torch.Tensor, scales: torch.Tensor | None,
                indices: torch.Tensor,
                weights: torch.Tensor | None = None,
                tiling: tuple[int, int] | None = None) -> torch.Tensor:
    """payload (V, D), scales (V,) or None, indices (B, K) -> (B, D) fp32.

    ``out[b] = sum_k (f32(payload[i_bk]) * scale[i_bk]) * w_bk`` in k
    order, zero-weight slots skipped.  Dispatch is by ``payload``'s
    device; on CUDA at ``tiling``, else the autotune cache's or the
    analytic one.
    """
    if weights is None:
        weights = torch.ones(indices.shape, dtype=torch.float32,
                             device=indices.device)
    if payload.device.type == "cpu":
        return dequant_bag_ref(payload, scales, indices, weights)
    b, k = indices.shape
    if op_counter.on_meta(payload):
        return _meta_bag("dequant_bag", payload, scales, indices,
                         inputs=(payload, scales, indices, weights))
    return dequant_bag_cuda(payload, scales, indices, weights,
                            tiling=autotune.resolve_tiling(
                                "dequant_bag", dtype_name(payload.dtype), b,
                                k, payload.shape[1], tiling,
                                device=payload.device))


def bag_grad(g: torch.Tensor, scales: torch.Tensor | None,
             indices: torch.Tensor, weights: torch.Tensor | None,
             vocab: int, plan: SlotPlan | None = None,
             out: torch.Tensor | None = None,
             tiling: tuple[int, int] | None = None) -> torch.Tensor:
    """Transpose of ``dequant_bag`` w.r.t. the payload: g (B, D) fp32,
    indices (B, K) -> dtable (vocab, D) fp32.

    ``dtable[i]`` is the (b, k)-ordered FMA sum of ``coeff * g[b]`` over
    the slots of row i, ``coeff = w * scale[idx]`` (``None`` = ones).
    Dispatch is by ``g``'s device: the plain version on the CPU; on CUDA
    a zero fill of (vocab, D) and the kernel.  ``plan`` is
    ``plan_slots(indices)``, for callers that scatter over the same
    indices again (the kernel then skips its sort; the plain version
    needs no grouping).  ``out`` (vocab, D) fp32, when given, is
    accumulated onto in place and returned (no zero fill): each touched
    row's chain starts from its value there, so scattering consecutive
    runs of bags one call each sums every row as one call does.  On
    CUDA the kernel runs at ``tiling``, else the autotune cache's (where
    this launch's access width takes it) or the analytic one.
    """
    if g.device.type == "cpu":
        return bag_grad_ref(g, scales, indices, weights, vocab, out=out)
    b, k = indices.shape
    d = g.shape[1]
    if op_counter.on_meta(g):
        # g, the ids, one coefficient a slot; every output row written
        op_counter.report_kernel(
            "bag_grad", (g, scales, indices, weights, out),
            nbytes=g.numel() * 4 + indices.numel()
            * (indices.element_size() + 4) + vocab * d * 4)
        return op_counter.meta_like((vocab, d)) if out is None else out
    width = access_width(d, g, *(() if out is None else (out,)))
    tiling = autotune.resolve_tiling(
        "bag_grad", "float32", b, k, d, tiling, device=g.device,
        valid=lambda t: bag_grad_tiling_ok(t, width))
    return _scatter_on_card(bag_grad_cuda, g, scales, indices, weights,
                            vocab, plan=plan, out=out, tiling=tiling)


def _meta_bag(name: str, payload: torch.Tensor, scales, indices,
              inputs, ids_bytes: int = 0) -> torch.Tensor:
    """A bag op on ``meta``: a (B, D) fp32 result, and the bytes of its
    bound reported (the ids and weights, each slot's row and scale as if
    no row repeats, the output, plus ``ids_bytes``); nothing runs."""
    b, k = indices.shape
    d = payload.shape[1]
    row = d * payload.element_size() + (0 if scales is None else 4)
    op_counter.report_kernel(
        name, inputs, nbytes=b * k * (indices.element_size() + 4 + row)
        + ids_bytes + b * d * 4)
    return op_counter.meta_like((b, d))


def _scatter_on_card(launch, g, scales, indices, weights, vocab: int,
                     out: torch.Tensor | None = None, **kw) -> torch.Tensor:
    """The coefficients, a zero (vocab, D) output (or ``out``, accumulated
    onto) and one ``launch``."""
    coeff = bag_grad_coeff(scales, indices, weights).contiguous()
    if out is not None:
        kw["accumulate"] = True
    else:
        out = torch.zeros((vocab, g.shape[1]), dtype=torch.float32,
                          device=g.device)
    return launch(g.to(torch.float32).contiguous(),
                  indices.to(torch.int32).contiguous(), coeff, out, **kw)


def dequant_bag_rowgrid(payload: torch.Tensor, scales: torch.Tensor | None,
                        indices: torch.Tensor,
                        weights: torch.Tensor | None = None) -> torch.Tensor:
    """The (B, K)-grid oracle of ``dequant_bag``: the same bags, but every
    slot is read, so a NaN or inf row in a zero-weight slot makes its
    bag NaN.  Dispatch is by ``payload``'s device."""
    if weights is None:
        weights = torch.ones(indices.shape, dtype=torch.float32,
                             device=indices.device)
    if payload.device.type == "cpu":
        return dequant_bag_rowgrid_ref(payload, scales, indices, weights)
    return dequant_bag_rowgrid_cuda(payload, scales, indices, weights)


def bag_grad_rowgrid(g: torch.Tensor, scales: torch.Tensor | None,
                     indices: torch.Tensor, weights: torch.Tensor | None,
                     vocab: int) -> torch.Tensor:
    """The (B, K)-grid oracle of ``bag_grad``: the same (vocab, D)
    gradient, one slot's read-modify-write at a time in (b, k) order.
    Dispatch is by ``g``'s device: the plain version on the CPU; on CUDA
    a zero fill of (vocab, D) and the kernel."""
    if g.device.type == "cpu":
        return bag_grad_rowgrid_ref(g, scales, indices, weights, vocab)
    return _scatter_on_card(bag_grad_rowgrid_cuda, g, scales, indices,
                            weights, vocab)


def stand_in(payload: torch.Tensor, scales: torch.Tensor | None):
    """``payload`` and ``scales`` as they are, or a one-row zero payload
    with a unit scale where ``payload`` holds no row (a shard that owns
    none of a tier or a pool: only slots of weight 0, or 0 * w, reach
    it, as the reference's zero pad rows)."""
    if payload.shape[0]:
        return payload, scales
    dev = payload.device
    return (torch.zeros((1, *payload.shape[1:]), dtype=payload.dtype,
                        device=dev),
            None if scales is None else
            torch.ones((1,), dtype=torch.float32, device=dev))


def window_slots(tier: torch.Tensor, loc: torch.Tensor, t: int, first: int,
                 payload: torch.Tensor, scales: torch.Tensor | None):
    """Tier ``t``'s slots in a window: ``payload`` holds the tier's local
    rows ``[first, first + rows)``.  Returns (the payload row each slot
    reads, int64, clamped into the payload; ``mine``, the slots of tier
    ``t`` inside the window; payload and scales through ``stand_in``)."""
    li = loc.to(torch.int64) - int(first)
    mine = (tier == t) & (li >= 0) & (li < payload.shape[0])
    payload, scales = stand_in(payload, scales)
    return li.clamp(0, payload.shape[0] - 1), mine, payload, scales


def packed_bag_lookup(packed: PackedStore, indices: torch.Tensor,
                      weights: torch.Tensor | None = None,
                      firsts: tuple[int, int, int] = (0, 0, 0)
                      ) -> torch.Tensor:
    """Bag-sum lookup over a PackedStore.  indices (B, K) -> (B, D) fp32.

    Optional ``weights`` (B, K) multiply per slot.  ``firsts`` makes
    ``packed`` one shard of a row-sharded store (``dist.packed``): each
    tier's payload and scales hold its local rows ``[first, first +
    rows)`` and only slots inside that window count.  Dispatch is by the
    store's device: ``packed_bag_lookup_tiers`` on the CPU, one launch
    of the tiered kernel on CUDA (bit-identical to it)."""
    if packed.payload32.device.type == "cpu":
        return packed_bag_lookup_tiers(packed, indices, weights,
                                       firsts=firsts)
    if op_counter.on_meta(packed.payload32):
        # every id's indirect word, its row read at the widest tier's width
        return _meta_bag("dequant_bag_tiered", packed.payload32, None,
                         indices, (*packed, indices, weights),
                         ids_bytes=indices.numel() * 4)
    if indices.dtype not in (torch.int32, torch.int64):
        indices = indices.to(torch.int64)
    return dequant_bag_tiered_cuda(
        packed.indirect, packed.payload8, packed.scale8, packed.payload16,
        packed.scale16, packed.payload32, indices.contiguous(),
        None if weights is None else
        weights.to(torch.float32).contiguous(), firsts=firsts)


def packed_bag_lookup_tiers(packed: PackedStore, indices: torch.Tensor,
                            weights: torch.Tensor | None = None,
                            bag=dequant_bag,
                            firsts: tuple[int, int, int] = (0, 0, 0)
                            ) -> torch.Tensor:
    """The reference's composition: one ``bag`` (default ``dequant_bag``)
    per tier over that tier's payload, with the local indices clamped into
    it and the other tiers' slots masked by weight 0 (0 * w with
    ``weights``), the partials summed as ``zeros + int8 + half + fp32``.
    The fp32 tier passes no scales (unit scales multiply exactly).

    Tier t's payload holds local rows ``[first_t, first_t + rows_t)``
    (``window_slots``): a whole store is the window ``(0, 0, 0)``, one
    shard of a row-sharded store the reference's per-shard composition
    (``_local_bags_fused``), where a slot counts where its local row
    falls inside (``mine``, its weight ``mine * w``)."""
    tier, loc = _split(packed, indices)
    out = torch.zeros((indices.shape[0], packed.dim), dtype=torch.float32,
                      device=packed.payload32.device)
    for t, payload, scales in ((0, packed.payload8, packed.scale8),
                               (1, packed.payload16, packed.scale16),
                               (2, packed.payload32, None)):
        li, mine, payload, scales = window_slots(tier, loc, t, firsts[t],
                                                 payload, scales)
        w = mine.to(torch.float32)
        if weights is not None:
            w = w * weights
        out = out + bag(payload, scales, li.to(torch.int32).contiguous(),
                        w.contiguous())
    return out


def packed_lookup_fused(packed: PackedStore, indices: torch.Tensor
                        ) -> torch.Tensor:
    """Fused per-index serving gather.  int (...,) -> fp32 (..., D).

    The K = 1 case of ``packed_bag_lookup``: each slot's row comes from
    exactly one tier's chain (the others skip it), so the sum is
    bit-identical to ``packed_store.lookup``.
    """
    out = packed_bag_lookup(packed, indices.reshape(-1, 1))
    return out.reshape(*indices.shape, packed.dim)
