"""Hot-row cache: top-K rows by live priority, held dequantized in fp32.

Port of ``repro/serve/cache.py``.  The Eq. 7 scores that pick the fp32
tier also pick the cache residents; the cache is consulted before the
store's gather: hits read a contiguous fp32 (K, D) array, misses go to
the store (the tier-partitioned pack, or the hashed pool of
``store.hashed``).  Cache rows are exact copies of what the store's
gather returns for them, so the cached gather is bit-identical to the
plain lookup: served values do not depend on the cache's contents, only
the hit counts do.  Under a mesh the miss gather is the backend's sharded
``lookup_fn`` over its row shards (``dist.packed.sharded_lookup``), with
the hits redirected to row 0 as on one device.

``build_cache`` takes the top k by a stable descending sort, so among
tied scores the lower row id comes first, as ``jax.lax.top_k`` does
(after one fold most scores tie: they are counts times 0.99).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import packed_store as ps
from repro_torch.core.packed_store import PackedStore

LookupFn = Callable[..., torch.Tensor]   # (store, ids) -> rows


class HotRowCache(NamedTuple):
    ids: torch.Tensor      # int32 [K] global row ids resident in the cache
    rows: torch.Tensor     # fp32 [max(K, 1), D] dequantized payloads
    slot_of: torch.Tensor  # int32 [V] global row -> cache slot, -1 = none

    @property
    def capacity(self) -> int:
        return self.ids.shape[0]


def empty_cache(vocab: int, dim: int, device) -> HotRowCache:
    """Disabled cache on ``device`` (the store's; no default, so no caller
    leaves one on the CPU by omission): every lookup misses (rows kept
    (1, D) so gathers stay well-formed)."""
    return HotRowCache(
        ids=torch.zeros((0,), dtype=torch.int32, device=device),
        rows=torch.zeros((1, dim), dtype=torch.float32, device=device),
        slot_of=torch.full((vocab,), -1, dtype=torch.int32, device=device))


def cache_from_rows(ids: torch.Tensor, rows: torch.Tensor,
                    vocab: int) -> HotRowCache:
    """Assemble a cache from already-dequantized rows; ``rows[i]`` must be
    the exact dequantized payload of global row ``ids[i]``."""
    ids = ids.to(torch.int32)
    k = ids.shape[0]
    if k <= 0 or vocab <= 0:
        return empty_cache(vocab, rows.shape[-1], rows.device)
    slot_of = torch.full((vocab,), -1, dtype=torch.int32, device=ids.device)
    slot_of[ids.to(torch.int64)] = torch.arange(k, dtype=torch.int32,
                                                device=ids.device)
    return HotRowCache(ids=ids, rows=rows.to(torch.float32),
                       slot_of=slot_of)


def top_rows(priority: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` highest-priority rows, ties to the lower id: int64 (k,).

    Equal to the first ``k`` of a stable descending sort, without sorting
    all V scores: every row of the top k scores at least the k-th
    largest score, so the rows at or above it (ascending ids) are sorted
    stably and the first k kept.
    """
    if k <= 0:
        return torch.zeros((0,), dtype=torch.int64, device=priority.device)
    if k >= priority.numel():
        return torch.sort(priority, descending=True, stable=True).indices
    kth = torch.topk(priority, k).values[-1]
    cand = torch.nonzero(priority >= kth).reshape(-1)
    order = torch.sort(priority[cand], descending=True, stable=True).indices
    return cand[order[:k]]


def build_cache(packed: PackedStore, priority: torch.Tensor, k: int,
                lookup_fn: LookupFn | None = None) -> HotRowCache:
    """Populate with the current top-``k`` rows by priority score; their
    rows come from ``lookup_fn`` (default the fused serving gather,
    bit-identical to ``packed_store.lookup``).  Rebuilt after every
    re-tier: the payloads it mirrors just changed."""
    k = int(min(k, packed.vocab))
    if k <= 0:
        return empty_cache(packed.vocab, packed.dim,
                           packed.indirect.device)
    ids = top_rows(priority, k).to(torch.int32)
    rows = (lookup_fn or ps.lookup_fused)(packed, ids)
    return cache_from_rows(ids, rows, packed.vocab)


def cache_select(cache: HotRowCache, indices: torch.Tensor,
                 rows: torch.Tensor, valid: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cache-first select over already-gathered fallback ``rows``:
    (selected (..., D), hit count as a 0-d tensor; ``valid`` masks
    padding out of the count only)."""
    slot = cache.slot_of[indices.to(torch.int64)]
    hit = slot >= 0
    cached = cache.rows[slot.clamp(0, cache.rows.shape[0] - 1).to(
        torch.int64)]
    counted = hit if valid is None else hit & valid.expand(hit.shape)
    return torch.where(hit[..., None], cached, rows), counted.sum()


def cached_lookup(packed, cache: HotRowCache, indices: torch.Tensor,
                  lookup_fn: LookupFn | None = None,
                  valid: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cache-first gather: int (...,) -> (fp32 (..., D), hit count).

    Hits read ``cache.rows``; misses go through ``lookup_fn(packed, ids)``
    (the packed store's fused serving gather by default; the hashed
    backend passes its pool and ``hashed_lookup``) over the full id set
    with hit positions redirected to row 0, so the gather touches only
    the miss set's rows.  Bit-identical to ``lookup_fn(packed, indices)``
    for any cache whose rows that gather made.
    """
    hit = cache.slot_of[indices.to(torch.int64)] >= 0
    miss_idx = torch.where(hit, torch.zeros_like(indices), indices)
    cold = (lookup_fn or ps.lookup_fused)(packed, miss_idx)
    return cache_select(cache, indices, cold, valid)
