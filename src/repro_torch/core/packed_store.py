"""Tier-partitioned serving store for F-Quantization.

Port of ``repro/core/packed_store.py``.  Rows are partitioned by tier into
three dense arrays with one int32 indirection word per row:

    payload8   int8 [V8,  D]   + scale8  fp32[V8]
    payload16  bf16 [V16, D]   + scale16 fp32[V16]   (fp16 if strict)
    payload32  fp32 [V32, D]
    indirect   int32[V]        code = tier << 28 | local_index

A tier with no rows keeps a one-row placeholder (its quantized zeros), as
the reference does.  ``pack`` builds the store from a whole table;
``build_chunked`` snaps and packs chunk by chunk into preallocated tier
payloads, for tables that do not fit beside their pack (the full
``dlrm-rm2`` table is 52.3 GB fp32, a 50% pack ~27.6 GB).  Snap and pack
are row-wise, so both give the same leaves.  ``lookup`` is the plain
gather + dequant; ``lookup_fused`` is the serving path, one launch of
the fused dequant-bag kernel's tiered entry (``kernels.dequant_bag``).
``bag_matmul`` is the fused bag -> first matmul of the fused heads (one
``kernels.bag_matmul`` launch per tier); ``repack_delta`` re-tiers the
rows whose tier crossed, on the store's device.  ``extract_rows``,
``merge_stores`` and ``concat_stores`` cut and join sub-stores on the
device, bytes untouched (the shadow re-tier's pieces, ``serve.shadow``).  Every int8 tier payload
(pack, build, re-tier) is quantized by ``kernels.rowwise_quant``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import rowwise_quant as rq
from repro_torch.core.qat_store import (CHUNK_ROWS, FQuantConfig, QATStore,
                                        current_tiers, snap)
from repro_torch.core.tiers import Tier, assign_tiers, tier_counts
from repro_torch.kernels.rowwise_quant.ops import quantize_rowwise

_TIER_SHIFT = 28
_IDX_MASK = (1 << _TIER_SHIFT) - 1


class PackedStore(NamedTuple):
    payload8: torch.Tensor    # int8 [V8, D]
    scale8: torch.Tensor      # fp32 [V8]
    payload16: torch.Tensor   # bf16/fp16 [V16, D]
    scale16: torch.Tensor     # fp32 [V16]
    payload32: torch.Tensor   # fp32 [V32, D]
    indirect: torch.Tensor    # int32 [V]

    @property
    def vocab(self) -> int:
        return self.indirect.shape[0]

    @property
    def dim(self) -> int:
        return self.payload32.shape[-1]

    def nbytes(self, by_tier: bool = False):
        """Store bytes: total (default) or the per-tier breakdown
        ``{"int8", "half", "fp32", "indirect"}``.  Placeholder rows of
        empty tiers are counted: they are allocated."""
        size = [leaf.numel() * leaf.element_size() for leaf in self]
        per = {"int8": size[0] + size[1], "half": size[2] + size[3],
               "fp32": size[4], "indirect": size[5]}
        return per if by_tier else sum(per.values())


def _quantize_tier(rows: torch.Tensor, tier: Tier, cfg: FQuantConfig):
    """Quantize fp32 rows for one tier exactly as ``pack`` does:
    (payload, scale (N,) or None).  The 8-bit int8 tier goes through the
    row-wise quantization kernel (``kernels.rowwise_quant``, dividing
    form, as the eager reference ``pack`` divides by 127); other widths
    keep the torch expression, as the reference packs them with jnp."""
    if tier is Tier.INT8:
        if cfg.bits == 8:
            q, s = quantize_rowwise(rows, mode=cfg.mode, reciprocal=False)
        else:
            q, s = rq.quantize_rowwise(rows, cfg.bits, mode=cfg.mode)
        return q, s[:, 0]
    if tier is Tier.HALF:
        q, s = rq.quantize_half(rows, strict_fp16=cfg.strict_fp16,
                                scaled=cfg.scaled_half)
        return q, s[:, 0]
    return rows.to(torch.float32), None


def _assemble(parts, indirect: torch.Tensor) -> PackedStore:
    (p8, s8), (p16, s16), (p32, _) = parts
    return PackedStore(payload8=p8, scale8=s8, payload16=p16, scale16=s16,
                       payload32=p32, indirect=indirect)


def pack(store: QATStore, cfg: FQuantConfig) -> PackedStore:
    """Partition rows by tier and quantize each tier's payload, in blocks
    of ``CHUNK_ROWS`` rows into preallocated payloads (``build_chunked``
    without its snap): no temporary the size of a tier's rows exists (at
    124M x 64 the int8 tier's gathered fp32 rows alone would be ~31 GB).
    """
    table = store.table
    return _fill_chunked(lambda r0, r1: table[r0:r1],
                         current_tiers(store, cfg), table.shape[1], cfg,
                         CHUNK_ROWS, snap_rows=False)


def build_chunked(rows_fn: Callable[[int, int], torch.Tensor],
                  priority: torch.Tensor, dim: int, cfg: FQuantConfig, *,
                  chunk_rows: int) -> PackedStore:
    """Snap and pack a table chunk by chunk into preallocated payloads.

    ``rows_fn(r0, r1)`` returns fp32 table rows [r0, r1) on the device of
    ``priority``; it is called once per chunk, in order, and no more than
    ``chunk_rows`` rows of the table exist at a time.  The result equals
    ``pack(QATStore(snap(table, tiers, cfg), priority), cfg)`` leaf for
    leaf: snap and the tier quantizers are row-wise, and a tier's rows
    keep ascending global order, so local indices match ``pack``'s.
    """
    return _fill_chunked(rows_fn, assign_tiers(priority, cfg.tiers), dim,
                         cfg, chunk_rows, snap_rows=True)


def _fill_chunked(rows_fn: Callable[[int, int], torch.Tensor],
                  tiers: torch.Tensor, dim: int, cfg: FQuantConfig,
                  chunk_rows: int, snap_rows: bool) -> PackedStore:
    dev = tiers.device
    counts = tier_counts(tiers)
    half = torch.float16 if cfg.strict_fp16 else torch.bfloat16
    dtypes = (torch.int8, half, torch.float32)
    payloads = [torch.empty((max(c, 1), dim), dtype=dt, device=dev)
                for c, dt in zip(counts, dtypes)]
    scales = [torch.empty((max(c, 1),), dtype=torch.float32, device=dev)
              for c in counts[:2]] + [None]
    indirect = torch.empty(tiers.shape[0], dtype=torch.int32, device=dev)
    offset = [0, 0, 0]
    for r0 in range(0, tiers.shape[0], chunk_rows):
        r1 = min(tiers.shape[0], r0 + chunk_rows)
        tc = tiers[r0:r1]
        block = rows_fn(r0, r1).to(torch.float32)
        if snap_rows:
            block = snap(block, tc, cfg)
        for tier in Tier:
            t = int(tier.value)
            sel = torch.nonzero(tc == t).reshape(-1)
            n = sel.numel()
            if n == 0:
                continue
            q, s = _quantize_tier(block[sel], tier, cfg)
            o = offset[t]
            payloads[t][o:o + n] = q
            if s is not None:
                scales[t][o:o + n] = s
            indirect[r0 + sel] = (t << _TIER_SHIFT) | torch.arange(
                o, o + n, dtype=torch.int32, device=dev)
            offset[t] = o + n
        del block
    for tier in Tier:
        t = int(tier.value)
        if counts[t] == 0:
            # pack()'s placeholder for an empty tier: quantized zeros
            q, s = _quantize_tier(torch.zeros((1, dim), device=dev), tier,
                                  cfg)
            payloads[t].copy_(q)
            if s is not None:
                scales[t].copy_(s)
    return _assemble(list(zip(payloads, scales)), indirect)


def _split(packed: PackedStore, indices: torch.Tensor):
    code = packed.indirect[indices.to(torch.int64)]
    return code >> _TIER_SHIFT, code & _IDX_MASK


def lookup(packed: PackedStore, indices: torch.Tensor) -> torch.Tensor:
    """Gather + inline dequant.  indices: int (...,) -> fp32 (..., D).

    The plain version: three tier-local gathers and a select, the oracle
    that the fused kernel path is held to bit for bit.
    """
    tier, loc = _split(packed, indices)
    loc = loc.to(torch.int64)

    def rows(payload, scale):
        li = loc.clamp(0, payload.shape[0] - 1)
        e = payload[li].to(torch.float32)
        return e if scale is None else e * scale[li][..., None]

    e8 = rows(packed.payload8, packed.scale8)
    e16 = rows(packed.payload16, packed.scale16)
    e32 = rows(packed.payload32, None)
    t = tier[..., None]
    return torch.where(t == Tier.INT8.value, e8,
                       torch.where(t == Tier.HALF.value, e16, e32))


def lookup_fused(packed: PackedStore, indices: torch.Tensor) -> torch.Tensor:
    """Serving-path ``lookup``: one launch of the fused dequant-bag
    kernel over all three tiers, bit-identical to ``lookup`` (see
    ``kernels.dequant_bag.ops``)."""
    from repro_torch.kernels.dequant_bag.ops import packed_lookup_fused
    return packed_lookup_fused(packed, indices)


def bag_matmul(packed: PackedStore, indices: torch.Tensor, w: torch.Tensor
               ) -> torch.Tensor:
    """Fused bag -> first matmul: (B, F) global indices + (F*D, H) weights
    -> (B, H) without materialising the (B, F*D) embedding activations;
    one ``bag_matmul`` kernel launch per tier (see
    ``kernels.bag_matmul.ops.packed_bag_matmul``)."""
    from repro_torch.kernels.bag_matmul.ops import packed_bag_matmul
    return packed_bag_matmul(packed, indices, w)


def quantize_rows(table: torch.Tensor, ids: torch.Tensor,
                  tiers: torch.Tensor, cfg: FQuantConfig) -> PackedStore:
    """Quantize fp32 ``table`` rows ``ids`` into a sub-store (position
    ``i`` = ``ids[i]``), byte-identical to what ``pack`` produces for them
    under the same per-row ``tiers``.

    Port of ``repro/core/packed_store.py::quantize_rows`` on the table's
    device.  Every row runs through all three tier quantizers (row-wise,
    so a subset quantizes as inside a full ``pack``; the int8 scale
    divides by 127, as the eager ``pack``), then each tier keeps its own
    rows.  An empty tier keeps the reference's placeholder: the first
    quantized row (zeros when ``ids`` is empty) with a unit scale.  The
    reference pads the row block to a power of two so that XLA compiles
    one shape per chunk size; eager torch has no compile to spare, so
    the port does not pad (the leaves are the same).
    """
    dim = table.shape[1]
    ids = ids.reshape(-1).to(torch.int64)
    n = ids.numel()
    rows = (table[ids].to(torch.float32) if n else
            torch.zeros((1, dim), dtype=torch.float32, device=table.device))
    t = tiers[ids].to(torch.int64)
    new_ind = torch.zeros(n, dtype=torch.int32, device=table.device)
    out_p, out_s = [], []
    for tier in Tier:
        p_all, s_all = _quantize_tier(rows, tier, cfg)
        sel = torch.nonzero(t == tier.value).reshape(-1)
        if sel.numel():
            p, s = p_all[sel], None if s_all is None else s_all[sel]
        else:
            p = p_all[:1]
            s = None if s_all is None else torch.ones(
                (1,), dtype=torch.float32, device=table.device)
        new_ind[sel] = (int(tier.value) << _TIER_SHIFT) | torch.arange(
            sel.numel(), dtype=torch.int32, device=table.device)
        out_p.append(p)
        out_s.append(s)
    return PackedStore(payload8=out_p[0], scale8=out_s[0],
                       payload16=out_p[1], scale16=out_s[1],
                       payload32=out_p[2], indirect=new_ind)


def repack_delta(packed: PackedStore, store: QATStore, cfg: FQuantConfig,
                 changed_rows: torch.Tensor) -> PackedStore:
    """Incremental re-tier: migrate only tier-crossing rows.

    Port of ``repro/core/packed_store.py::repack_delta`` with torch ops
    on the packed store's device (the reference copies every payload to
    the host; at full width that is a 1.4-1.7 GB round trip per
    re-tier).  ``changed_rows`` is a candidate set; rows whose tier under
    ``current_tiers(store, cfg)`` equals their packed tier keep their
    slot byte for byte.  Crossing rows are swap-removed from their source
    tier (the surviving tail rows of that tier backfill the holes below
    the new count, their ``indirect`` words rewritten) and appended to
    their destination tier in ascending row order, quantized as ``pack``
    does; an emptied tier keeps ``pack``'s quantized-zeros placeholder.
    The same algorithm as the reference, so the leaves equal its leaves.
    Contract: the table rows are unchanged since the last (re)pack, so
    ``unpack(repack_delta(...))`` is bit-identical to ``unpack(pack(store,
    cfg))``.  The input store is not modified.
    """
    dev = packed.indirect.device
    table = store.table
    dim = packed.dim
    indirect = packed.indirect.clone()
    old_tiers = (indirect >> _TIER_SHIFT).to(torch.int64)
    new_tiers = current_tiers(store, cfg).to(torch.int64)
    cand = torch.unique(changed_rows.reshape(-1).to(torch.int64).to(dev))
    moving = cand[old_tiers[cand] != new_tiers[cand]]
    if moving.numel() == 0:
        return packed

    counts = tier_counts(old_tiers)
    payloads = [packed.payload8, packed.payload16, packed.payload32]
    scales = [packed.scale8, packed.scale16, None]

    # swap-remove movers from their source tier
    for t in range(3):
        locs = torch.sort((indirect[moving[old_tiers[moving] == t]]
                           & _IDX_MASK).to(torch.int64)).values
        if locs.numel() == 0:
            payloads[t] = payloads[t][:counts[t]]
            if scales[t] is not None:
                scales[t] = scales[t][:counts[t]]
            continue
        c2 = counts[t] - locs.numel()
        holes = locs[locs < c2]
        keep = torch.ones(counts[t] - c2, dtype=torch.bool, device=dev)
        keep[locs[locs >= c2] - c2] = False
        tail = torch.arange(c2, counts[t], device=dev)[keep]
        g_of = torch.zeros(counts[t], dtype=torch.int64, device=dev)
        g_all = torch.nonzero(old_tiers == t).reshape(-1)
        g_of[(indirect[g_all] & _IDX_MASK).to(torch.int64)] = g_all
        p = payloads[t][:c2].clone()
        p[holes] = payloads[t][tail]
        payloads[t] = p
        if scales[t] is not None:
            s = scales[t][:c2].clone()
            s[holes] = scales[t][tail]
            scales[t] = s
        indirect[g_of[tail]] = (t << _TIER_SHIFT) | holes.to(torch.int32)
        counts[t] = c2

    # append movers to their destination tier, quantized as pack() would
    for tier in Tier:
        t = int(tier.value)
        add = moving[new_tiers[moving] == t]
        if add.numel() == 0:
            continue
        newp, news = _quantize_tier(table[add].to(torch.float32), tier, cfg)
        base = counts[t]
        indirect[add] = (t << _TIER_SHIFT) | torch.arange(
            base, base + add.numel(), dtype=torch.int32, device=dev)
        payloads[t] = torch.cat([payloads[t], newp])
        if news is not None:
            scales[t] = torch.cat([scales[t], news])
        counts[t] = base + add.numel()

    # emptied tiers keep pack()'s quantized-zeros 1-row placeholder
    for tier in Tier:
        t = int(tier.value)
        if payloads[t].shape[0] == 0:
            ph, phs = _quantize_tier(
                torch.zeros((1, dim), dtype=torch.float32, device=dev),
                tier, cfg)
            payloads[t] = ph
            if phs is not None:
                scales[t] = phs
    return _assemble(list(zip(payloads, scales)), indirect)


def unpack(packed: PackedStore, r0: int = 0, r1: int | None = None
           ) -> torch.Tensor:
    """Dequantized table rows [r0, r1) (default: all), fp32 (r1 - r0, D):
    the plain ``lookup`` of those ids, as the reference's ``unpack``."""
    r1 = packed.vocab if r1 is None else r1
    return lookup(packed, torch.arange(r0, r1, device=packed.indirect.device))


def packed_tiers(packed: PackedStore) -> torch.Tensor:
    """Per-row tier materialised in ``packed``: int8 (V,) on its device."""
    return (packed.indirect >> _TIER_SHIFT).to(torch.int8)


def live_counts(packed: PackedStore) -> list[int]:
    """Per-tier live row counts, excluding an empty tier's placeholder."""
    return tier_counts(packed_tiers(packed))


def _placeholder(dtype: torch.dtype, scaled: bool, dim: int,
                 device: torch.device):
    """An empty tier's 1-row placeholder in a sub-store: a zero payload and
    a unit scale (never addressed through ``indirect``), the reference's
    convention for ``extract_rows`` and ``merge_stores``; not ``pack``'s
    quantized zeros."""
    p = torch.zeros((1, dim), dtype=dtype, device=device)
    s = (torch.ones((1,), dtype=torch.float32, device=device) if scaled
         else None)
    return p, s


def extract_rows(packed: PackedStore, rows) -> PackedStore:
    """The sub-store over global ``rows`` (int, any order, repeats allowed,
    possibly empty): position ``i`` of the result is row ``rows[i]``.

    Port of ``repro/core/packed_store.py::extract_rows`` on the store's
    device (the reference copies the store to the host).  Payload bytes
    and scales are carried over untouched, so a lookup on the sub-store
    is bit-identical to the same lookup on ``packed`` at the matching
    global ids.  A tier with no selected row keeps a 1-row zero-payload,
    unit-scale placeholder.  The leaves equal the reference's.
    """
    dev = packed.indirect.device
    rows = torch.as_tensor(rows).reshape(-1).to(device=dev,
                                                dtype=torch.int64)
    code = packed.indirect.index_select(0, rows)
    tier, loc = code >> _TIER_SHIFT, (code & _IDX_MASK).to(torch.int64)
    payloads = (packed.payload8, packed.payload16, packed.payload32)
    scales = (packed.scale8, packed.scale16, None)
    new_ind = torch.zeros(rows.numel(), dtype=torch.int32, device=dev)
    out_p, out_s = [], []
    for t in range(3):
        sel = torch.nonzero(tier == t).reshape(-1)
        n = sel.numel()
        if n:
            li = loc.index_select(0, sel)
            p = payloads[t].index_select(0, li)
            s = None if scales[t] is None else scales[t].index_select(0, li)
        else:
            p, s = _placeholder(payloads[t].dtype, scales[t] is not None,
                                packed.dim, dev)
        new_ind[sel] = (t << _TIER_SHIFT) | torch.arange(
            n, dtype=torch.int32, device=dev)
        out_p.append(p)
        out_s.append(s)
    return PackedStore(payload8=out_p[0], scale8=out_s[0],
                       payload16=out_p[1], scale16=out_s[1],
                       payload32=out_p[2], indirect=new_ind)


def merge_stores(stores) -> PackedStore:
    """N-way row concatenation: result position ``i`` is row ``i - (rows of
    the stores before it)`` of the store it falls in, in list order.

    Port of ``repro/core/packed_store.py::merge_stores`` on the stores'
    device.  One concatenation a tier (linear in the rows; a pairwise fold
    would copy earlier stores again and again).  The placeholder rows of
    emptied tiers are dropped from the middle (``live_counts``), later
    stores' local indices are rebased past the running counts, and a tier
    empty in every store keeps a zero-payload, unit-scale placeholder.
    Bytes are preserved, so lookups stay bit-identical to the sources;
    the leaves equal the reference's.
    """
    if not stores:
        raise ValueError("merge_stores needs at least one store")
    first = stores[0]
    dev = first.indirect.device
    counts = [live_counts(s) for s in stores]
    fields = (("payload8", "scale8"), ("payload16", "scale16"),
              ("payload32", None))
    out_p, out_s = [], []
    for t, (pf, sf) in enumerate(fields):
        live = [(s, c[t]) for s, c in zip(stores, counts) if c[t]]
        if live:
            p = torch.cat([getattr(s, pf)[:n] for s, n in live])
            sc = None if sf is None else torch.cat(
                [getattr(s, sf)[:n] for s, n in live])
        else:
            p, sc = _placeholder(getattr(first, pf).dtype, sf is not None,
                                 first.dim, dev)
        out_p.append(p)
        out_s.append(sc)
    parts, off = [], [0, 0, 0]
    for s, c in zip(stores, counts):
        tier = (s.indirect >> _TIER_SHIFT).to(torch.int64)
        base = torch.tensor(off, dtype=torch.int64, device=dev)[tier]
        loc = (s.indirect & _IDX_MASK).to(torch.int64) + base
        parts.append(((tier << _TIER_SHIFT) | loc).to(torch.int32))
        off = [o + n for o, n in zip(off, c)]
    return PackedStore(payload8=out_p[0], scale8=out_s[0],
                       payload16=out_p[1], scale16=out_s[1],
                       payload32=out_p[2], indirect=torch.cat(parts))


def concat_stores(a: PackedStore, b: PackedStore) -> PackedStore:
    """Append ``b``'s rows after ``a``'s: ``merge_stores([a, b])``."""
    return merge_stores([a, b])
