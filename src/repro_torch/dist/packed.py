"""Row-sharded serving and training paths for the tier-partitioned store.

Port of ``repro/dist/packed.py``.  At terabyte-table scale the packed
payloads cannot live on one device: ``shard_packed`` row-shards every
payload and scale over the mesh's axis and holds the 4-byte ``indirect``
word once a device (the only per-row state every shard needs).  The
lookups then run the reference's scheme:

  1. every shard decodes tier and local row from the replicated indirect,
  2. gathers and dequantizes the rows it owns (other shards' slots weigh
     0 and read nothing),
  3. one ``psum`` assembles full embeddings (lookup) or per-bag sums
     (bag), or the (B, H) first-layer activations (``sharded_bag_matmul``).

Shard ``i`` owns tier t's local rows ``[i * s_t, (i + 1) * s_t)`` with the
reference's stride ``s_t = ceil(V_t / n)``.  The reference pads each
payload up to ``n * s_t`` rows; its pad rows are unaddressable (``indirect``
holds only real local rows), so the port does not allocate them: the last
shard's rows are fewer, possibly none.  On one device (``make_mesh(n)``)
each shard is a row view of the store, so sharding copies nothing and
``unshard_packed`` is the store itself; on distinct devices each shard is
copied to its own, shard 0 too, so that no card pins the whole store
(``shares_device`` says which).

Step 2 is one launch a shard of the dequant-bag kernel's tiered entry
with the shard's window (``dequant_bag_tiered_cuda(firsts=)``; on the CPU
its plain version, the reference's per-shard composition), where the
reference makes one kernel call a tier a shard (``_local_bags_fused``).
``_local_rows`` is the reference's gather/where oracle.  ``psum`` adds
the shards' partials in shard order on the mesh's first device.

``sharded_lookup_train`` is the training twin over the fp32 table,
placed as the reference's ``place_train_state`` places it: a
``RowShards`` leaf (``place_rows``) holds shard ``i``'s rows on
``mesh.devices[i]``, row views of one table on a one-device mesh and
tensors of their own across devices.  Each shard runs the ``dequant_bag``
forward on its rows on its device, and the backward runs ``bag_grad`` a
shard into that shard's own (rows, D) gradient, so no (V, D) gradient
exists on any device.  ``train_plan`` builds each shard's slots once a
step and ``owned_slots`` hands each shard its own slots for the per-shard
post-step.  The stages after training read a placed table through the
same leaf: ``x[r0:r1]`` (a row block) and ``x[ids]`` (a row gather) read
each row from the shard that owns it and assemble the rows on the mesh's
first device, and ``row_pieces`` hands a stage each shard's window to
write in place on its own device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.packed_store import (_IDX_MASK, _TIER_SHIFT,
                                           PackedStore)
from repro_torch.core.tiers import Tier
from repro_torch.dist.mesh import Mesh, check_mesh, psum

ROW_SHARDED = "rows"      # a leaf split by rows over the mesh axis
REPLICATED = "replicated"  # a leaf held whole on every device


def packed_pspecs(axis: str = "model") -> PackedStore:
    """Which leaves are row-sharded and which replicated: the payloads and
    scales split by rows over ``axis``, ``indirect`` replicated (the
    reference's PartitionSpec tree, as (kind, axis) pairs)."""
    rows = (ROW_SHARDED, axis)
    return PackedStore(payload8=rows, scale8=rows, payload16=rows,
                       scale16=rows, payload32=rows,
                       indirect=(REPLICATED, None))


def shard_stride(rows: int, n: int) -> int:
    """The rows each shard owns of a leaf of ``rows`` rows: ceil(rows / n),
    the reference's padded shard share."""
    return -(-int(rows) // n)


def shard_window(rows: int, n: int, i: int) -> tuple[int, int]:
    """Shard ``i``'s (first row, row count) of a leaf of ``rows`` rows split
    ``n`` ways at ``shard_stride``: the last shards may own fewer rows,
    or none."""
    s = shard_stride(rows, n)
    first = i * s
    return first, max(0, min(s, int(rows) - first))


class ShardedPack:
    """A ``PackedStore`` row-sharded over a ``Mesh``.

    ``shards[i]`` is shard ``i``'s store: each tier's payload and scales
    its rows (local rows ``firsts[i][t]`` on), ``indirect`` the replicated
    word on its device.  ``base`` is the whole store when every shard is
    a view of it (one device), else None.  The serving surface reads
    ``vocab``, ``dim`` and ``indirect`` as on a ``PackedStore``.
    """

    def __init__(self, shards, firsts, tier_rows, mesh: Mesh,
                 base: PackedStore | None):
        self.shards = tuple(shards)
        self.firsts = tuple(tuple(int(f) for f in fs) for fs in firsts)
        self.tier_rows = tuple(int(r) for r in tier_rows)
        self.mesh = mesh
        self.base = base

    @property
    def indirect(self) -> torch.Tensor:
        return self.shards[0].indirect

    @property
    def vocab(self) -> int:
        return int(self.indirect.shape[0])

    @property
    def dim(self) -> int:
        return int(self.shards[0].payload32.shape[-1])

    def nbytes(self) -> int:
        """The unpadded store's bytes (payloads and scales once, the
        indirection words once): what ``unshard_packed`` holds."""
        total = self.indirect.numel() * self.indirect.element_size()
        for sh in self.shards:
            total += sum(x.numel() * x.element_size() for x in sh[:5])
        return int(total)


def shares_device(mesh: Mesh) -> bool:
    """True when every shard of ``mesh`` lives on one device: placing a
    leaf (``place_rows``) or a store (``shard_packed``) then makes row
    views of it, else a copy a shard."""
    return len(mesh.distinct_devices()) == 1


def shard_packed(packed: PackedStore, mesh: Mesh,
                 axis: str = "model") -> ShardedPack:
    """Row-shard ``packed`` over ``axis`` at the reference's stride.  On a
    one-device mesh the shards are views (copies when the store lies on
    another device); across devices every shard's windows are copies,
    shard 0's on the store's own device too, so no shard pins the whole
    store.  ``indirect`` once a distinct device."""
    if isinstance(packed, ShardedPack):
        packed = unshard_packed(packed)
    n = check_mesh(mesh, axis)
    src = packed.indirect.device
    copy = not shares_device(mesh)
    rows = [packed.payload8.shape[0], packed.payload16.shape[0],
            packed.payload32.shape[0]]
    indirect = {d: packed.indirect.to(d) for d in mesh.distinct_devices()}
    shards, firsts = [], []
    for i, dev in enumerate(mesh.devices):
        win = [shard_window(r, n, i) for r in rows]

        def cut(x, t):
            f, c = win[t]
            return x[f:f + c].to(dev, copy=copy)
        shards.append(PackedStore(
            payload8=cut(packed.payload8, 0), scale8=cut(packed.scale8, 0),
            payload16=cut(packed.payload16, 1),
            scale16=cut(packed.scale16, 1),
            payload32=cut(packed.payload32, 2), indirect=indirect[dev]))
        firsts.append(tuple(f for f, _ in win))
    base = (packed if not copy and all(d == src for d in mesh.devices)
            else None)
    return ShardedPack(shards, firsts, rows, mesh, base)


def place_packed(packed: PackedStore, mesh: Mesh | None = None,
                 axis: str = "model", device=None):
    """The serving placement: ``shard_packed`` under a mesh; otherwise the
    store itself, or its leaves moved to ``device`` when given.  The one
    helper the online server, the shadow re-tier and the hier store
    share."""
    if mesh is not None:
        return shard_packed(packed, mesh, axis)
    if device is None:
        return packed
    return PackedStore(*(leaf.to(device) for leaf in packed))


def shard_nbytes(packed, n: int) -> int:
    """Per-device bytes of ``packed`` row-sharded ``n`` ways, as the
    reference counts them: each payload and scale contributes its padded
    share ``ceil(rows / n)`` rows, the ``indirect`` word in full (the
    number ``store.budget.hot_shard_bytes`` charges the hier planner).
    The port allocates no pad rows, so the bytes it holds can be fewer."""
    if isinstance(packed, ShardedPack):
        leaves = list(packed.shards[0])
        rows = [packed.tier_rows[0], packed.tier_rows[0],
                packed.tier_rows[1], packed.tier_rows[1],
                packed.tier_rows[2], packed.vocab]
    else:
        leaves = list(packed)
        rows = [leaf.shape[0] for leaf in leaves]
    total = 0
    for leaf, r, (kind, _) in zip(leaves, rows, packed_pspecs()):
        per_row = math.prod(leaf.shape[1:]) * leaf.element_size()
        total += (r if kind == REPLICATED else shard_stride(r, n)) * per_row
    return int(total)


def unshard_packed(packed: ShardedPack) -> PackedStore:
    """The whole store: on one device the store the shards are views of
    (no copy); across devices the shards' rows concatenated on the mesh's
    first device.  Inverse of ``shard_packed``: the leaves hold each
    tier's live rows (an emptied tier its one-row placeholder), as the
    reference's trimmed host copy."""
    if packed.base is not None:
        return packed.base
    dev = packed.mesh.device

    def cat(field):
        return torch.cat([getattr(sh, field).to(dev)
                          for sh in packed.shards])
    return PackedStore(payload8=cat("payload8"), scale8=cat("scale8"),
                       payload16=cat("payload16"), scale16=cat("scale16"),
                       payload32=cat("payload32"),
                       indirect=packed.indirect.to(dev))


def _on(x: torch.Tensor | None, dev: torch.device, memo: dict):
    """``x`` on ``dev``, moved once a device per call."""
    if x is None:
        return None
    if dev not in memo:
        memo[dev] = x.to(dev)
    return memo[dev]


def _local_rows(shard: PackedStore, firsts, indices: torch.Tensor
                ) -> torch.Tensor:
    """The rows this shard owns, dequantized fp32; zeros elsewhere (the
    reference's gather/where oracle): int (...,) -> fp32 (..., D)."""
    from repro_torch.kernels.dequant_bag.ops import window_slots
    code = shard.indirect[indices.to(torch.int64)]
    tier, loc = code >> _TIER_SHIFT, code & _IDX_MASK

    def gather(payload, scale, t):
        li, mine, payload, scale = window_slots(tier, loc, t, firsts[t],
                                                payload, scale)
        rows = payload[li].to(torch.float32)
        if scale is not None:
            rows = rows * scale[li][..., None]
        return torch.where(mine[..., None], rows, 0.0)

    return (gather(shard.payload8, shard.scale8, Tier.INT8.value)
            + gather(shard.payload16, shard.scale16, Tier.HALF.value)
            + gather(shard.payload32, None, Tier.FP32.value))


def _shard_bags(packed: ShardedPack, indices: torch.Tensor,
                weights: torch.Tensor | None) -> torch.Tensor:
    """(B, K) ids -> (B, D): one windowed tiered launch a shard, the
    partials summed in shard order."""
    from repro_torch.kernels.dequant_bag.ops import packed_bag_lookup
    ids, ws = {}, {}

    def parts():
        for sh, firsts in zip(packed.shards, packed.firsts):
            dev = sh.indirect.device
            yield packed_bag_lookup(sh, _on(indices, dev, ids),
                                    _on(weights, dev, ws), firsts=firsts)
    return psum(parts(), packed.mesh)


def _check_sharded(packed, mesh, axis: str) -> None:
    if not isinstance(packed, ShardedPack):
        raise TypeError("the sharded paths take a ShardedPack "
                        "(shard_packed / place_packed under a mesh), got "
                        f"{type(packed).__name__}")
    if mesh is not None and check_mesh(mesh, axis) != packed.mesh.size:
        raise ValueError(f"store sharded {packed.mesh.size} ways, mesh "
                         f"{mesh.size}")


def sharded_lookup(packed: ShardedPack, indices: torch.Tensor, *,
                   mesh: Mesh | None = None, axis: str = "model"
                   ) -> torch.Tensor:
    """Distributed ``packed_store.lookup``: int (...,) -> fp32 (..., D) on
    the mesh's first device.  K = 1 bags, one launch a shard; bit-identical
    to the plain ``lookup`` (each row comes from exactly one shard, the
    others add exact zeros)."""
    _check_sharded(packed, mesh, axis)
    rows = _shard_bags(packed, indices.reshape(-1, 1), None)
    return rows.reshape(*indices.shape, packed.dim)


def sharded_bag_lookup_rect(packed: ShardedPack, indices: torch.Tensor, *,
                            mesh: Mesh | None = None, axis: str = "model",
                            weights: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Distributed rectangular embedding bag: (B, K) ids [+ (B, K) weights]
    -> (B, D), one windowed tiered launch a shard and one (B, D) sum."""
    _check_sharded(packed, mesh, axis)
    return _shard_bags(packed, indices, weights)


def sharded_bag_lookup(packed: ShardedPack, indices: torch.Tensor,
                       segment_ids: torch.Tensor, num_bags: int, *,
                       mesh: Mesh | None = None, axis: str = "model",
                       weights: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Distributed ``packed_store.bag_lookup``: a shard's rows
    (``_local_rows``, times ``weights``) summed into ``num_bags`` bags by
    ``segment_ids`` (``index_add_``, the reference's ``segment_sum``), the
    (num_bags, D) partials summed in shard order.  On CUDA ``index_add_``
    adds a bag's rows with atomics in no fixed order, as ``segment_sum``
    does on a GPU."""
    _check_sharded(packed, mesh, axis)
    ids, segs, ws, parts = {}, {}, {}, []
    for sh, firsts in zip(packed.shards, packed.firsts):
        dev = sh.indirect.device
        rows = _local_rows(sh, firsts, _on(indices, dev, ids))
        w = _on(weights, dev, ws)
        if w is not None:
            rows = rows * w.to(torch.float32)[:, None]
        out = torch.zeros((num_bags, packed.dim), dtype=torch.float32,
                          device=dev)
        parts.append(out.index_add_(
            0, _on(segment_ids, dev, segs).to(torch.int64), rows))
    return psum(parts, packed.mesh)


def sharded_bag_matmul(packed: ShardedPack, indices: torch.Tensor,
                       w: torch.Tensor, *, mesh: Mesh | None = None,
                       axis: str = "model",
                       weights: torch.Tensor | None = None,
                       int8_direct: bool = False) -> torch.Tensor:
    """Distributed ``packed_bag_matmul``: (B, F) ids + (F*D, H) first-layer
    weights -> (B, H).  Each shard runs ``bag_matmul`` once a tier over
    its rows (other shards' and tiers' slots weighted 0, a shard owning
    no row of a tier reads a one-row zero stand-in), its partial
    ``zeros + int8 + half + fp32``; the (B, H) partials are summed in shard
    order.  ``int8_direct`` is the kernel's ``scale_after`` on the int8
    tier."""
    from repro_torch.kernels.bag_matmul.ops import _as_w3, bag_matmul
    from repro_torch.kernels.dequant_bag.ops import window_slots
    _check_sharded(packed, mesh, axis)
    b, f = indices.shape
    w3 = _as_w3(w, f, packed.dim).to(torch.float32)
    ids, ws, w3s, parts = {}, {}, {}, []
    for sh, firsts in zip(packed.shards, packed.firsts):
        dev = sh.indirect.device
        idx = _on(indices, dev, ids)
        wts = _on(weights, dev, ws)
        w3d = _on(w3, dev, w3s)
        code = sh.indirect[idx.to(torch.int64)]
        tier, loc = code >> _TIER_SHIFT, code & _IDX_MASK
        out = torch.zeros((b, w3.shape[-1]), dtype=torch.float32,
                          device=dev)
        for t, payload, scale in ((Tier.INT8.value, sh.payload8, sh.scale8),
                                  (Tier.HALF.value, sh.payload16,
                                   sh.scale16),
                                  (Tier.FP32.value, sh.payload32, None)):
            li, mine, payload, scale = window_slots(tier, loc, t, firsts[t],
                                                    payload, scale)
            wt = mine.to(torch.float32)
            if wts is not None:
                wt = wt * wts
            out = out + bag_matmul(
                payload, scale, li.to(torch.int32), wt, w3d,
                scale_after=int8_direct and t == Tier.INT8.value)
        parts.append(out)
    return psum(parts, packed.mesh)


def spread_rows(local: torch.Tensor, mine: torch.Tensor, glob: torch.Tensor,
                rows: int) -> torch.Tensor:
    """Local rows for a shard's kernels: the shard's own slots keep theirs,
    the others (weight 0: no kernel reads or scatters them) get ``glob mod
    rows``, spread over the shard.  The reference clamps them to the
    shard's edge rows instead; in ``bag_grad``'s grouping that piles ~(N -
    1) / N of the slots onto two rows, runs that its block-a-run path walks
    one slot after another."""
    return torch.where(mine, local, glob.remainder(max(rows, 1))).to(
        torch.int32).contiguous()


def train_windows(rows: int, mesh: Mesh, axis: str = "model",
                  divide: bool = True) -> tuple:
    """Each shard's (first row, rows) of a training table or pool of
    ``rows`` rows; ``divide`` requires the axis to divide the rows, as the
    reference's table placement does."""
    n = check_mesh(mesh, axis)
    if divide and rows % n:
        raise ValueError(f"table rows {rows} not divisible by mesh axis "
                         f"{axis}={n}")
    return tuple(shard_window(rows, n, i) for i in range(n))


class RowShards:
    """A row-aligned training leaf (the table, its row-wise adagrad
    accumulator, the Eq. 7 priority, the access EMA) placed a shard a
    device, as the reference's ``P(axis, None)`` / ``P(axis)``:
    ``shards[i]`` holds rows ``windows[i]`` on ``mesh.devices[i]``.

    ``base`` is the whole leaf when every shard is a row view of it (a
    one-device mesh: placing copies nothing), else None.  The train step
    reads and writes the shards only; ``whole()`` gathers the leaf (the
    base itself, or the shards concatenated on the mesh's first
    device).  The later stages read rows without the whole: ``x[r0:r1]``
    (``rows``) and ``x[ids]`` (``gather``), each row from its shard,
    through the shards even when they are views."""

    def __init__(self, shards, mesh: Mesh, axis: str = "model",
                 base: torch.Tensor | None = None):
        self.shards = tuple(shards)
        if len(self.shards) != check_mesh(mesh, axis):
            raise ValueError(f"{len(self.shards)} shards for a mesh of "
                             f"{mesh.size}")
        self.windows = train_windows(sum(int(s.shape[0])
                                         for s in self.shards), mesh, axis)
        for i, (s, (_, r), d) in enumerate(zip(self.shards, self.windows,
                                               mesh.devices)):
            if s.shape[0] != r or s.device != d:
                raise ValueError(f"shard {i}: {s.shape[0]} rows on "
                                 f"{s.device}, expected {r} on {d}")
        self.mesh = mesh
        self.axis = axis
        self.base = base

    @property
    def shape(self) -> torch.Size:
        f, r = self.windows[-1]
        return torch.Size((f + r, *self.shards[0].shape[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def whole(self) -> torch.Tensor:
        if self.base is not None:
            return self.base
        return torch.cat([s.to(self.mesh.device) for s in self.shards])

    def like(self, shards) -> "RowShards":
        """New shards in this placement (an out-of-place update's)."""
        return RowShards(shards, self.mesh, self.axis)

    def rows(self, r0: int, r1: int) -> torch.Tensor:
        """Rows [r0, r1) on the mesh's first device: each shard's part of
        the block copied from its device, in row order."""
        dev = self.mesh.device
        parts = []
        for s, (f, r) in zip(self.shards, self.windows):
            lo, hi = max(r0, f), min(r1, f + r)
            if lo < hi:
                parts.append(s[lo - f:hi - f].to(dev))
        if not parts:
            return torch.empty((0, *self.shape[1:]), dtype=self.dtype,
                               device=dev)
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def gather(self, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``ids`` (any shape of int) -> (*ids.shape, ...) on the mesh's
        first device: each shard gathers the ids it owns on its own device
        and its rows are written into their slots.  An id out of range
        raises, as a tensor's gather does."""
        dev = self.mesh.device
        flat = ids.reshape(-1).to(torch.int64).to(dev)
        v = self.shape[0]
        if flat.numel() and not bool(((flat >= 0) & (flat < v)).all()):
            raise IndexError(f"row id out of range for {v} rows")
        out = torch.empty((flat.numel(), *self.shape[1:]), dtype=self.dtype,
                          device=dev)
        owner = torch.div(flat, self.windows[0][1], rounding_mode="floor")
        for i, (s, (f, _)) in enumerate(zip(self.shards, self.windows)):
            sel = torch.nonzero(owner == i).reshape(-1)
            if sel.numel():
                out[sel] = s[(flat[sel] - f).to(s.device)].to(dev)
        return out.reshape(*ids.shape, *self.shape[1:])

    def __getitem__(self, key):
        """``x[r0:r1]`` -> ``rows``, ``x[ids]`` (an integer tensor) ->
        ``gather``; nothing else (a placed leaf is written through its
        shards, ``row_pieces``)."""
        if isinstance(key, slice) and key.step in (None, 1):
            r0, r1, _ = key.indices(self.shape[0])
            return self.rows(r0, max(r0, r1))
        if isinstance(key, torch.Tensor) and not (
                key.is_floating_point() or key.dtype == torch.bool):
            return self.gather(key)
        raise TypeError(f"a RowShards leaf reads a row block or an id "
                        f"tensor, not {key!r}")


def place_rows(x: torch.Tensor, mesh: Mesh, axis: str = "model"
               ) -> RowShards:
    """``x`` row-sharded over ``axis`` at ``train_windows``: on a
    one-device mesh row views of ``x`` moved there (its ``base``); else
    each window copied to its shard's device, the shard on ``x``'s own
    device included, so that no shard pins the whole."""
    windows = train_windows(x.shape[0], mesh, axis)
    if shares_device(mesh):
        x = x.to(mesh.device)
        return RowShards([x[f:f + r] for f, r in windows], mesh, axis,
                         base=x)
    return RowShards([x[f:f + r].to(d, copy=True)
                      for (f, r), d in zip(windows, mesh.devices)],
                     mesh, axis)


def whole(x):
    """A ``RowShards`` leaf gathered whole; any other leaf as it is."""
    return x.whole() if isinstance(x, RowShards) else x


def row_pieces(x) -> list[tuple[int, torch.Tensor]]:
    """(first global row, rows) of each shard of a ``RowShards`` leaf, on
    its own device (views of the base on one device); a tensor is one
    piece from row 0.  Writes to a piece land in the leaf."""
    if isinstance(x, RowShards):
        return [(f, s) for s, (f, _) in zip(x.shards, x.windows)]
    return [(0, x)]


class TrainPlan(NamedTuple):
    """A batch's K = 1 slots over a placed table, built once a step.

    ``local`` / ``mine``: each shard's local rows (int32, ``spread_rows``)
    and mine mask as weights (fp32), (N, 1) on the shard's device, for its
    kernels.  ``order`` / ``counts``: on the mesh's first device, the slot
    ids grouped by owning shard (shard 0's first, each group in slot
    order) and the slots each shard owns, for the per-shard post-step
    (``owned_slots``)."""
    local: tuple
    mine: tuple
    order: torch.Tensor
    counts: torch.Tensor


def train_plan(flat: torch.Tensor, windows, mesh: Mesh) -> TrainPlan:
    """flat (N, 1) int64 global rows on the mesh's first device ->
    ``TrainPlan``: each shard's local rows and mask computed on its own
    device from a copy of the ids.  Nothing here waits on a device."""
    ids, local, mine = {}, [], []
    for (first, rows), dev in zip(windows, mesh.devices):
        f = _on(flat, dev, ids)
        li = f - first
        m = (li >= 0) & (li < rows)
        local.append(spread_rows(li, m, f, rows))
        mine.append(m.to(torch.float32).contiguous())
    owner = torch.div(flat.reshape(-1), windows[0][1], rounding_mode="floor")
    counts = torch.zeros(len(windows), dtype=torch.int64, device=flat.device)
    return TrainPlan(tuple(local), tuple(mine),
                     torch.argsort(owner, stable=True),
                     counts.scatter_add_(0, owner, torch.ones_like(owner)))


def owned_slots(plan: TrainPlan, mesh: Mesh, sizes, *values: torch.Tensor
                ) -> list[tuple]:
    """Each shard's own slots of the (N,) ``values`` (on the mesh's first
    device), in slot order, on the shard's device: one tuple a shard.
    ``sizes`` is ``plan.counts`` read on the host (a step reads it with
    its loss, in one wait)."""
    groups = [torch.split(v.reshape(-1)[plan.order], list(sizes))
              for v in values]
    return [tuple(g[i].to(dev) for g in groups)
            for i, dev in enumerate(mesh.devices)]


class ShardedBagTrain(torch.autograd.Function):
    """The K = 1 training gather over a placed fp32 table: ``plan`` (a
    ``TrainPlan``) and one (rows, D) table shard a mesh shard, each on its
    device -> (N, D) on the mesh's first device.  Forward: one
    ``dequant_bag`` a shard over its rows with its mine mask as weights,
    on its device, summed in shard order by ``psum``.  Backward: the
    cotangent copied to each shard's device and one ``bag_grad`` a shard
    into that shard's own (rows, D) gradient, so no (V, D) tensor exists
    on any device.  Each row's slots all lie in one shard, in (b, k)
    order, so each shard's gradient rows are the unsharded ones bit for
    bit."""

    @staticmethod
    def forward(ctx, plan, mesh, *shards):
        from repro_torch.kernels.dequant_bag.ops import dequant_bag
        parts = (dequant_bag(sh, None, li, m)
                 for sh, li, m in zip(shards, plan.local, plan.mine))
        ctx.plan = plan
        ctx.rows = tuple(int(sh.shape[0]) for sh in shards)
        return psum(parts, mesh)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels.dequant_bag.ops import bag_grad
        g = g.to(torch.float32).contiguous()
        gs = {}
        grads = tuple(bag_grad(_on(g, li.device, gs), None, li, m, r)
                      for li, m, r in zip(ctx.plan.local, ctx.plan.mine,
                                          ctx.rows))
        return (None, None, *grads)


class _SplitRows(torch.autograd.Function):
    """A whole table -> its ``place_rows`` shards; backward the shards'
    gradients concatenated into the table's one (V, D) gradient."""

    @staticmethod
    def forward(ctx, table, mesh, axis):
        ctx.device = table.device
        return place_rows(table, mesh, axis).shards

    @staticmethod
    def backward(ctx, *grads):
        return torch.cat([g.to(ctx.device) for g in grads]), None, None


def sharded_lookup_train(table, indices: torch.Tensor, *,
                         mesh: Mesh | None = None, axis: str = "model"
                         ) -> torch.Tensor:
    """Differentiable row-sharded gather over the fp32 training table:
    int (...,) -> fp32 (..., D) on the mesh's first device.  The training
    twin of ``sharded_lookup`` (``ShardedBagTrain``).  ``table`` is a
    ``RowShards`` (its shards get the gradients, each its own) or a whole
    table over ``mesh`` (placed by ``place_rows``; its gradient is the
    shards' concatenated).  The mesh's axis must divide the rows
    (``FieldSpec.total_rows`` is 512-padded for exactly this)."""
    if isinstance(table, RowShards):
        mesh, windows, shards = table.mesh, table.windows, table.shards
    else:
        windows = train_windows(table.shape[0], mesh, axis)
        shards = _SplitRows.apply(table, mesh, axis)
    flat = indices.reshape(-1, 1).to(torch.int64).to(mesh.device)
    out = ShardedBagTrain.apply(train_plan(flat, windows, mesh), mesh,
                                *shards)
    return out.reshape(*indices.shape, table.shape[1])


__all__ = [
    "RowShards",
    "ShardedBagTrain",
    "ShardedPack",
    "TrainPlan",
    "owned_slots",
    "packed_pspecs",
    "place_packed",
    "place_rows",
    "row_pieces",
    "shard_nbytes",
    "shard_packed",
    "shard_window",
    "shares_device",
    "sharded_bag_lookup",
    "sharded_bag_lookup_rect",
    "sharded_bag_matmul",
    "sharded_lookup",
    "sharded_lookup_train",
    "train_plan",
    "train_windows",
    "unshard_packed",
    "whole",
]
