"""``HierStore``: the tier-partitioned store placed across three levels.

Port of ``repro/store/hier.py``.  SHARK's industrial tables "exceed
terabytes", far past device memory.  ``HierStore`` places the same
quantized rows a flat ``PackedStore`` holds across three levels:

    HOT   a ``PackedStore`` on the serving device over the priority-hot
          rows, chosen by ``budget.plan_placement`` under a byte budget
    WARM  a ``PackedStore`` in host RAM (CPU tensors) over the next rows
    COLD  mmap'd disk shards (``manifest.ColdShards``)

One lookup serves all three: ``stage()`` resolves each index's level on
the host, dequantizes the warm and cold misses into one fp32 staging
buffer (``manifest.np_lookup``, bit-identical to the device gather) and
ships it with one asynchronous copy, and ``combine_rows()`` merges the
staged rows with the hot level's fused gather (``lookup_fused``: one
launch of the tiered ``dequant_bag`` kernel).  Quantized bytes are kept
when rows move levels (``extract_rows`` / ``merge_stores``), so a
``HierStore`` lookup is bit-identical to ``packed_store.lookup`` on a
fully resident pack of the same rows.

``migrate()`` is the priority-driven re-tier and re-place: rows whose
Eq. 8 tier crossed are quantized again from the table exactly as ``pack``
quantizes them (``packed_store.quantize_rows``, whose int8 tier is the
``rowwise_quant`` kernel), rows whose rank crossed a budget boundary move
levels with their bytes, and the cold shards are written anew (atomic
publish) when the cold set changed.  It runs as plan -> build -> commit
over the pieces the chunked shadow migration (``serve.shadow``) drives
too.

Where the port differs from the reference, by design, with the same
results:

* The hot level is built on the device and kept only there (the
  reference packs the whole table on the host, keeps a numpy mirror of
  the hot level and places a copy).  ``build_hier`` never makes a whole
  pack: each level is quantized from the table in row blocks of
  ``CHUNK_ROWS`` (row-wise, so the bytes are ``pack``'s) and merged on
  the level's device.  At dlrm-rm2's 204,185,088 x 64 rows a whole pack
  beside the 52.3 GB table would not fit the card.
* A retier plan keeps the snapshot's table tensor itself (the table does
  not change while serving; only the priorities fold into a new tensor),
  where the reference copies the whole table to the host (52.3 GB).
* A level whose id list and tiers the plan leaves as they are keeps its
  live store (the reference rebuilds it byte for byte).
* Under a mesh (``build_hier(mesh=)``) the hot level is row-sharded over
  it (``dist.packed.shard_packed``: row views on one device) and its
  gather is ``sharded_lookup``.  ``hbm_budget_bytes`` is a device's: the
  planner charges each device the bytes of all the shards it holds
  (``plan_shards``).  With one shard a device that is the reference's
  per-device charge; N shards on one device hold the whole level once
  (views, one ``indirect``), so the level is mesh 1's.
  ``hot_dev``
  stays the unsharded level of record (the migrations build and cut it),
  ``served`` is what the forward reads.
* The staging buffer is one pinned host buffer a micro-batch holding the
  hot-local ids, the staging slots and the rows, copied with one
  non-blocking transfer.  PyTorch's pinned allocator does not hand the
  block out again before that copy has finished, so a next micro-batch
  cannot overwrite rows still in flight.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import packed_store as ps
from repro_torch.core.packed_store import (_IDX_MASK, _TIER_SHIFT, PackedStore,
                                           extract_rows)
from repro_torch.core.qat_store import (CHUNK_ROWS, FQuantConfig, QATStore,
                                        current_tiers)
from repro_torch.store.budget import (COLD, HOT, WARM, BudgetPlan,
                                      plan_placement)
from repro_torch.store.manifest import ColdShards, np_lookup, write_cold_shards

CPU = torch.device("cpu")


class HierConfig(NamedTuple):
    hbm_budget_bytes: int                 # the device (HOT) budget
    host_budget_bytes: int | None = None  # WARM budget; None = no cold
    rows_per_shard: int = 4096            # cold shard granularity
    store_dir: str | None = None          # required when cold is not empty


@dataclasses.dataclass
class HierStats:
    staged_rows: int = 0     # distinct rows staged (deduplicated traffic)
    warm_hits: int = 0       # valid accesses resolved from host RAM
    cold_hits: int = 0       # valid accesses resolved from disk
    migrations: int = 0
    promoted: int = 0        # rows moved toward HOT across migrations
    demoted: int = 0

    def as_dict(self) -> dict:
        return {"staged_rows": self.staged_rows,
                "warm_hits": self.warm_hits,
                "cold_hits": self.cold_hits,
                "migrations": self.migrations,
                "promoted": self.promoted, "demoted": self.demoted}


class StagedBatch(NamedTuple):
    """A batch's levels resolved, on the serving device."""
    hot_local: torch.Tensor   # int32, shape of gidx; hot-local id (0 if not)
    stage_slot: torch.Tensor  # int32, shape of gidx; staging row, -1 if none
    staging: torch.Tensor     # fp32 (capacity, D) dequantized miss rows
    warm_hits: int
    cold_hits: int
    staged: int               # distinct rows staged


class RetierPlan(NamedTuple):
    """One frozen migration decision from one (priority, tiers) snapshot.
    Built once and applied in one shot (``_migrate``) or in chunks
    (``serve.shadow.ShadowMigrate``), so both give the same store."""
    table: torch.Tensor      # the snapshot's fp32 (V, D) table (no copy)
    new_tiers: np.ndarray    # int8 (V,) Eq. 8 tiers at the fold state
    plan: BudgetPlan         # the hot / warm / cold ids
    crossed: np.ndarray      # bool (V,): tier differs from the packed one
    tiers_dev: torch.Tensor  # ``new_tiers`` on the table's device


class _LevelBuilder:
    """Fills one level's ``PackedStore`` in place, position ``i`` = the
    level's ``i``-th id: each tier's rows in ascending position, one
    indirection word a position, an empty tier's zero / unit-scale
    placeholder row.  These are the leaves ``extract_rows`` gives (what
    the reference's ``extract_rows(merge_stores(parts), perm)`` gives),
    written once into preallocated payloads: no merged copy and no
    permuted copy of the level exist beside it (at dlrm-rm2's 4 GiB hot
    level those copies did not fit the card beside the 52.3 GB table).
    """

    def __init__(self, tiers: np.ndarray, dim: int, dtypes,
                 device: torch.device):
        t = np.asarray(tiers, np.int64)
        self.device = device
        counts = np.bincount(t, minlength=3)[:3]
        slot = np.empty(t.size, np.int64)
        for k in range(3):
            m = t == k
            slot[m] = np.arange(int(counts[k]))
        self.slot = slot
        self.payload, self.scale = [], []
        for k, dt in enumerate(dtypes):
            c = max(int(counts[k]), 1)
            p = torch.empty((c, dim), dtype=dt, device=device)
            s = (torch.empty((c,), dtype=torch.float32, device=device)
                 if k < 2 else None)
            if not counts[k]:
                p.zero_()
                if s is not None:
                    s.fill_(1.0)
            self.payload.append(p)
            self.scale.append(s)
        self.indirect = torch.from_numpy(
            ((t << _TIER_SHIFT) | slot).astype(np.int32)).to(device)

    def copy(self, src: PackedStore, loc: np.ndarray, pos: np.ndarray
             ) -> None:
        """Rows ``loc`` of ``src`` (their bytes, tiers unchanged) into
        positions ``pos``: gathered on ``src``'s device, copied over in one
        block a tier."""
        sdev = src.indirect.device
        code = src.indirect.index_select(0, torch.from_numpy(
            np.asarray(loc, np.int64)).to(sdev))
        tier = code >> _TIER_SHIFT
        sl = (code & _IDX_MASK).to(torch.int64)
        dest = torch.from_numpy(self.slot[pos]).to(self.device)
        for k, (p, s) in enumerate(((src.payload8, src.scale8),
                                    (src.payload16, src.scale16),
                                    (src.payload32, None))):
            m = torch.nonzero(tier == k).reshape(-1)
            if not m.numel():
                continue
            li = sl.index_select(0, m)
            d = dest.index_select(0, m.to(self.device))
            self.payload[k].index_copy_(
                0, d, p.index_select(0, li).to(self.device))
            if s is not None:
                self.scale[k].index_copy_(
                    0, d, s.index_select(0, li).to(self.device))

    def quantize(self, table: torch.Tensor, ids: np.ndarray,
                 tiers: torch.Tensor, cfg: FQuantConfig, pos: np.ndarray,
                 chunk_rows: int = CHUNK_ROWS) -> None:
        """Table rows ``ids`` quantized as ``pack`` would under ``tiers`` (on
        the table's device, ``chunk_rows`` at a time; the int8 tier through
        the ``rowwise_quant`` kernel) into positions ``pos``."""
        for c0 in range(0, ids.size, chunk_rows):
            sel = torch.from_numpy(ids[c0:c0 + chunk_rows]).to(table.device)
            q = ps.quantize_rows(table, sel, tiers, cfg)
            self.copy(q, np.arange(sel.numel()), pos[c0:c0 + chunk_rows])

    def store(self) -> PackedStore:
        return PackedStore(payload8=self.payload[0], scale8=self.scale[0],
                           payload16=self.payload[1], scale16=self.scale[1],
                           payload32=self.payload[2], indirect=self.indirect)


def _dtypes(packed: PackedStore) -> tuple:
    return (packed.payload8.dtype, packed.payload16.dtype,
            packed.payload32.dtype)


def _quantized_level(table: torch.Tensor, ids: np.ndarray,
                     tiers: np.ndarray, tiers_dev: torch.Tensor,
                     cfg: FQuantConfig, device: torch.device) -> PackedStore:
    """A level quantized from the table: rows ``ids`` as ``pack`` would
    store them, on ``device``."""
    half = torch.float16 if cfg.strict_fp16 else torch.bfloat16
    b = _LevelBuilder(tiers[ids], table.shape[1],
                      (torch.int8, half, torch.float32), device)
    b.quantize(table, ids, tiers_dev, cfg, np.arange(ids.size))
    return b.store()


@dataclasses.dataclass
class HierStore:
    """The mutable three-level owner.  The bookkeeping (levels, slots,
    tiers, ids) is numpy on the host; ``hot_dev`` lives on ``device``,
    ``warm`` in host RAM."""
    cfg: HierConfig
    dim: int
    level: np.ndarray        # int8 (V,) HOT / WARM / COLD
    slot: np.ndarray         # int64 (V,) level-local row id
    tiers: np.ndarray        # int8 (V,) Eq. 8 tier currently packed
    hot_ids: np.ndarray
    warm_ids: np.ndarray
    cold_ids: np.ndarray
    hot_dev: PackedStore     # the hot level, on ``device``
    warm: PackedStore        # the warm level, CPU tensors
    cold: ColdShards | None
    device: torch.device = CPU
    stats: HierStats = dataclasses.field(default_factory=HierStats)
    mesh: object = None      # a ``dist.Mesh``: the hot level row-sharded
    axis: str = "model"
    hot_shards: object = None  # ``hot_dev``'s ShardedPack under the mesh

    @property
    def vocab(self) -> int:
        return self.level.shape[0]

    @property
    def n_shards(self) -> int:
        """The planner's ``n_shards`` (``plan_shards``)."""
        return plan_shards(self.mesh, self.axis)

    @property
    def served(self):
        """What the forward's gather reads: the hot level, or its row
        shards under the mesh."""
        return self.hot_dev if self.mesh is None else self.hot_shards

    def counts(self) -> dict:
        return {"hot_rows": int(self.hot_ids.size),
                "warm_rows": int(self.warm_ids.size),
                "cold_rows": int(self.cold_ids.size)}

    def nbytes(self) -> dict:
        """The bytes each level holds."""
        return {"hot": self.hot_dev.nbytes(), "warm": self.warm.nbytes(),
                "cold": 0 if self.cold is None else self.cold.nbytes()}

    def level_device(self, lev: int) -> torch.device:
        return self.device if lev == HOT else CPU

    # -- placement -----------------------------------------------------

    def place(self) -> None:
        """The hot level on the serving device (built there already), row
        sharded over the mesh when there is one."""
        from repro_torch.dist.packed import place_packed
        self.hot_dev = place_packed(self.hot_dev, device=self.device)
        if self.mesh is not None:
            self.hot_shards = place_packed(self.hot_dev, self.mesh,
                                           self.axis)

    def lookup_fn(self) -> Callable:
        """The hot level's gather: the fused serving gather, or
        ``sharded_lookup`` under the mesh (over ``served``)."""
        if self.mesh is None:
            return ps.lookup_fused
        from repro_torch.dist.packed import sharded_lookup
        mesh, axis = self.mesh, self.axis
        return lambda pk, idx: sharded_lookup(pk, idx, mesh=mesh, axis=axis)

    # -- lookup path ---------------------------------------------------

    def stage(self, gidx, *, skip=None, valid=None) -> StagedBatch:
        """``_stage`` in the ``store.stage`` span (with the staging
        counters when metrics are on)."""
        with obs.span("store.stage"):
            return self._stage(gidx, skip=skip, valid=valid)

    def _stage(self, gidx, *, skip=None, valid=None) -> StagedBatch:
        """Resolve each index's level and stage the warm and cold misses.

        ``gidx``: int global row ids (numpy or a tensor), any shape.
        ``skip`` (bool, same shape) marks positions that need no row (hot
        cache hits): neither staged nor counted.  ``valid`` keeps
        micro-batch padding out of the hit counts only (padding still
        stages, into the slots of the live accesses it duplicates).

        Each distinct missing row is dequantized once into a
        ``gidx.size``-row fp32 buffer; the buffer, the hot-local ids and
        the staging slots go to the device in one copy.
        """
        if isinstance(gidx, torch.Tensor):
            gidx = gidx.cpu().numpy()
        g = np.asarray(gidx, np.int64)
        flat = g.reshape(-1)
        n = flat.size
        lev = self.level[flat]
        need = lev != HOT
        if skip is not None:
            need &= ~np.asarray(skip, bool).reshape(-1)
        miss_pos = np.nonzero(need)[0]
        uniq, inv = np.unique(flat[miss_pos], return_inverse=True)

        cap = max(n, 1)
        buf = torch.empty(2 * n + cap * self.dim, dtype=torch.int32,
                          pin_memory=self.device.type == "cuda")
        host = buf.numpy()
        host[:n] = np.where(lev == HOT, self.slot[flat], 0)
        stage_slot = host[n:2 * n]
        stage_slot[:] = -1
        stage_slot[miss_pos] = inv
        rows = host[2 * n:].view(np.float32).reshape(cap, self.dim)
        rows[uniq.size:] = 0
        ulev = self.level[uniq]
        uslot = self.slot[uniq]
        wm = ulev == WARM
        if wm.any():
            rows[np.nonzero(wm)[0]] = np_lookup(self.warm, uslot[wm])
        cm = ulev == COLD
        if cm.any():
            rows[np.nonzero(cm)[0]] = self.cold.gather_fp32(uslot[cm])

        vm = (np.ones(n, bool) if valid is None else
              np.broadcast_to(np.asarray(valid, bool), g.shape).reshape(-1))
        counted = lev[miss_pos[vm[miss_pos]]]
        warm_hits = int((counted == WARM).sum())
        cold_hits = int((counted == COLD).sum())
        self.stats.staged_rows += int(uniq.size)
        self.stats.warm_hits += warm_hits
        self.stats.cold_hits += cold_hits
        if obs.enabled():
            # staged_rows counts the distinct rows shipped; miss_dedup what
            # the dedup saved against staging every miss
            obs.inc("store.staged_rows", int(uniq.size))
            obs.inc("store.miss_dedup", int(miss_pos.size - uniq.size))
            obs.inc("store.warm_hits", warm_hits)
            obs.inc("store.cold_hits", cold_hits)
            obs.gauge("store.staging_bytes", float(rows.nbytes))
        dev = buf.to(self.device, non_blocking=True)
        return StagedBatch(
            hot_local=dev[:n].view(g.shape),
            stage_slot=dev[n:2 * n].view(g.shape),
            staging=dev[2 * n:].view(torch.float32).view(cap, self.dim),
            warm_hits=warm_hits, cold_hits=cold_hits, staged=int(uniq.size))

    def gather_fp32_host(self, ids) -> np.ndarray:
        """Dequantized rows for any global ids, on the host (cache builds,
        checks), bit-identical to the device path: the hot level's rows
        are cut out on the device and dequantized on the host like the
        others."""
        g = np.asarray(ids, np.int64)
        flat = g.reshape(-1)
        out = np.empty((flat.size, self.dim), np.float32)
        lev = self.level[flat]
        m = np.nonzero(lev == HOT)[0]
        if m.size:
            loc = torch.from_numpy(self.slot[flat[m]]).to(self.device)
            sub = extract_rows(self.hot_dev, loc)
            out[m] = np_lookup(PackedStore(*(x.cpu() for x in sub)),
                               np.arange(m.size))
        m = np.nonzero(lev == WARM)[0]
        if m.size:
            out[m] = np_lookup(self.warm, self.slot[flat[m]])
        m = np.nonzero(lev == COLD)[0]
        if m.size:
            out[m] = self.cold.gather_fp32(self.slot[flat[m]])
        return out.reshape(*g.shape, self.dim)

    # -- migration -----------------------------------------------------

    def migrate(self, store: QATStore, cfg: FQuantConfig) -> dict:
        """``_migrate`` in the ``store.migrate`` span, with the moved-row
        counters and the level gauges when metrics are on."""
        with obs.span("store.migrate"):
            out = self._migrate(store, cfg)
        if obs.enabled():
            obs.inc("store.migrate.promoted", out["promoted"])
            obs.inc("store.migrate.demoted", out["demoted"])
            obs.inc("store.migrate.crossed", out["crossed"])
            for k, v in self.counts().items():
                obs.gauge(f"store.{k}", float(v))
            for k, v in self.nbytes().items():
                obs.gauge(f"store.{k}_bytes", float(v))
        return out

    def plan_retier(self, store: QATStore, cfg: FQuantConfig) -> RetierPlan:
        """Freeze one migration decision from the current fold state: the
        Eq. 8 tiers, the placement and the crossed rows.  Reads only."""
        tiers_dev = current_tiers(store, cfg)
        new_tiers = tiers_dev.cpu().numpy()
        plan = plan_placement(store.priority, tiers_dev, self.dim,
                              self.cfg.hbm_budget_bytes,
                              self.cfg.host_budget_bytes, self.n_shards)
        return RetierPlan(table=store.table, new_tiers=new_tiers, plan=plan,
                          crossed=new_tiers != self.tiers,
                          tiers_dev=tiers_dev)

    def build_rows(self, ids: np.ndarray, rp: RetierPlan, cfg: FQuantConfig,
                   device: torch.device = CPU) -> PackedStore:
        """One level's store (or a run of consecutive ids of it) under the
        frozen plan, on ``device``: rows whose tier is unchanged carry
        their bytes from the live level that holds them (a cold one from
        its shard), crossed rows are quantized from the snapshot table as
        ``pack`` would.  Position ``i`` = ``ids[i]``, so consecutive runs
        of a level's ids merge (``merge_stores``) into what one call
        gives.  The leaves are the reference's."""
        b = _LevelBuilder(rp.new_tiers[ids], self.dim, _dtypes(self.hot_dev),
                          device)
        crossed = rp.crossed[ids]
        keep = np.nonzero(~crossed)[0]
        lev = self.level[ids[keep]]
        for k, src in ((HOT, self.hot_dev), (WARM, self.warm)):
            pos = keep[lev == k]
            if pos.size:
                b.copy(src, self.slot[ids[pos]], pos)
        pos = keep[lev == COLD]
        if pos.size:
            for k, at, loc in self.cold._by_shard(self.slot[ids[pos]]):
                b.copy(self.cold._shards[k], loc, pos[at])
        req = np.nonzero(crossed)[0]
        if req.size:
            b.quantize(rp.table, ids[req], rp.tiers_dev, cfg, req)
        return b.store()

    def level_changed(self, rp: RetierPlan, lev: int) -> bool:
        """Whether the plan moves rows into or out of level ``lev`` or
        re-tiers one of its rows (otherwise the live level is reused)."""
        new = (rp.plan.hot_ids, rp.plan.warm_ids, rp.plan.cold_ids)[lev]
        old = (self.hot_ids, self.warm_ids, self.cold_ids)[lev]
        return (new.size != old.size or not np.array_equal(new, old)
                or bool(rp.crossed[new].any()))

    def cold_changed(self, rp: RetierPlan) -> bool:
        """Whether the plan moves or re-tiers any cold row (the live cold
        shards serve on as they are otherwise)."""
        return self.level_changed(rp, COLD)

    def build_level(self, rp: RetierPlan, cfg: FQuantConfig,
                    lev: int) -> PackedStore:
        """The hot or warm level under the plan: the live store when the
        plan leaves the level as it is, else ``build_rows``."""
        if not self.level_changed(rp, lev):
            return self.hot_dev if lev == HOT else self.warm
        ids = (rp.plan.hot_ids, rp.plan.warm_ids)[lev]
        return self.build_rows(ids, rp, cfg, self.level_device(lev))

    def commit_retier(self, rp: RetierPlan, new_hot: PackedStore,
                      new_warm: PackedStore, new_cold: ColdShards | None,
                      hot_dev: PackedStore | None = None) -> dict:
        """Flip the live state to the built generation.

        The one mutation point of the synchronous ``migrate`` and the
        chunked shadow path: everything before it is built to the side,
        so a discard before the commit leaves the live store untouched.
        ``new_cold`` is already published under ``cfg.store_dir`` (or is
        the live object, or None when the plan has no cold level).
        ``hot_dev``, when given, is ``new_hot`` already on the device.
        """
        plan = rp.plan
        promoted = int(np.count_nonzero(plan.level < self.level))
        demoted = int(np.count_nonzero(plan.level > self.level))
        self.cold = new_cold
        self.hot_dev = new_hot if hot_dev is None else hot_dev
        self.warm = new_warm
        self.hot_ids, self.warm_ids = plan.hot_ids, plan.warm_ids
        self.cold_ids = plan.cold_ids
        self.level = plan.level
        self.slot = _slots(plan)
        self.tiers = rp.new_tiers
        self.place()
        self.stats.migrations += 1
        self.stats.promoted += promoted
        self.stats.demoted += demoted
        return {"promoted": promoted, "demoted": demoted,
                "crossed": int(np.count_nonzero(rp.crossed))}

    def _migrate(self, store: QATStore, cfg: FQuantConfig) -> dict:
        """Priority-driven re-tier and re-place across the levels: plan ->
        build -> commit.  Afterwards lookups equal ``pack(store, cfg)``
        lookups (``repack_delta``'s contract, across levels)."""
        rp = self.plan_retier(store, cfg)
        plan = rp.plan
        new_hot = self.build_level(rp, cfg, HOT)
        new_warm = self.build_level(rp, cfg, WARM)
        new_cold = self.cold
        if plan.cold_ids.size and self.cold_changed(rp):
            if self.cfg.store_dir is None:
                raise ValueError("cold spill requires store_dir")
            write_cold_shards(self.cfg.store_dir,
                              self.build_rows(plan.cold_ids, rp, cfg),
                              plan.cold_ids, self.cfg.rows_per_shard)
            new_cold = ColdShards(self.cfg.store_dir)
        elif not plan.cold_ids.size:
            new_cold = None
        return self.commit_retier(rp, new_hot, new_warm, new_cold)

    def level_block(self, lev: int, c0: int, c1: int) -> PackedStore:
        """The live level's sub-store of positions [c0, c1), its bytes."""
        if lev == COLD:
            return self.cold.extract(np.arange(c0, c1))
        src = self.hot_dev if lev == HOT else self.warm
        return extract_rows(src, torch.arange(c0, c1,
                                              device=src.indirect.device))

    def mismatch_pack(self, store: QATStore, cfg: FQuantConfig,
                      lookup_fn: Callable = ps.lookup) -> torch.Tensor:
        """Whether any row of the live levels looks up otherwise than in a
        fresh ``pack`` of ``store`` (``mismatch_pack`` level by level; the
        hot level through ``lookup_fn``)."""
        bad = torch.zeros((), dtype=torch.bool, device=store.table.device)
        for lev, ids in ((HOT, self.hot_ids), (WARM, self.warm_ids),
                         (COLD, self.cold_ids)):
            bad |= mismatch_pack(
                store, cfg, ids,
                lambda c0, c1, lev=lev: self.level_block(lev, c0, c1),
                lookup_fn if lev == HOT else ps.lookup)
        return bad

    # -- checkpointing -------------------------------------------------

    def state_tree(self) -> dict:
        """The checkpointable manifest (the cold shards are on disk already,
        under ``cfg.store_dir``): the reference's keys, the levels'
        stores as tensors."""
        return {"schema": "hier_store/v1",
                "vocab": self.vocab, "dim": self.dim,
                "hbm_budget_bytes": int(self.cfg.hbm_budget_bytes),
                "level": self.level, "slot": self.slot,
                "tiers": self.tiers,
                "hot_ids": self.hot_ids, "warm_ids": self.warm_ids,
                "cold_ids": self.cold_ids,
                "hot": self.hot_dev, "warm": self.warm}


def mismatch_pack(store: QATStore, cfg: FQuantConfig, ids: np.ndarray,
                  block: Callable, lookup_fn: Callable = ps.lookup,
                  chunk_rows: int = CHUNK_ROWS) -> torch.Tensor:
    """Whether any of rows ``ids`` (one level's, in order) looks up
    otherwise than in a fresh ``pack`` of ``store``: a 0-d bool on the
    table's device, to be read once.  In blocks of ``chunk_rows``:
    ``block(c0, c1)`` is the level's sub-store of positions [c0, c1) (its
    bytes, on any device), looked up on the table's device through
    ``lookup_fn``; the reference is the pack of the block's own rows
    (row-wise, so the whole pack's bytes)."""
    table, pri = store.table, store.priority
    dev = table.device
    bad = torch.zeros((), dtype=torch.bool, device=dev)
    for c0 in range(0, ids.size, chunk_rows):
        c1 = min(ids.size, c0 + chunk_rows)
        sel = torch.from_numpy(ids[c0:c1]).to(dev)
        ref = ps.unpack(ps.pack(QATStore(table[sel], pri[sel]), cfg))
        sub = PackedStore(*(x.to(dev) for x in block(c0, c1)))
        got = lookup_fn(sub, torch.arange(c1 - c0, device=dev))
        bad |= (ref.view(torch.int32) != got.view(torch.int32)).any()
    return bad


def _slots(plan: BudgetPlan) -> np.ndarray:
    """Each row's level-local id under ``plan``."""
    slot = np.zeros(plan.level.shape[0], np.int64)
    for ids in (plan.hot_ids, plan.warm_ids, plan.cold_ids):
        slot[ids] = np.arange(ids.size)
    return slot


def plan_shards(mesh=None, axis: str = "model") -> int:
    """The planner's ``n_shards``, so that each device is charged the bytes
    of all the shards it holds: the mesh's size over the most shards one
    device holds.  One shard a device: the mesh's size, as the reference;
    N shards on one device: 1, the whole level once (the shards are views
    of it, ``indirect`` is held once)."""
    if mesh is None:
        return 1
    from repro_torch.dist.mesh import check_mesh
    return max(1, check_mesh(mesh, axis) // mesh.shards_per_device())


def build_hier(store: QATStore, cfg: FQuantConfig, hcfg: HierConfig,
               mesh=None, axis: str = "model") -> HierStore:
    """Plan and build the three levels from a ``QATStore`` on the serving
    device: the placement from the priorities, each level quantized from
    the table as ``pack`` would (``_quantized_level``), the hot level kept
    on the device, the warm one in host RAM, the cold one written as
    shards under ``hcfg.store_dir``.  ``mesh`` (a ``dist.Mesh``)
    row-shards the hot level; the planner charges each device the shards
    it holds (``plan_shards``)."""
    dev = store.table.device
    tiers_dev = current_tiers(store, cfg)
    tiers = tiers_dev.cpu().numpy()
    dim = store.table.shape[1]
    plan = plan_placement(store.priority, tiers_dev, dim,
                          hcfg.hbm_budget_bytes, hcfg.host_budget_bytes,
                          plan_shards(mesh, axis))
    if plan.cold_ids.size and hcfg.store_dir is None:
        raise ValueError("cold spill requires HierConfig.store_dir")
    hot = _quantized_level(store.table, plan.hot_ids, tiers, tiers_dev, cfg,
                           dev)
    warm = _quantized_level(store.table, plan.warm_ids, tiers, tiers_dev,
                            cfg, CPU)
    cold = None
    if plan.cold_ids.size:
        write_cold_shards(hcfg.store_dir,
                          _quantized_level(store.table, plan.cold_ids, tiers,
                                           tiers_dev, cfg, CPU),
                          plan.cold_ids, hcfg.rows_per_shard)
        cold = ColdShards(hcfg.store_dir)
    hier = HierStore(cfg=hcfg, dim=dim, level=plan.level, slot=_slots(plan),
                     tiers=tiers, hot_ids=plan.hot_ids,
                     warm_ids=plan.warm_ids, cold_ids=plan.cold_ids,
                     hot_dev=hot, warm=warm, cold=cold, device=dev,
                     mesh=mesh, axis=axis)
    hier.place()
    return hier


def combine_rows(hot_dev: PackedStore, hot_local: torch.Tensor,
                 stage_slot: torch.Tensor, staging: torch.Tensor,
                 lookup_fn: Callable | None = None) -> torch.Tensor:
    """The hot level's fused gather where a position is hot, the staged
    row where it was staged: bit-identical to ``packed_store.lookup`` on
    a fully resident store."""
    rows = (lookup_fn or ps.lookup_fused)(hot_dev, hot_local)
    staged = staging[stage_slot.clamp(0, staging.shape[0] - 1).to(
        torch.int64)]
    return torch.where((stage_slot >= 0)[..., None], staged, rows)


def hier_lookup(hier: HierStore, indices,
                lookup_fn: Callable | None = None) -> torch.Tensor:
    """The three-level ``lookup``: int (...,) -> fp32 (..., D), on the
    serving device."""
    sb = hier.stage(indices)
    return combine_rows(hier.served, sb.hot_local, sb.stage_slot,
                        sb.staging, lookup_fn or hier.lookup_fn())


def hier_bag_lookup(hier: HierStore, indices, segment_ids: torch.Tensor,
                    num_bags: int, weights: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """The three-level bag lookup, as the reference's: rows (times
    ``weights``) summed into ``num_bags`` bags (``index_add_``, the
    reference's ``segment_sum``: in index order on the CPU; on a card the
    atomics' order).  No serving path runs it; the served bags are the
    head's."""
    rows = hier_lookup(hier, indices)
    if weights is not None:
        rows = rows * weights.to(rows.device)[:, None]
    out = torch.zeros((num_bags, hier.dim), dtype=torch.float32,
                      device=rows.device)
    return out.index_add_(0, segment_ids.to(device=rows.device,
                                            dtype=torch.int64), rows)
