"""Embedding-store backends and their registry.

Port of ``repro/store/api.py`` for the flat packed, the three-level
hierarchical and the hashed backends, on one device or row-sharded over a
``dist.Mesh`` (``mesh=``).  Each answers the surface the online server
and its loop dispatch on, so the request path has no backend branches:

  identity     kind, device, vocab, dim, nbytes(), live_counts(), mesh,
               axis; the packed and hier backends' priority
  lookups      lookup(idx), bag_lookup(idx, w): eager, uncached
  serving      packed (the store the forward reads), lookup_fn(),
               bag_matmul_fn(), build_cache(k), cache_mask (the host mask
               of cached rows a staging backend skips; None for the
               others), cached_lookup(cache, mask, idx) (the eager
               cache-first request path), needs_staging (True only for
               hier, whose misses stage through the host: stage_host),
               gather_fp32_host(ids), occupancy() (the ``store.*``
               gauges, reference names)
  adaptation   fold_priority(idx, pcfg) (the eager Eq. 7 fold,
               ``priority.serve_fold``, as the reference's un-jitted
               ``serve_update`` computes it), retier(), and the shadow
               re-tier's prewarm_retier(rows) and begin_retier(rows)
               (a ``serve.shadow.ShadowRepack`` for the packed store, a
               ``ShadowMigrate`` for hier, None for the hashed pool)
  persistence  snapshot_manifest(), from_manifest(tree)

``PackedBackend``: the ``QATStore`` (table + Eq. 7 priority) is
authoritative and ``packed`` is its serving pack.  The reference keeps a
host pack and places a device copy; the port packs on the device and
serves that pack directly, so ``host_packed`` (the pack of record, the
reference's name) is that same device pack.  Under a mesh ``packed`` is
its ``dist.packed.ShardedPack`` (row views on one device), the gathers
are ``sharded_lookup`` / ``sharded_bag_matmul``, and ``host_packed`` is
``unshard_packed(packed)``: on one device the pack itself, so a re-tier
(unshard, ``repack_delta``, reshard) copies no row it does not move.  ``HierBackend``: the
``store.hier.HierStore`` over the same ``QATStore``: the priority-hot rows
on the device under a byte budget, the next in host RAM, the rest in
mmap'd cold shards; a re-tier migrates rows between the levels.
``HashedBackend``: the ROBE-style pool of ``store.hashed``; rows
materialise through the ``hashed_gather`` kernel, a re-tier moves no rows
(pool slots are shared) and only refreshes the hot-row cache, whose rows
are materialised on the card through the same kernel; under a mesh the
request path's gather is ``dist.hashed.sharded_hashed_lookup`` over the
row-sharded pool, the eager lookups and the cache rows the unsharded
gather, as the reference's.  Persistence:
``snapshot_manifest`` and ``from_manifest`` (``packed_store/v1``: the
pack and the priorities; ``hier_store/v1``; ``hashed_store/v1``),
round-tripped through ``ckpt.CheckpointManager`` in the reference's
format.

Registry: ``register_backend(name, factory)`` + ``build(name, ...)``
over ``packed``, ``hier`` and ``hashed``; ``from_manifest`` picks the
backend by the manifest's kind tag.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import packed_store as ps
from repro_torch.core.priority import PriorityConfig, serve_fold
from repro_torch.core.qat_store import FQuantConfig, QATStore, current_tiers
from repro_torch.core.tiers import tier_crossings
from repro_torch.dist import packed as DP
from repro_torch.dist.mesh import check_mesh
from repro_torch.kernels.dequant_bag.ops import packed_bag_lookup
from repro_torch.serve import cache as C
from repro_torch.store import hashed as H


class PackedBackend:
    """Flat tier-partitioned store, on one device or row-sharded over a
    mesh."""

    kind = "packed"
    needs_staging = False
    cache_mask = None
    hier = None

    def __init__(self, store: QATStore, cfg: FQuantConfig, *, mesh=None,
                 axis: str = "model", packed: ps.PackedStore | None = None):
        """``packed`` adopts a pack of ``store`` (a restored manifest's)
        instead of packing; ``mesh`` (a ``dist.Mesh``) row-shards it."""
        if mesh is not None:
            check_mesh(mesh, axis)
        self.store = store
        self.cfg = cfg
        self.mesh = mesh
        self.axis = axis
        self.packed = DP.place_packed(
            ps.pack(store, cfg) if packed is None else packed, mesh, axis)

    @property
    def device(self) -> torch.device:
        return self.packed.indirect.device

    @property
    def host_packed(self) -> ps.PackedStore:
        """The pack of record (the reference's host pack): the device pack
        the forward reads, unsharded under a mesh (on one device the pack
        the shards are views of)."""
        if self.mesh is None:
            return self.packed
        return DP.unshard_packed(self.packed)

    @property
    def vocab(self) -> int:
        return int(self.packed.vocab)

    @property
    def dim(self) -> int:
        return int(self.packed.dim)

    @property
    def priority(self) -> torch.Tensor:
        return self.store.priority

    def nbytes(self) -> int:
        return int(self.packed.nbytes())

    def live_counts(self) -> dict:
        """Rows a tier (reads the tier vector back to the host)."""
        counts = ps.live_counts(self.packed)
        return {"int8": int(counts[0]), "half": int(counts[1]),
                "fp32": int(counts[2])}

    def occupancy(self) -> dict:
        """The occupancy gauges of the flat store."""
        out = {"store.packed_bytes": float(self.packed.nbytes())}
        for name, n in self.live_counts().items():
            out[f"store.tier_rows_{name}"] = float(n)
        return out

    # -- serving surface -----------------------------------------------

    def gather_fp32_host(self, ids) -> np.ndarray:
        """fp32 rows ``ids`` through the plain ``lookup``, on the host."""
        idx = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)
        return ps.lookup(self.host_packed, idx).cpu().numpy()

    def lookup_fn(self) -> Callable:
        if self.mesh is None:
            return ps.lookup_fused
        mesh, axis = self.mesh, self.axis
        return lambda pk, idx: DP.sharded_lookup(pk, idx, mesh=mesh,
                                                 axis=axis)

    def bag_matmul_fn(self) -> Callable:
        if self.mesh is None:
            return ps.bag_matmul
        mesh, axis = self.mesh, self.axis
        return lambda pk, idx, w: DP.sharded_bag_matmul(pk, idx, w,
                                                        mesh=mesh, axis=axis)

    def build_cache(self, cache_rows: int) -> C.HotRowCache:
        return C.build_cache(self.packed, self.store.priority, cache_rows,
                             self.lookup_fn())

    def cached_lookup(self, cache: C.HotRowCache, cache_mask, indices,
                      valid: torch.Tensor | None = None):
        """The eager cache-first request path: (rows, hit count)."""
        return C.cached_lookup(self.packed, cache, indices, self.lookup_fn(),
                               valid=valid)

    # -- lookups (eager) -----------------------------------------------

    def lookup(self, indices: torch.Tensor) -> torch.Tensor:
        return self.lookup_fn()(self.packed, indices)

    def bag_lookup(self, indices: torch.Tensor,
                   weights: torch.Tensor | None = None) -> torch.Tensor:
        if self.mesh is None:
            return packed_bag_lookup(self.packed, indices, weights)
        return DP.sharded_bag_lookup_rect(self.packed, indices,
                                          mesh=self.mesh, axis=self.axis,
                                          weights=weights)

    # -- adaptation ----------------------------------------------------

    def fold_priority(self, indices: torch.Tensor, pcfg: PriorityConfig,
                      valid: torch.Tensor | None = None) -> None:
        """The eager Eq. 7 fold (``priority.serve_fold``), as the
        reference's eager ``serve_update`` computes it."""
        self.store = self.store._replace(
            priority=serve_fold(self.store.priority, indices, pcfg,
                                valid=valid))

    def prewarm_retier(self, chunk_rows: int) -> None:
        """The reference's warm call of a shadow chunk: three zero rows
        through ``quantize_rows``.  Eager torch has nothing to compile;
        the call keeps the protocol and checks the quantizers run on the
        store's device."""
        dev = self.device
        ps.quantize_rows(torch.zeros((3, self.dim), device=dev),
                         torch.arange(3, device=dev),
                         torch.arange(3, device=dev), self.cfg)

    def begin_retier(self, chunk_rows: int):
        """A ``ShadowRepack`` against the current fold state, or None when
        no row's tier crossed.  ``chunk_rows`` (the reference's fixed
        quantize shape) keeps the protocol: the caller gives each step its
        budget."""
        from repro_torch.serve.shadow import ShadowRepack
        sh = ShadowRepack(self.host_packed, self.store, self.cfg, self.mesh,
                          self.axis)
        return sh if sh.moved else None

    def retier(self) -> dict:
        """Synchronous delta re-tier of the rows whose tier crossed: under
        a mesh unshard, ``repack_delta``, reshard, on the device."""
        live = self.host_packed
        old = ps.packed_tiers(live)
        new = current_tiers(self.store, self.cfg)
        changed, _ = tier_crossings(old, new)
        n = int(changed.numel())
        if n:
            self.packed = DP.place_packed(
                ps.repack_delta(live, self.store, self.cfg, changed),
                self.mesh, self.axis)
        return {"rows_moved": n, "changed": bool(n)}

    # -- persistence ---------------------------------------------------

    def snapshot_manifest(self) -> dict:
        return {"kind": "packed_store/v1", "packed": self.host_packed,
                "priority": self.store.priority}

    @classmethod
    def from_manifest(cls, tree: dict, *, store: QATStore | None = None,
                      cfg: FQuantConfig | None = None, mesh=None,
                      axis: str = "model",
                      device: str | torch.device | None = None):
        """Rebuild from ``snapshot_manifest`` output (or the reference's
        numpy leaves).  ``store`` / ``cfg`` re-attach the training-side
        state the pack was made from (the pack itself is the artifact of
        record); without ``store`` the table is the unpacked pack."""
        packed = ps.PackedStore(*(_tensor(x, device) for x in tree["packed"]))
        priority = _tensor(tree["priority"], device)
        if store is None:
            store = QATStore(table=ps.unpack(packed), priority=priority)
        else:
            store = store._replace(priority=priority)
        return cls(store, cfg, mesh=mesh, axis=axis, packed=packed)


class HierBackend(PackedBackend):
    """Three-level store: the device holds the priority-hot rows, host RAM
    the warm spill, mmap'd cold shards the rest.  Misses stage through
    the host (``needs_staging``); the fused bag -> matmul head needs a
    fully resident store and is refused."""

    kind = "hier"
    needs_staging = True
    host_packed = None

    def __init__(self, store: QATStore, cfg: FQuantConfig, hier_cfg=None, *,
                 mesh=None, axis: str = "model", hier=None):
        """``hier`` adopts a built ``HierStore`` (a restored manifest's)
        instead of building one from ``store`` under ``hier_cfg``;
        ``mesh`` row-shards its hot level (the planner then charges each
        device its shard's bytes)."""
        from repro_torch.store.hier import build_hier
        if mesh is not None:
            check_mesh(mesh, axis)
        self.store = store
        self.cfg = cfg
        self.mesh = mesh
        self.axis = axis
        self.hier = (hier if hier is not None
                     else build_hier(store, cfg, hier_cfg, mesh=mesh,
                                     axis=axis))
        self.cache_mask: np.ndarray | None = None

    @property
    def packed(self):
        """The hot level on the device (its row shards under a mesh): what
        the forward's gather reads."""
        return self.hier.served

    def lookup_fn(self) -> Callable:
        return self.hier.lookup_fn()

    @property
    def device(self) -> torch.device:
        return self.hier.device

    @property
    def vocab(self) -> int:
        return int(self.hier.vocab)

    @property
    def dim(self) -> int:
        return int(self.hier.dim)

    def nbytes(self) -> int:
        return int(sum(self.hier.nbytes().values()))

    def live_counts(self) -> dict:
        return dict(self.hier.counts())

    def place(self) -> None:
        self.hier.place()

    def bag_matmul_fn(self) -> Callable:
        raise ValueError("fused bag->matmul serving requires a fully "
                         "resident packed store (no hier)")

    def stage_host(self, gidx, *, skip=None, valid=None):
        return self.hier.stage(gidx, skip=skip, valid=valid)

    def cached_lookup(self, cache: C.HotRowCache, cache_mask, indices,
                      valid: torch.Tensor | None = None):
        """Stage (skipping the cached rows), combine, then the cache-first
        select: (rows, hit count)."""
        from repro_torch.store.hier import combine_rows
        g = (indices.cpu().numpy() if isinstance(indices, torch.Tensor)
             else np.asarray(indices)).astype(np.int64)
        skip = cache_mask[g] if cache_mask is not None else None
        vnp = None if valid is None else valid.cpu().numpy()
        sb = self.hier.stage(g, skip=skip, valid=vnp)
        rows = combine_rows(self.packed, sb.hot_local, sb.stage_slot,
                            sb.staging, self.lookup_fn())
        idx = torch.as_tensor(indices).to(self.device)
        return C.cache_select(cache, idx, rows, valid=valid)

    def gather_fp32_host(self, ids) -> np.ndarray:
        return self.hier.gather_fp32_host(np.asarray(ids))

    def build_cache(self, cache_rows: int) -> C.HotRowCache:
        """The top ``cache_rows`` rows by priority, their rows dequantized
        on the host (``gather_fp32_host``), and the host mask of the cached
        rows (``cache_mask``): staging skips what the cache serves."""
        k = int(min(cache_rows, self.vocab))
        mask = np.zeros(self.vocab, bool)
        if k <= 0:
            cache = C.empty_cache(self.vocab, self.dim, self.device)
        else:
            ids = C.top_rows(self.store.priority, k).cpu().numpy()
            cache = C.cache_from_rows(
                torch.from_numpy(ids).to(self.device),
                torch.from_numpy(self.gather_fp32_host(ids)).to(self.device),
                self.vocab)
            mask[ids] = True
        self.cache_mask = mask
        return cache

    def occupancy(self) -> dict:
        out = {}
        for lev, n in self.hier.counts().items():
            out[f"store.{lev}"] = float(n)          # hot/warm/cold rows
        for lev, nb in self.hier.nbytes().items():
            out[f"store.{lev}_bytes"] = float(nb)
        tiers = np.bincount(self.hier.tiers.reshape(-1).astype(np.int64),
                            minlength=3)
        for name, n in zip(("int8", "half", "fp32"), tiers):
            out[f"store.tier_rows_{name}"] = float(n)
        return out

    def begin_retier(self, chunk_rows: int):
        """A ``ShadowMigrate`` against the current fold state (always one,
        as the reference: a migration may move levels without crossing a
        tier)."""
        from repro_torch.serve.shadow import ShadowMigrate
        return ShadowMigrate(self.hier, self.store, self.cfg,
                             chunk_rows=chunk_rows)

    def retier(self) -> dict:
        """Synchronous migration across the levels."""
        moved = self.hier.migrate(self.store, self.cfg)
        return {"rows_moved": int(moved["crossed"]),
                "changed": bool(moved["promoted"] or moved["demoted"]
                                or moved["crossed"])}

    def lookup(self, indices) -> torch.Tensor:
        from repro_torch.store.hier import hier_lookup
        return hier_lookup(self.hier, indices)

    def bag_lookup(self, indices, weights=None) -> torch.Tensor:
        """(B, K) ids -> (B, D): the rows (times ``weights``) summed a bag
        in slot order (``hier_bag_lookup``)."""
        from repro_torch.store.hier import hier_bag_lookup
        idx = torch.as_tensor(indices)
        b, k = idx.shape
        seg = torch.arange(b, dtype=torch.int64).repeat_interleave(k)
        w = (None if weights is None
             else torch.as_tensor(weights).reshape(-1))
        return hier_bag_lookup(self.hier, idx.reshape(-1), seg, b, w)

    def snapshot_manifest(self) -> dict:
        return self.hier.state_tree()

    @classmethod
    def from_manifest(cls, tree: dict, *, store: QATStore | None = None,
                      cfg: FQuantConfig | None = None, hier_cfg=None,
                      mesh=None, axis: str = "model",
                      device: str | torch.device | None = None):
        """Rebuild from ``state_tree`` output (the port's, or the
        reference's numpy leaves).  The cold shards are on disk already,
        under ``hier_cfg.store_dir``; ``store`` / ``cfg`` re-attach the
        training-side state for re-tiers."""
        from repro_torch.store.hier import HierStore
        from repro_torch.store.manifest import ColdShards
        dev = torch.device("cpu" if device is None else device)

        def as_packed(x, d):
            return ps.PackedStore(*(_tensor(leaf, d) for leaf in x))

        cold_ids = np.asarray(tree["cold_ids"])
        cold = None
        if cold_ids.size:
            if hier_cfg is None or hier_cfg.store_dir is None:
                raise ValueError("cold shards need hier_cfg.store_dir")
            cold = ColdShards(hier_cfg.store_dir)
        hier = HierStore(
            cfg=hier_cfg, dim=int(tree["dim"]),
            level=np.asarray(tree["level"]), slot=np.asarray(tree["slot"]),
            tiers=np.asarray(tree["tiers"]),
            hot_ids=np.asarray(tree["hot_ids"]),
            warm_ids=np.asarray(tree["warm_ids"]), cold_ids=cold_ids,
            hot_dev=as_packed(tree["hot"], dev),
            warm=as_packed(tree["warm"], torch.device("cpu")),
            cold=cold, device=dev, mesh=mesh, axis=axis)
        hier.place()
        return cls(store, cfg, mesh=mesh, axis=axis, hier=hier)


class HashedBackend:
    """ROBE-style compositional store: rows materialise on the fly from
    the shared chunk pool through the ``hashed_gather`` kernel.  Memory
    is bounded by the pool, independent of the vocabulary; a re-tier
    only refreshes the priority-driven hot-row fp32 cache."""

    kind = "hashed"
    needs_staging = False
    cache_mask = None
    hier = None
    cached_lookup = PackedBackend.cached_lookup

    def __init__(self, hs: H.HashedStore, hcfg: H.HashedConfig, *,
                 mesh=None, axis: str = "model"):
        """``mesh`` row-shards the pool for the request path
        (``dist.hashed.shard_hashed``)."""
        if mesh is not None:
            check_mesh(mesh, axis)
        self.hs = hs
        self.hcfg = hcfg
        self.mesh = mesh
        self.axis = axis
        self.cfg = None      # no FQuantConfig: the pool is the pack
        self.store = None    # no QATStore behind this backend
        self.device_store = None
        self.place()

    def place(self) -> None:
        """The request path's pool: row shards under a mesh (the pool never
        changes while serving, so once)."""
        if self.mesh is not None:
            from repro_torch.dist.hashed import shard_hashed
            self.device_store = shard_hashed(self.hs, self.mesh, self.axis)

    @property
    def device(self) -> torch.device:
        return self.hs.pool.device

    @property
    def packed(self):
        """The store the forward reads (``lookup_fn``'s first argument):
        the ``HashedStore``, or its ``ShardedHashed`` under a mesh."""
        return self.hs if self.mesh is None else self.device_store

    @property
    def vocab(self) -> int:
        return int(self.hcfg.vocab)

    @property
    def dim(self) -> int:
        return int(self.hcfg.dim)

    def nbytes(self) -> int:
        return int(self.hs.nbytes())

    def live_counts(self) -> dict:
        return {"pool_slots": int(self.hs.num_slots),
                "virtual_rows": int(self.hcfg.vocab)}

    def occupancy(self) -> dict:
        """The occupancy gauges of the pool."""
        return {"store.pool_bytes": float(self.hs.nbytes()),
                "store.pool_slots": float(self.hs.num_slots)}

    # -- serving surface -----------------------------------------------

    def lookup_fn(self) -> Callable:
        hcfg = self.hcfg
        if self.mesh is None:
            return lambda hs, idx: H.hashed_lookup(hs, hcfg, idx)
        from repro_torch.dist.hashed import sharded_hashed_lookup
        mesh, axis = self.mesh, self.axis
        return lambda hs, idx: sharded_hashed_lookup(hs, hcfg, idx,
                                                     mesh=mesh, axis=axis)

    def bag_matmul_fn(self) -> Callable:
        raise ValueError("fused bag->matmul serving requires a fully "
                         "resident packed store (hashed rows materialize "
                         "on the fly)")

    def build_cache(self, cache_rows: int) -> C.HotRowCache:
        """The top ``cache_rows`` rows by priority (ties to the lower id,
        as ``jax.lax.top_k``), materialised by the kernel on the store's
        device: at K = 1 they equal the reference's host oracle."""
        k = int(min(cache_rows, self.vocab))
        if k <= 0:
            return C.empty_cache(self.vocab, self.dim, self.device)
        ids = C.top_rows(self.hs.priority, k).to(torch.int32)
        return C.cache_from_rows(ids, self.lookup(ids), self.vocab)

    # -- lookups -------------------------------------------------------

    def lookup(self, indices: torch.Tensor) -> torch.Tensor:
        return H.hashed_lookup(self.hs, self.hcfg, indices)

    def gather_fp32_host(self, ids) -> np.ndarray:
        """fp32 rows ``ids`` materialised from the pool, on the host."""
        return H.gather_rows_host(self.hs, self.hcfg, ids)

    def bag_lookup(self, indices: torch.Tensor,
                   weights: torch.Tensor | None = None) -> torch.Tensor:
        return H.hashed_bag_lookup(self.hs, self.hcfg, indices, weights)

    # -- adaptation ----------------------------------------------------

    def fold_priority(self, indices: torch.Tensor, pcfg: PriorityConfig,
                      valid: torch.Tensor | None = None) -> None:
        """The eager Eq. 7 fold (``priority.serve_fold``)."""
        self.hs = self.hs._replace(
            priority=serve_fold(self.hs.priority, indices, pcfg,
                                valid=valid))

    def prewarm_retier(self, chunk_rows: int) -> None:
        """Nothing to quantize: a re-tier is a cache refresh."""

    def begin_retier(self, chunk_rows: int):
        """No shadow: nothing migrates, the caller refreshes the cache."""
        return None

    def retier(self) -> dict:
        """Nothing migrates (pool slots are shared): the caller refreshes
        the cache."""
        return {"rows_moved": 0, "changed": False}

    # -- persistence ---------------------------------------------------

    def snapshot_manifest(self) -> dict:
        return H.hashed_state_tree(self.hs, self.hcfg)

    @classmethod
    def from_manifest(cls, tree: dict, *, mesh=None, axis: str = "model",
                      device: str | torch.device | None = None, **_):
        hcfg = H.HashedConfig(**{k: int(v)
                                 for k, v in tree["config"].items()})
        hs = H.HashedStore(*(_tensor(tree[f], device)
                             for f in H.HashedStore._fields))
        return cls(hs, hcfg, mesh=mesh, axis=axis)


def _tensor(x, device) -> torch.Tensor:
    """A manifest leaf (tensor, or numpy from the reference; a bf16 leaf
    as its 2-byte bits) as a tensor."""
    if isinstance(x, torch.Tensor):
        t = x
    else:
        a = np.array(x)
        if a.dtype.kind == "V" and a.dtype.itemsize == 2:
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
    return t if device is None else t.to(device)


# ------------------------------------------------------------------ registry

_BACKENDS: dict[str, Callable[..., Any]] = {}
_MANIFEST_KINDS: dict[str, Callable[..., Any]] = {}


def register_backend(name: str, factory: Callable[..., Any],
                     manifest_kind: str | None = None) -> None:
    """Register ``factory`` under ``name`` for ``build``; optionally bind
    a ``snapshot_manifest`` kind tag for ``from_manifest``."""
    _BACKENDS[name] = factory
    if manifest_kind is not None:
        _MANIFEST_KINDS[manifest_kind] = factory


def backend_names() -> tuple[str, ...]:
    return tuple(sorted(_BACKENDS))


def build(name: str, *args, **kwargs):
    """``build("packed", store, cfg)``, ``build("hier", store, cfg,
    hier_cfg)`` or ``build("hashed", hs, hcfg)``:
    the arguments go straight to the backend's factory."""
    if name not in _BACKENDS:
        raise ValueError(f"unknown store backend {name!r}; registered: "
                         f"{', '.join(backend_names())}")
    return _BACKENDS[name](*args, **kwargs)


def from_manifest(tree: dict, **kwargs):
    """Rebuild a backend from a ``snapshot_manifest`` tree: its kind tag
    picks the backend."""
    kind = tree.get("kind") or tree.get("schema")
    if kind is None:
        raise ValueError("manifest carries no 'kind'/'schema' tag")
    factory = _MANIFEST_KINDS.get(str(kind))
    if factory is None:
        raise ValueError(f"no backend registered for manifest kind {kind!r}")
    return factory.from_manifest(tree, **kwargs)


register_backend("packed", PackedBackend, manifest_kind="packed_store/v1")
register_backend("hier", HierBackend, manifest_kind="hier_store/v1")
register_backend("hashed", HashedBackend, manifest_kind="hashed_store/v1")
