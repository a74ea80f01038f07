"""Online serving state: live priority EMA + hot cache + delta re-tier.

Port of ``repro/serve/online.py`` with synchronous re-tiers.
``OnlineServer`` owns the traffic-adaptive state around one backend of
``store.api`` (packed, or hashed through ``backend=``):

  * the backend: the store, its lookup kernels, the priority vector and
    the re-tier (``packed_store.repack_delta`` on the device for the
    packed store; a cache refresh for the hashed pool, whose shared slots
    cannot re-tier),
  * the hot-row cache (``serve.cache``), rebuilt after every re-tier,
  * ``ServeStats`` counters (requests / lookups / hits / retiers /
    rows_moved).

Per request a caller either calls ``server.lookup(indices)`` (the eager
cache-first gather, then the fold) or, as the serving loop does, runs
its forward over ``server.packed`` / ``server.cache`` (cache-first:
``serve.cache.cached_lookup``) and then calls ``server.observe(indices,
hits)``, which folds the served rows into the Eq. 7 EMA (the eager form,
as the reference's un-jitted fold computes it) and re-tiers
synchronously every ``retier_every`` requests.

With metrics on (``obs.enable()``, ``--metrics-out``) the server records
the reference's metrics: the ``serve.requests``, ``serve.lookups``,
``serve.cache.hits`` and ``serve.retier.rows_moved`` counters, the
``serve.cache.hit_rate`` gauge, the ``serve.retier_us`` histogram, and
after every cache (re)build the occupancy gauges (``serve.cache.rows``
and the backend's ``store.*``).  With metrics off they cost one flag
check each.

Shadow re-tiers (``retier_async``) and the hierarchical store (``hier=``)
raise ``NotImplementedError``: they come with later slices (ROADMAP
Queue 1 items 6 and 8).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs, sync
from repro_torch.core.priority import PriorityConfig
from repro_torch.serve.cache import cached_lookup
from repro_torch.store.api import build


class OnlineConfig(NamedTuple):
    cache_rows: int = 0      # top-K fp32 hot rows (0 = cache disabled)
    retier_every: int = 0    # requests between delta re-tiers (0 = never)
    priority: PriorityConfig | None = None  # None -> FQuantConfig's
    retier_async: bool = False     # shadow re-tiers: not ported yet


@dataclasses.dataclass
class ServeStats:
    requests: int = 0
    lookups: int = 0       # individual valid row lookups served
    hits: int = 0          # of which from the hot cache
    retiers: int = 0
    rows_moved: int = 0    # tier-crossing rows migrated by repack_delta
    retier_seconds: float = 0.0  # wall time inside retier()
    shadow_builds: int = 0   # always 0: the record keeps the reference's
    swaps: int = 0           # keys, shadow re-tiers are not ported yet

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def as_dict(self) -> dict:
        return {"requests": self.requests, "lookups": self.lookups,
                "hits": self.hits, "cache_hit_rate": round(self.hit_rate, 4),
                "retiers": self.retiers, "rows_moved": self.rows_moved,
                "shadow_builds": self.shadow_builds, "swaps": self.swaps}


class OnlineServer:
    """Mutable serving-side owner of a store backend, the hot cache and
    the serve-side priority fold."""

    def __init__(self, store=None, cfg=None,
                 online: OnlineConfig = OnlineConfig(), *, mesh=None,
                 hier=None, backend=None):
        """``backend`` (a ``store.api`` backend, e.g. ``build("hashed", hs,
        hcfg)``) is served as given; otherwise the ``(store, cfg)``
        ``QATStore`` pair builds the ``packed`` backend."""
        if online.retier_async:
            raise NotImplementedError(
                "shadow re-tiers (retier_async) are not ported yet "
                "(ROADMAP Queue 1 item 6)")
        if hier is not None:
            raise NotImplementedError(
                "the hierarchical store is not ported yet (ROADMAP Queue 1 "
                "item 8)")
        if backend is None:
            if store is None or cfg is None:
                raise ValueError("OnlineServer needs either backend= or the "
                                 "(store, cfg) QATStore pair")
            backend = build("packed", store, cfg, mesh=mesh)
        self.backend = backend
        self.online = online
        self.stats = ServeStats()
        self._rebuild_cache()

    # -- backend state proxies -----------------------------------------

    @property
    def store(self):
        """The backend's ``QATStore`` (None for hashed)."""
        return self.backend.store

    @property
    def cfg(self):
        return self.backend.cfg

    @property
    def packed(self):
        """The store the forward reads, on the serving device (the pack,
        or the hashed backend's ``HashedStore``)."""
        return self.backend.packed

    @property
    def host_packed(self):
        """The packed backend's pack of record (the reference's host
        pack; here the device pack the forward reads)."""
        return self.backend.host_packed

    @property
    def device(self) -> torch.device:
        return self.backend.device

    def lookup_fn(self):
        return self.backend.lookup_fn()

    def bag_matmul_fn(self):
        return self.backend.bag_matmul_fn()

    def _rebuild_cache(self) -> None:
        self.cache = self.backend.build_cache(self.online.cache_rows)
        if obs.enabled():
            self._export_gauges()

    def _export_gauges(self) -> None:
        """Occupancy gauges of the current store (the backend names its
        own set), refreshed after every cache (re)build."""
        obs.gauge("serve.cache.rows", float(self.cache.capacity))
        for name, value in self.backend.occupancy().items():
            obs.gauge(name, value)

    # -- request path --------------------------------------------------

    def lookup(self, indices: torch.Tensor, *,
               valid: np.ndarray | None = None,
               count: int | None = None) -> torch.Tensor:
        """Eager cache-first gather, then the fold: int (...,) -> fp32
        (..., D) through the backend's gather, bit-identical to it for
        any cache.

        ``valid`` (bool numpy, broadcastable to ``indices``) keeps padded
        micro-batch slots out of the hit and lookup counts and out of the
        priority fold; ``count`` is the number of live requests in the
        batch (default 1)."""
        count = 1 if count is None else count
        vmask = n_lookups = None
        if valid is not None:
            vnp = np.broadcast_to(np.asarray(valid, bool),
                                  tuple(indices.shape))
            n_lookups = int(vnp.sum())
            vmask = torch.from_numpy(np.ascontiguousarray(vnp)).to(
                indices.device)
        rows, hits = cached_lookup(self.packed, self.cache, indices,
                                   self.lookup_fn(), valid=vmask)
        self.observe(indices, int(hits), valid=vmask, count=count,
                     lookups=n_lookups)
        return rows

    def observe(self, indices: torch.Tensor, hits: int | None = None, *,
                valid: np.ndarray | torch.Tensor | None = None,
                count: int = 1, lookups: int | None = None) -> bool:
        """Fold one served batch into the online state: the Eq. 7 EMA
        (c- only), the counters, and a synchronous re-tier when the
        request counter crosses a multiple of ``retier_every``.  Returns
        True when the store was repacked (re-read ``server.packed`` and
        ``server.cache``).

        Micro-batched serving passes one batch of ``count`` live requests
        with ``valid``, the batcher's numpy mask (bool, broadcastable to
        ``indices``), which keeps padded slots out of the counters and
        the fold.  ``valid`` may instead be that mask already on the
        indices' device, with ``lookups``, its live slots counted on the
        host by the caller.  A call whose ``count`` spans several
        ``retier_every`` boundaries runs one re-tier, as the reference's
        does.
        """
        before = self.stats.requests
        self.stats.requests += count
        if valid is None:
            n_lookups = int(indices.numel())
            vmask = None
        elif isinstance(valid, torch.Tensor):
            if lookups is None:
                raise ValueError("a device mask needs its host-side count "
                                 "(lookups=)")
            n_lookups = int(lookups)
            vmask = valid.expand(indices.shape)
        else:
            # counted on the host, from the batcher's numpy mask: no device
            # round trip on the timed path
            vnp = np.broadcast_to(np.asarray(valid, bool),
                                  tuple(indices.shape))
            n_lookups = int(vnp.sum())
            vmask = torch.from_numpy(np.ascontiguousarray(vnp)).to(
                indices.device)
        self.stats.lookups += n_lookups
        if hits is not None:
            self.stats.hits += int(hits)
        if obs.enabled():
            obs.inc("serve.requests", count)
            obs.inc("serve.lookups", n_lookups)
            if hits is not None:
                obs.inc("serve.cache.hits", int(hits))
            obs.gauge("serve.cache.hit_rate", self.stats.hit_rate)
        pcfg = self.online.priority or self._default_priority_cfg()
        self.backend.fold_priority(indices, pcfg, valid=vmask)
        re = self.online.retier_every
        if re and self.stats.requests // re > before // re:
            return self.retier()
        return False

    def _default_priority_cfg(self) -> PriorityConfig:
        cfg = self.backend.cfg
        if cfg is not None and cfg.priority is not None:
            return cfg.priority
        return PriorityConfig()

    # -- incremental re-tier -------------------------------------------

    def retier(self) -> bool:
        """Delta-repack the tier-crossing rows and rebuild the hot cache.
        Wall time (to the device's end of it) accumulates into
        ``stats.retier_seconds`` (always: the loops attribute tail latency
        from it) and into the ``serve.retier_us`` histogram when metrics
        are on.  Returns True if anything moved."""
        with obs.timeblock("serve.retier") as tb:
            res = self.backend.retier()
            self.stats.retiers += 1
            if res["rows_moved"]:
                self.stats.rows_moved += int(res["rows_moved"])
                obs.inc("serve.retier.rows_moved", int(res["rows_moved"]))
            self._rebuild_cache()
            sync(self.device)
        self.stats.retier_seconds += tb.seconds
        return bool(res["changed"])
