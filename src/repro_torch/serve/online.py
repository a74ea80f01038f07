"""Online serving state: live priority EMA + hot cache + delta re-tier.

Port of ``repro/serve/online.py``: synchronous and shadow re-tiers.
``OnlineServer`` owns the traffic-adaptive state around one backend of
``store.api`` (packed; hier through ``hier=HierConfig(...)``; hashed
through ``backend=``), on one device or row-sharded over ``mesh=`` (a
``dist.Mesh``: the served store is then the backend's shards, a re-tier
unshards, repacks and reshards on the device, and a shadow generation is
sharded when it is staged):

  * the backend: the store, its lookup kernels, the priority vector and
    the re-tier (``packed_store.repack_delta`` on the device for the
    packed store; ``HierStore.migrate`` across the hierarchical store's
    levels; a cache refresh for the hashed pool, whose shared slots
    cannot re-tier),
  * the hot-row cache (``serve.cache``), rebuilt after every re-tier,
  * ``ServeStats`` counters (requests / lookups / hits / retiers /
    rows_moved).

Per request a caller either calls ``server.lookup(indices)`` (the eager
cache-first gather through the backend's ``cached_lookup``, then the
fold) or, as the serving loops do, runs its forward over
``server.packed`` / ``server.cache`` (cache-first:
``serve.cache.cached_lookup``; the hier backend stages its misses first,
skipping the rows in ``server.cache_mask``) and then calls
``server.observe(indices, hits)``, which folds the served rows into the
Eq. 7 EMA (the eager form, as the reference's un-jitted fold computes it)
and re-tiers every ``retier_every`` requests: synchronously, or as a
shadow build (below).

With metrics on (``obs.enable()``, ``--metrics-out``) the server records
the reference's metrics: the ``serve.requests``, ``serve.lookups``,
``serve.cache.hits`` and ``serve.retier.rows_moved`` counters, the
``serve.cache.hit_rate`` gauge, the ``serve.retier_us`` histogram, and
after every cache (re)build the occupancy gauges (``serve.cache.rows``
and the backend's ``store.*``).  With metrics off they cost one flag
check each.

With ``OnlineConfig.retier_async`` the re-tier runs as a shadow build
instead (``serve.shadow``): the boundary request only opens the shadow,
each later request advances it by ``shadow_rows_per_step`` rows (times
its live requests), and the finished generation is staged on a thread
(the optional ``verify_swap`` bit-identity check against a fresh
``pack``) before one pointer swap on a later request: build -> chunk ->
[verify ->] swap, with ``discard_shadow`` as the crash-before-swap exit.
The swapped store is bit-identical to a synchronous re-tier at the
snapshot fold state.  On the card the staging thread issues its work on
a CUDA stream of its own, after waiting for the serving stream (the last
chunk and the materialized store were issued there), so a verify is not
queued in front of the next request's kernels (the two still share the
card, at one priority); the serving loops' syncs wait for their own
stream only (``repro_torch.sync``).  The
shadow metrics are the reference's: the ``serve.shadow.{plan, chunk,
stage, verify, swap}`` spans, the ``serve.shadow.builds`` and
``serve.shadow.swaps`` counters, the ``serve.shadow.in_flight`` and
``serve.shadow.lag_rows`` gauges and the ``serve.shadow.build_us``
histogram.  The loops register no ``warmup_fn``: the reference's warm-up
compiles the jitted forward for the new payload shapes, and eager torch
has nothing to compile.

The hierarchical store's shadow re-tier is a ``serve.shadow.ShadowMigrate``
(level builds, then one cold shard a tick), taken through the same state
machine.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs, sync
from repro_torch.core.priority import PriorityConfig
from repro_torch.store.api import build


class OnlineConfig(NamedTuple):
    cache_rows: int = 0      # top-K fp32 hot rows (0 = cache disabled)
    retier_every: int = 0    # requests between delta re-tiers (0 = never)
    priority: PriorityConfig | None = None  # None -> FQuantConfig's
    retier_async: bool = False    # shadow-build re-tiers off the request
                                  # path instead of synchronous repacks
    shadow_rows_per_step: int = 512  # shadow build budget per live
                                     # request (rows; scaled by count)
    verify_swap: bool = False     # O(V) bit-identity check against pack()
                                  # at the snapshot fold state, every swap


@dataclasses.dataclass
class ServeStats:
    requests: int = 0
    lookups: int = 0       # individual valid row lookups served
    hits: int = 0          # of which from the hot cache
    retiers: int = 0
    rows_moved: int = 0    # tier-crossing rows migrated by repack_delta
    retier_seconds: float = 0.0  # wall time inside retier() and the
                                 # shadow ticks (the loops attribute
                                 # tail latency from it)
    shadow_builds: int = 0   # shadow generations opened
    shadow_chunks: int = 0   # bounded build steps taken on request ticks
    swaps: int = 0           # shadow generations swapped in

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
                 axis: str = "model", hier=None, backend=None):
        """``backend`` (a ``store.api`` backend, e.g. ``build("hashed", hs,
        hcfg, mesh=mesh)``) is served as given; otherwise the ``(store,
        cfg)`` ``QATStore`` pair builds the ``hier`` backend under ``hier``
        (a ``store.hier.HierConfig``), or the ``packed`` one, row-sharded
        over ``mesh`` (a ``dist.Mesh``) when given."""
        if backend is None:
            if store is None or cfg is None:
                raise ValueError("OnlineServer needs either backend= or the "
                                 "(store, cfg) QATStore pair")
            backend = (build("hier", store, cfg, hier, mesh=mesh, axis=axis)
                       if hier is not None
                       else build("packed", store, cfg, mesh=mesh,
                                  axis=axis))
        self.backend = backend
        self.mesh = getattr(backend, "mesh", None)
        self.axis = getattr(backend, "axis", axis)
        self.online = online
        self.stats = ServeStats()
        # shadow re-tier state (OnlineConfig.retier_async)
        self.shadow = None            # the build in flight (ShadowRepack)
        self._retier_pending = False  # a boundary crossed while building
        self._staged = None           # the staged store, before the swap
        self.warmup_fn = None         # the reference's forward warm-up
                                      # hook; eager torch compiles nothing,
                                      # so no loop registers one
        self._warmup = None           # the staging thread in flight
        self._stage_err = None        # a staging / verify failure, raised
                                      # at the swap
        self._shadow_t0 = 0.0         # perf_counter at begin_retier: the
                                      # serve.shadow.build_us lifecycle
        self._stage_stream = None     # the staging thread's CUDA stream,
                                      # one a server (its allocations are
                                      # cached for the next build)
        self._rebuild_cache()
        if online.retier_async:
            self.backend.prewarm_retier(online.shadow_rows_per_step)

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

    @property
    def hier(self):
        """The hier backend's ``HierStore`` (None for the others)."""
        return self.backend.hier

    @property
    def cache_mask(self):
        """The host mask of the cached rows, which a staging backend skips
        (None for the fully resident backends)."""
        return self.backend.cache_mask

    def _place(self) -> None:
        self.backend.place()

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
        rows, hits = self.backend.cached_lookup(self.cache, self.cache_mask,
                                                indices, valid=vmask)
        self.observe(indices, int(hits), valid=vmask, count=count,
                     lookups=n_lookups)
        return rows

    def observe(self, indices: torch.Tensor, hits: int | None = None, *,
                valid: np.ndarray | torch.Tensor | None = None,
                count: int = 1, lookups: int | None = None) -> bool:
        """Fold one served batch into the online state: the Eq. 7 EMA
        (c- only), the counters, and a synchronous re-tier when the
        request counter crosses a multiple of ``retier_every`` (with
        ``retier_async`` the boundary marks a shadow build pending, and
        every call advances the build in flight by ``count`` requests'
        row budget).  Returns True when the store was repacked or
        swapped (re-read ``server.packed`` and ``server.cache``).

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
            if not self.online.retier_async:
                return self.retier()
            self._retier_pending = True
        if self.online.retier_async:
            return self._shadow_tick(count)
        return False

    def _default_priority_cfg(self) -> PriorityConfig:
        cfg = self.backend.cfg
        if cfg is not None and cfg.priority is not None:
            return cfg.priority
        return PriorityConfig()

    # -- shadow re-tier (async) ----------------------------------------

    def begin_retier(self) -> bool:
        """Open a shadow build against the current fold state.

        The backend's ``QATStore`` is the snapshot: the fold replaces its
        priority tensor with a new one, so the reference the shadow keeps
        does not drift while live folds go on (the next build picks them
        up).  Returns True when a shadow was opened.  A backend with
        nothing to move takes the synchronous no-move path: the re-tier is
        counted and the cache rebuilt, with no swap.
        """
        if self.shadow is not None:     # one generation at a time
            self._retier_pending = True
            return False
        self._shadow_t0 = time.perf_counter()
        with obs.span("serve.shadow.plan"):
            sh = self.backend.begin_retier(self.online.shadow_rows_per_step)
        if sh is None:
            self.stats.retiers += 1
            self._rebuild_cache()
            return False
        self.shadow = sh
        self.stats.shadow_builds += 1
        obs.inc("serve.shadow.builds", 1)
        obs.gauge("serve.shadow.in_flight", 1.0)
        return True

    def _shadow_tick(self, count: int = 1) -> bool:
        """One request's share of shadow work: open a pending build,
        advance it by the step budget, stage or swap when it is ready.
        The tick's window ends when its device work has.  Returns True
        when the live store was swapped (re-read ``server.packed``)."""
        if self.shadow is None and self._retier_pending:
            self._retier_pending = False
            self.begin_retier()
        if self.shadow is None:
            return False
        with obs.timeblock("serve.retier") as tb:
            swapped = self._shadow_advance(count)
            sync(self.device)
        self.stats.retier_seconds += tb.seconds
        return swapped

    def _shadow_advance(self, count: int) -> bool:
        sh = self.shadow
        if not sh.staged:
            with obs.span("serve.shadow.chunk"):
                sh.step(self.online.shadow_rows_per_step
                        * max(int(count), 1))
            self.stats.shadow_chunks += 1
            if obs.enabled():
                obs.gauge("serve.shadow.lag_rows", float(sh.remaining_rows))
            if sh.staged:
                # built on this tick: stage now, swap on a later tick, so
                # that the verify lands on no request
                self._begin_staging()
            return False
        if self._warmup is None:
            self._begin_staging()
            return False
        if self._warmup.is_alive():
            return False
        return self._swap()

    def _begin_staging(self) -> None:
        """Start the staging thread: placement (the shadow is already on
        the device) and the optional bit-identity verify, off the serving
        thread.  On CUDA it runs on a stream of its own (one a server)
        that first waits for the serving stream, and it synchronizes that
        stream before it ends, so nothing it read is freed under it.  A
        failure is kept and raised at the swap."""
        sh = self.shadow
        verify = self.online.verify_swap
        # the thread reports into this thread's registry binding
        reg = obs.get_registry()
        dev = self.device
        side = None
        if dev.type == "cuda":
            if self._stage_stream is None:
                self._stage_stream = torch.cuda.Stream(dev)
            side = self._stage_stream
            side.wait_stream(torch.cuda.current_stream(dev))

        def _stage() -> None:
            ctx = (torch.cuda.stream(side) if side is not None
                   else contextlib.nullcontext())
            with obs.bind(reg), ctx, torch.inference_mode():
                try:
                    try:
                        with obs.span("serve.shadow.stage"):
                            staged = sh.place()
                            if verify:
                                with obs.span("serve.shadow.verify"):
                                    sh.verify()
                    finally:
                        if side is not None:
                            side.synchronize()
                    self._staged = staged
                except Exception as e:          # raised by _swap
                    self._stage_err = e
        self._warmup = threading.Thread(target=_stage, daemon=True)
        self._warmup.start()

    def _swap(self) -> bool:
        """The generation flip: commit the staged shadow and rebuild the
        hot cache, the only point where live serving state changes.  A
        staging or verify failure surfaces here: the shadow is discarded,
        the live store stays as it was, and the error is raised."""
        if self._stage_err is not None:
            err = self._stage_err
            self.discard_shadow()
            raise err
        with obs.span("serve.shadow.swap"):
            moved = self.shadow.commit(self, self._staged)
        self.shadow = None
        self._staged = None
        self._warmup = None
        self.stats.retiers += 1
        self.stats.swaps += 1
        self.stats.rows_moved += int(moved)
        obs.inc("serve.retier.rows_moved", int(moved))
        obs.inc("serve.shadow.swaps", 1)
        obs.observe("serve.shadow.build_us",
                    (time.perf_counter() - self._shadow_t0) * 1e6)
        obs.gauge("serve.shadow.in_flight", 0.0)
        self._rebuild_cache()
        return True

    def drain_shadow(self) -> bool:
        """Finish any in-flight (or pending) shadow now and swap it in:
        loop teardown and checks.  Returns True when a swap happened."""
        if self.shadow is None and self._retier_pending:
            self._retier_pending = False
            self.begin_retier()
        if self.shadow is None:
            return False
        with obs.timeblock("serve.retier") as tb:
            while not self.shadow.staged:
                self.shadow.step(1 << 30)
                self.stats.shadow_chunks += 1
            if self._warmup is None:
                self._begin_staging()
            self._warmup.join()
            out = self._swap()
            sync(self.device)
        self.stats.retier_seconds += tb.seconds
        return out

    def discard_shadow(self) -> None:
        """Crash-before-swap: drop the shadow generation.  The live store
        is untouched; serving goes on as if the build never started.  A
        staging thread still running is joined first."""
        if self._warmup is not None and self._warmup.is_alive():
            self._warmup.join()
        if self.shadow is not None:
            self.shadow.discard()
            obs.gauge("serve.shadow.in_flight", 0.0)
        self.shadow = None
        self._staged = None
        self._warmup = None
        self._stage_err = None
        self._retier_pending = False

    # -- incremental re-tier -------------------------------------------

    def retier(self) -> bool:
        """Delta-repack the tier-crossing rows and rebuild the hot cache.
        Wall time (to the device's end of it) accumulates into
        ``stats.retier_seconds`` (always: the loops attribute tail latency
        from it) and into the ``serve.retier_us`` histogram when metrics
        are on.  Returns True if anything moved.  A synchronous re-tier
        supersedes a shadow build in flight: the shadow is discarded (its
        snapshot is stale beside the store this call re-tiers from)."""
        if self.shadow is not None or self._retier_pending:
            self.discard_shadow()
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
