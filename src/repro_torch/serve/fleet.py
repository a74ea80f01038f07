"""Multi-replica serving: N online servers behind a router.

Port of ``repro/serve/fleet.py``.  One ``OnlineServer`` adapts to its own
traffic.  A fleet of N replicas behind a router sees N disjoint slices of
the same drifting workload, so each replica's Eq. 7 EMA, and with it its
re-tier decisions, drifts away from the others': the hot set is global,
the evidence is sharded.  This module closes that gap:

  Replica   one ``OnlineServer`` (packed backend) + its ``MicroBatcher`` +
            a named ``obs.Registry`` (every span, counter and histogram
            of the serving path lands in it through ``obs.bind``), and
            the merge window: the replica's per-row access counts since
            the last fleet merge.
  Router    request placement: ``round_robin`` (cycle) or
            ``least_outstanding`` (emptiest micro-batcher).  The decision
            is timed (``router.route_us`` in the router's registry).
  Fleet     the control plane: dispatch, the staggered re-tier schedule,
            periodic cross-replica Eq. 7 merges, and the fleet gauges
            (lag and queue a replica, priority divergence, tier-occupancy
            skew, queue depth, co-scheduled shadow swaps).
            ``aggregate()`` hands every replica registry and the router's
            to ``obs.FleetAggregator``: fleet percentiles come from the
            exact bucket merge, never a mean of per-replica percentiles.

The merge.  Between merges each replica folds its own traffic (Eq. 7 a
micro-batch, ``OnlineServer.observe``) and counts its accesses in its
window.  The merge is one Eq. 7 step over the pooled window,

    merged = fold_counts(merge_base, sum_r window_r)

the eager ``priority_update(merge_base, 0, counts)`` of the reference
(``core.priority.fold_counts``, the same arithmetic as the online fold:
bit-equal to it).  ``merge_base`` is the previous merged vector, so the
merged EMA is what one server folding the pooled stream at merge cadence
would hold.  Every replica's priority is then set to the merged tensor,
one tensor for all (safe: no fold or re-tier writes a priority in place;
each fold makes a new one), and divergence is 0.

Where the port differs from the reference, by design:

* the merge windows are counted on the card: an int32 ``(V,)`` tensor a
  replica on the priorities' device, filled by ``index_add_`` from each
  micro-batch's valid global ids after its timed window (integer adds:
  exact in any order), summed and cast to fp32 at the merge (exact below
  2^24 accesses a row).  The reference keeps a float64 host vector a
  replica (178 MB at wide&deep's 22.2M rows, 694 MB at xDeepFM's 86.7M)
  and copies the pooled sum to the device;
* ``divergence()`` runs on the priorities' device: the max over rows of
  (max - min across replicas) in fp32, which equals the reference's
  maximum over pairs of ``max |a - b|`` exactly (the extreme pair gives
  the same rounded difference, and rounding is monotone), in one pass a
  replica instead of O(N^2);
* a batch's window starts when the device is idle (``sync``), as the
  port's micro-batched loop starts its windows, so a previous batch's
  window counts and merges are not charged to it.

Capacity accounting.  The replicas are in-process hosts that timeshare
one device (one card on the H100), so wall-clock fleet QPS would measure
the host thread, not the fabric.  ``FleetResult.aggregate_qps`` is the
capacity sum: each replica's steady QPS over its own busy time (requests
served / seconds spent serving them), summed: what N independent hosts
would deliver.  ``bench_fleet/v1`` records carry it a replica count.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import obs, sync
from repro_torch.core.priority import fold_counts
from repro_torch.obs.fleet import FleetAggregator
from repro_torch.obs.registry import Registry
from repro_torch.serve.loop import SERVE_PHASES, MicroBatch, MicroBatcher
from repro_torch.serve.online import OnlineServer

ROUTER_POLICIES = ("round_robin", "least_outstanding")

# the router's histogram catalog (pre-registered like SERVE_PHASES, so
# every router snapshot carries the whole set)
FLEET_PHASES = ("router.route", "fleet.merge")


class FleetConfig(NamedTuple):
    policy: str = "round_robin"   # ROUTER_POLICIES
    serve_batch: int = 8          # micro-batch capacity a replica
    merge_every: int = 0          # fleet requests between priority
                                  # merges (0 = never merge)
    retier_every: int = 0         # a replica's re-tier cadence in fleet
                                  # requests (0 = never); scheduled by the
                                  # fleet, not the servers, so that it can
                                  # be staggered
    stagger: bool = True          # shift replica i's re-tiers by
                                  # i * retier_every / N so that swaps do
                                  # not co-schedule across the fleet
    pulse_every: int = 32         # fleet requests between gauge pulses


class Replica:
    """One serving replica: server + batcher + named metrics registry.

    ``serve_fn(mb)`` runs the forward and ``server.observe`` (the
    ``run_microbatched_loop`` contract) under ``obs.bind(self.reg)``, so
    every span and counter lands in this replica's namespace.
    ``globalize`` maps a host (N, F) field-local index batch to global
    row ids (``None``: already global); the window needs global ids to
    pool counts across replicas.  The server must hold the packed
    backend (the merge writes the packed store's priority).
    """

    def __init__(self, rid: int, server: OnlineServer,
                 serve_fn: Callable[[MicroBatch], object],
                 serve_batch: int, num_fields: int, *,
                 globalize: Callable[[np.ndarray], np.ndarray] | None
                 = None):
        kind = server.backend.kind
        if kind != "packed":
            raise ValueError(f"a fleet replica serves the packed backend; "
                             f"replica {rid}'s server has the {kind!r} "
                             "backend")
        self.rid = int(rid)
        self.name = f"replica{rid}"
        self.server = server
        self.serve_fn = serve_fn
        self.batcher = MicroBatcher(serve_batch, num_fields)
        self.reg = Registry(enabled=True, name=self.name)
        with obs.bind(self.reg):
            obs.ensure_histograms(f"{p}_us" for p in SERVE_PHASES)
            # the server was built outside this registry's binding: export
            # its placement gauges (tier occupancy, store bytes, cache
            # rows) so the fleet's tier-skew pulse sees every replica from
            # request zero
            server._export_gauges()
        self.globalize = globalize
        pri = server.store.priority
        # accesses since the last fleet merge, on the priorities' device
        self.window = torch.zeros(pri.shape[0], dtype=torch.int32,
                                  device=pri.device)
        self.requests = 0
        self.busy_s = 0.0         # wall seconds inside run_batch windows
        self._lat: list[float] = []       # seconds a batch
        self._cnt: list[int] = []         # live requests a batch
        self._retiered: list[bool] = []   # the batch ran or overlapped
                                          # a re-tier
        self._mark_retier = False  # the fleet re-tiered just before the
                                   # next batch: flag it out of the
                                   # steady window

    def run_batch(self, mb: MicroBatch) -> None:
        """Serve one micro-batch under this replica's registry, then count
        its accesses into the merge window (outside the timed window)."""
        srv = self.server
        n_retiers, s0 = srv.stats.retiers, srv.stats.swaps
        c0 = srv.stats.shadow_chunks
        active0 = srv.shadow is not None
        sync(srv.device)
        with obs.bind(self.reg):
            with obs.timeblock("serve.request") as tb:
                tb.sync(self.serve_fn(mb))
            obs.tick()
        self.busy_s += tb.seconds
        self.requests += mb.count
        self._lat.append(tb.seconds)
        self._cnt.append(mb.count)
        self._retiered.append(srv.stats.retiers > n_retiers
                              or srv.stats.swaps > s0
                              or srv.stats.shadow_chunks > c0
                              or active0 or self._mark_retier)
        self._mark_retier = False
        g = mb.indices if self.globalize is None \
            else self.globalize(mb.indices)
        g = np.asarray(g, np.int64)[np.asarray(mb.valid, bool)].reshape(-1)
        ids = torch.from_numpy(g).to(self.window.device)
        self.window.index_add_(0, ids, torch.ones_like(ids,
                                                       dtype=torch.int32))

    def flush(self) -> None:
        """Serve the partial tail batch, then drain any shadow build in
        flight (the loops' teardown)."""
        mb = self.batcher.flush()
        if mb is not None:
            self.run_batch(mb)
        with obs.bind(self.reg):
            self.server.drain_shadow()

    def steady_qps(self) -> float:
        """Steady QPS over this replica's own busy time: the second half
        of its batch stream, re-tier-adjacent batches excluded (the
        ``run_microbatched_loop`` convention, a replica)."""
        lat = np.asarray(self._lat)
        cnt = np.asarray(self._cnt, np.float64)
        if lat.size == 0:
            return 0.0
        half = lat.size // 2
        steady = [i for i in range(half, lat.size)
                  if not (i == 0 or self._retiered[i]
                          or self._retiered[i - 1])]
        if not steady:
            steady = list(range(half, lat.size))
        return float(cnt[steady].sum() / lat[steady].sum())

    def priority_np(self) -> np.ndarray:
        """The live priority on the host (fp32)."""
        return self.server.store.priority.cpu().numpy()


class Router:
    """Request placement over the replica set."""

    def __init__(self, policy: str = "round_robin"):
        if policy not in ROUTER_POLICIES:
            raise ValueError(f"unknown router policy {policy!r}; "
                             f"expected one of {ROUTER_POLICIES}")
        self.policy = policy
        self._next = 0

    def pick(self, replicas: list[Replica]) -> int:
        if self.policy == "round_robin":
            i = self._next % len(replicas)
            self._next += 1
            return i
        # least_outstanding: the emptiest micro-batcher wins (ties to the
        # lowest id: deterministic, and round-robin-like when even)
        fills = [len(r.batcher) for r in replicas]
        return int(np.argmin(fills))


class FleetResult(NamedTuple):
    replicas: int
    policy: str
    aggregate_qps: float          # capacity sum of the replicas' steady
                                  # QPS (module docstring)
    per_replica_qps: tuple        # steady QPS a replica
    p50_us: float                 # fleet percentiles: the exact bucket
    p95_us: float                 # merge of every replica's
    p99_us: float                 # serve.request_us histogram
    route_p50_us: float           # the routing decision's latency
    router_overhead_frac: float   # route p50 / per-request p50
    requests: int
    merges: int                   # cross-replica priority merges run
    divergence: float             # max pairwise L-inf at the end
    divergence_premerge: float    # the worst divergence a merge saw
                                  # before it ran: what the fleet drifts
                                  # to without merging
    swaps_colocated: int          # pulses that saw >= 2 replicas with a
                                  # shadow swap in flight

    def as_dict(self) -> dict:
        return {"replicas": self.replicas, "policy": self.policy,
                "aggregate_qps": round(self.aggregate_qps, 1),
                "per_replica_qps": [round(q, 1)
                                    for q in self.per_replica_qps],
                "p50_us": round(self.p50_us, 1),
                "p95_us": round(self.p95_us, 1),
                "p99_us": round(self.p99_us, 1),
                "route_p50_us": round(self.route_p50_us, 3),
                "router_overhead_frac": round(
                    self.router_overhead_frac, 5),
                "requests": self.requests, "merges": self.merges,
                "divergence": round(self.divergence, 6),
                "divergence_premerge": round(
                    self.divergence_premerge, 6),
                "swaps_colocated": self.swaps_colocated}


class Fleet:
    """N replicas + router + merge and re-tier scheduler + fleet gauges."""

    def __init__(self, replicas: list[Replica],
                 cfg: FleetConfig = FleetConfig()):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        self.replicas = list(replicas)
        self.cfg = cfg
        self.router = Router(cfg.policy)
        self.reg = Registry(enabled=True, name="router")
        with obs.bind(self.reg):
            obs.ensure_histograms(f"{p}_us" for p in FLEET_PHASES)
        self.total_requests = 0
        self.merges = 0
        self.swaps_colocated = 0
        self.divergence_premerge = 0.0  # worst pre-merge divergence
        # the fold state the next pooled Eq. 7 step decays from: every
        # replica starts from the same pack-time priority
        self._merge_base = self.replicas[0].server.store.priority
        # the staggered re-tier schedule: replica i first re-tiers at
        # retier_every + i * phase, then every retier_every
        n = len(self.replicas)
        phase = (cfg.retier_every // n if cfg.stagger and n > 1 else 0)
        self._next_retier = [cfg.retier_every + i * phase
                             for i in range(n)] \
            if cfg.retier_every else [0] * n

    # -- dispatch ------------------------------------------------------

    def submit(self, request: np.ndarray) -> int:
        """Route one single-user request; returns the replica id it landed
        on.  Runs the replica's batch when its batcher fills, then the
        merge and pulse cadences."""
        with obs.bind(self.reg):
            with obs.span("router.route"):
                i = self.router.pick(self.replicas)
            obs.inc("router.requests", 1)
            obs.inc(f"router.to.{self.replicas[i].name}", 1)
        r = self.replicas[i]
        mb = r.batcher.add(request)
        self.total_requests += 1
        if mb is not None:
            self._maybe_retier(r)
            r.run_batch(mb)
        c = self.cfg
        if c.merge_every and self.total_requests % c.merge_every == 0:
            self.merge_priorities()
        if c.pulse_every and self.total_requests % c.pulse_every == 0:
            self._pulse()
        return i

    def _maybe_retier(self, r: Replica) -> None:
        """Fire ``r``'s scheduled re-tier once its staggered boundary has
        passed.  An async server gets the shadow pending flag (the build
        advances on its later batches); a synchronous one re-tiers now,
        under the replica's registry."""
        if not self.cfg.retier_every:
            return
        if self.total_requests < self._next_retier[r.rid]:
            return
        self._next_retier[r.rid] += self.cfg.retier_every
        r._mark_retier = True
        if r.server.online.retier_async:
            r.server._retier_pending = True
        else:
            with obs.bind(r.reg):
                r.server.retier()

    def flush(self) -> None:
        """Tail batches and shadow drains on every replica."""
        for r in self.replicas:
            r.flush()

    # -- cross-replica priority merge ----------------------------------

    def merge_priorities(self) -> float:
        """One pooled Eq. 7 step over every replica's window counts; every
        replica's priority becomes the merged tensor.

        Returns the divergence before the merge (max pairwise L-inf), the
        quantity this call drives to zero; exported as the
        ``fleet.priority_divergence`` gauge pair (before and after)."""
        pre = self.divergence()
        with obs.bind(self.reg), obs.span("fleet.merge"):
            pooled = self.replicas[0].window.clone()
            for r in self.replicas[1:]:
                pooled += r.window
            srv = self.replicas[0].server
            pcfg = srv.online.priority or srv._default_priority_cfg()
            merged = fold_counts(self._merge_base,
                                 pooled.to(torch.float32), pcfg)
            for r in self.replicas:
                backend = r.server.backend
                backend.store = backend.store._replace(priority=merged)
                r.window.zero_()
            self._merge_base = merged
            self.merges += 1
            self.divergence_premerge = max(self.divergence_premerge, pre)
            obs.inc("fleet.merges", 1)
            obs.gauge("fleet.priority_divergence_premerge",
                      self.divergence_premerge)
            obs.gauge("fleet.priority_divergence", self.divergence())
            sync(merged.device)
        return pre

    def divergence(self) -> float:
        """Max pairwise L-inf distance between the replicas' priority
        vectors: 0 right after a merge, growing with every locally folded
        batch until the next one.  Computed on the priorities' device as
        the max over rows of (max - min across replicas), which is the
        reference's pairwise maximum exactly (module docstring)."""
        pris = [r.server.store.priority for r in self.replicas]
        if all(p is pris[0] for p in pris[1:]):
            return 0.0
        hi, lo = pris[0].clone(), pris[0].clone()
        for p in pris[1:]:
            torch.maximum(hi, p, out=hi)
            torch.minimum(lo, p, out=lo)
        return float(hi.sub_(lo).max())

    # -- fleet gauges --------------------------------------------------

    def _pulse(self) -> None:
        """Refresh the fleet gauges in the router's registry."""
        reps = self.replicas
        served = [r.requests for r in reps]
        top = max(served) if served else 0
        with obs.bind(self.reg):
            for r in reps:
                obs.gauge(f"fleet.lag.{r.name}", float(top - r.requests))
                obs.gauge(f"fleet.queue.{r.name}", float(len(r.batcher)))
            obs.gauge("fleet.queue_depth",
                      float(sum(len(r.batcher) for r in reps)))
            obs.gauge("fleet.priority_divergence", self.divergence())
            obs.gauge("fleet.tier_skew_rows", self._tier_skew())
            in_flight = sum(
                int(r.reg.gauges.get("serve.shadow.in_flight", 0.0))
                for r in reps)
            obs.gauge("fleet.swaps_in_flight", float(in_flight))
            if in_flight >= 2:
                self.swaps_colocated += 1
                obs.inc("fleet.swaps_colocated", 1)

    def _tier_skew(self) -> float:
        """Max over precision tiers of (max - min) rows a replica: 0 when
        every replica holds the same tier assignment, growing as
        staggered re-tiers let the assignments drift apart.  Read from
        the replicas' occupancy gauges (``store.tier_rows_*``, refreshed
        at every placement)."""
        skew = 0.0
        for t in ("int8", "half", "fp32"):
            rows = [r.reg.gauges.get(f"store.tier_rows_{t}")
                    for r in self.replicas]
            rows = [v for v in rows if v is not None]
            if rows:
                skew = max(skew, max(rows) - min(rows))
        return skew

    # -- aggregation ---------------------------------------------------

    def aggregate(self) -> FleetAggregator:
        """The live fleet fold: every replica registry and the router's
        through the one ``FleetAggregator``."""
        return FleetAggregator([r.reg for r in self.replicas] + [self.reg])

    def result(self) -> FleetResult:
        """Summarise the run (call after ``flush``)."""
        self._pulse()
        per = tuple(r.steady_qps() for r in self.replicas)
        agg = self.aggregate()
        p50, p95, p99 = agg.percentiles("serve.request_us")
        route_p50 = self.reg.histogram("router.route_us").percentile(50)
        per_req_p50 = p50 / max(self.cfg.serve_batch, 1)
        overhead = route_p50 / per_req_p50 if per_req_p50 > 0 else 0.0
        return FleetResult(
            replicas=len(self.replicas), policy=self.cfg.policy,
            aggregate_qps=float(sum(per)), per_replica_qps=per,
            p50_us=p50, p95_us=p95, p99_us=p99,
            route_p50_us=route_p50, router_overhead_frac=overhead,
            requests=self.total_requests, merges=self.merges,
            divergence=self.divergence(),
            divergence_premerge=self.divergence_premerge,
            swaps_colocated=self.swaps_colocated)


def run_fleet(fleet: Fleet, make_request: Callable[[int], np.ndarray],
              requests: int, *, jsonl_paths: list[str] | None = None
              ) -> FleetResult:
    """Drive ``requests`` single-user requests through the fleet, then
    flush, merge once more (so that the final divergence gauge reads a
    converged fleet when merging is on), and summarise.

    ``jsonl_paths``: per-source snapshot streams, one path a replica and
    one for the router, each written as one final cumulative
    ``metrics_snapshot/v1`` line (the offline aggregation's input).
    """
    for r in range(requests):
        fleet.submit(make_request(r))
    fleet.flush()
    if fleet.cfg.merge_every:
        fleet.merge_priorities()
    if jsonl_paths is not None:
        regs = [r.reg for r in fleet.replicas] + [fleet.reg]
        if len(jsonl_paths) != len(regs):
            raise ValueError(
                f"need {len(regs)} snapshot paths "
                f"({len(fleet.replicas)} replicas + router), got "
                f"{len(jsonl_paths)}")
        for path, reg in zip(jsonl_paths, regs):
            obs.JsonlSink(path).write(reg)
    return fleet.result()
