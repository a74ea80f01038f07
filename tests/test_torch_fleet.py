"""The port's serving fleet (``repro_torch.serve.fleet``) against
``repro.serve.fleet``, on the CPU.

The counterparts of ``tests/test_fleet.py``'s tests, each run beside the
JAX fleet at its size (V = 160, D = 16, F = 2, the same snapped store and
pareto priorities, the same drifting-zipf request stream), tolerance 0:
the routing sequence, each replica's counters, window and priority, the
merged priority, ``divergence``, the staggered schedule, the tier skew,
the router's counters and gauges, and every batch's embeddings.  Async
replicas are compared on a schedule that does not depend on the staging
thread's timing: the boundary batch opens the build and stages it, and
the flush drains it.  Also: a fold after a merge leaves the other
replicas' priorities as they were (they share the merged tensor), the
port's fleet percentiles equal the bucket merge of its replicas'
histograms and its snapshot streams re-merge to them, and a server that
is not packed is refused.  No timing-derived inequality is checked here.
"""

from __future__ import annotations

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro import obs as jobs
from repro.core import qat_store as jqs
from repro.core.priority import priority_update
from repro.core.tiers import TierConfig
from repro.serve import Fleet as JFleet
from repro.serve import FleetConfig as JFleetConfig
from repro.serve import OnlineConfig as JOnlineConfig
from repro.serve import OnlineServer as JOnlineServer
from repro.serve import Replica as JReplica
from repro.serve import Router as JRouter
from repro.serve import drifting_zipf_batch
from repro.serve import run_fleet as jrun_fleet
from repro_torch import obs as tobs
from repro_torch.convert import qat_store_from_jax
from repro_torch.core import packed_store as tps
from repro_torch.core import qat_store as tqs
from repro_torch.serve import (Fleet, FleetConfig, OnlineConfig,
                               OnlineServer, Replica, Router, run_fleet)
from repro_torch.store.hier import HierConfig

V, D, F = 160, 16, 2
TIERS = TierConfig(t8=5.0, t16=50.0)
JCFG = jqs.FQuantConfig(tiers=TIERS, stochastic=False)
TCFG = tqs.FQuantConfig(tiers=TIERS, stochastic=False)
CARDS = np.asarray([V] * F, np.int64)   # both fields over one id space

_TOOL = (pathlib.Path(__file__).resolve().parents[1] / "tools"
         / "check_bench_schema.py")
_spec = importlib.util.spec_from_file_location("check_bench_schema", _TOOL)
check_bench_schema = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(check_bench_schema)


def _clean():
    for o in (jobs, tobs):
        o.disable()
        o.get_registry().reset()
        o.set_sink(None)


@pytest.fixture(autouse=True)
def _clean_registries():
    _clean()
    yield
    _clean()


@functools.lru_cache(maxsize=None)
def _jstore():
    """The reference test's store: ``qs.init`` rows, pareto priorities,
    snapped to the tiers."""
    rng = np.random.default_rng(0)
    st = jqs.init(jax.random.PRNGKey(0), V, D, scale=0.05)
    st = st._replace(priority=jnp.asarray(
        (rng.pareto(1.2, V) * 20).astype(np.float32)))
    return st._replace(table=jqs.snap(st.table, jqs.current_tiers(st, JCFG),
                                      JCFG))


def _request(r):
    return drifting_zipf_batch(CARDS, 1, r, 999, drift=2.0)[0]


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        x = x.detach().cpu().numpy()
    a = np.asarray(x)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.dtype.itemsize])


class Pair:
    """A JAX fleet and a port fleet of ``n`` replicas from the same store,
    each replica's ``serve_fn`` the eager ``server.lookup`` (forward and
    fold in one call), its embeddings recorded in serving order."""

    def __init__(self, n: int, serve_batch: int = 4, fleet=None,
                 **online):
        st = _jstore()
        self.outs = {"j": [], "t": []}
        jreps, treps = [], []
        for i in range(n):
            jsrv = JOnlineServer(st, JCFG, JOnlineConfig(
                cache_rows=8, retier_every=0, **online))
            tsrv = OnlineServer(qat_store_from_jax(st), TCFG, OnlineConfig(
                cache_rows=8, retier_every=0, **online))

            def jfn(mb, s=jsrv, i=i):
                out = s.lookup(jnp.asarray(mb.indices),
                               valid=mb.valid[:, None], count=mb.count)
                self.outs["j"].append((i, np.asarray(out)))
                return out

            def tfn(mb, s=tsrv, i=i):
                out = s.lookup(torch.from_numpy(mb.indices),
                               valid=mb.valid[:, None], count=mb.count)
                self.outs["t"].append((i, out.numpy().copy()))
                return out

            jreps.append(JReplica(i, jsrv, jfn, serve_batch, F))
            treps.append(Replica(i, tsrv, tfn, serve_batch, F))
        kw = dict(serve_batch=serve_batch, **(fleet or {}))
        self.j = JFleet(jreps, JFleetConfig(**kw))
        self.t = Fleet(treps, FleetConfig(**kw))

    def submit(self, requests, start: int = 0) -> list[tuple[int, int]]:
        return [(self.j.submit(_request(r)), self.t.submit(_request(r)))
                for r in range(start, start + requests)]

    def check(self) -> None:
        """Tolerance 0 across the two fleets."""
        j, t = self.j, self.t
        assert t.total_requests == j.total_requests
        assert t.merges == j.merges
        assert t.swaps_colocated == j.swaps_colocated
        assert t.divergence_premerge == j.divergence_premerge
        assert t.divergence() == j.divergence()
        assert t._next_retier == j._next_retier
        assert t.reg.counters == j.reg.counters
        assert t.reg.gauges == j.reg.gauges
        for jr, tr in zip(j.replicas, t.replicas):
            assert tr.requests == jr.requests
            assert tr._cnt == jr._cnt and tr._retiered == jr._retiered
            assert len(tr._lat) == len(jr._lat)
            assert len(tr.batcher) == len(jr.batcher)
            np.testing.assert_array_equal(tr.window.numpy(), jr.window)
            np.testing.assert_array_equal(bits(tr.priority_np()),
                                          bits(jr.priority_np()))
            assert (tr.server.stats.as_dict()
                    == jr.server.stats.as_dict())
            assert tr.reg.counters == jr.reg.counters
            assert tr.reg.gauges == jr.reg.gauges
            assert ({k: h.count for k, h in tr.reg.histograms.items()}
                    == {k: h.count for k, h in jr.reg.histograms.items()})
            jp, tp = jr.server.host_packed, tr.server.host_packed
            for name in tps.PackedStore._fields:
                want = np.asarray(getattr(jp, name))
                if want.dtype.kind == "V":
                    want = want.view(np.uint16)
                np.testing.assert_array_equal(
                    bits(getattr(tp, name)), bits(want), err_msg=name)
        assert len(self.outs["t"]) == len(self.outs["j"])
        for (ji, jo), (ti, to) in zip(self.outs["j"], self.outs["t"]):
            assert ti == ji
            np.testing.assert_array_equal(bits(to), bits(jo))


# -- router ------------------------------------------------------------

def test_round_robin_routes_and_balances_as_the_reference():
    p = Pair(3, fleet=dict(policy="round_robin", pulse_every=0))
    routes = p.submit(24)
    assert [t for _, t in routes] == [j for j, _ in routes] == [0, 1, 2] * 8
    assert [r.requests for r in p.t.replicas] == [8, 8, 8]
    assert p.t.reg.counters["router.requests"] == 24
    assert p.t.reg.counters["router.to.replica0"] == 8
    assert p.t.reg.histograms["router.route_us"].count == 24
    p.check()
    assert len(p.outs["t"]) == 6
    routers = Router("round_robin"), JRouter("round_robin")
    assert ([routers[0].pick(p.t.replicas) for _ in range(7)]
            == [routers[1].pick(p.j.replicas) for _ in range(7)])


def test_least_outstanding_picks_the_emptiest_batcher_as_the_reference():
    p = Pair(3)
    router, jrouter = Router("least_outstanding"), JRouter("least_outstanding")
    for fleet in (p.j, p.t):
        fleet.replicas[0].batcher.add(_request(0))
        fleet.replicas[0].batcher.add(_request(1))
        fleet.replicas[1].batcher.add(_request(2))
    assert router.pick(p.t.replicas) == jrouter.pick(p.j.replicas) == 2
    for fleet in (p.j, p.t):
        fleet.replicas[2].batcher.add(_request(3))
        fleet.replicas[2].batcher.add(_request(4))
    assert router.pick(p.t.replicas) == jrouter.pick(p.j.replicas) == 1
    with pytest.raises(ValueError, match="weighted_random"):
        Router("weighted_random")

    q = Pair(3, fleet=dict(policy="least_outstanding", pulse_every=5))
    routes = q.submit(23)
    assert [t for _, t in routes] == [j for j, _ in routes]
    q.check()


# -- priority merge ----------------------------------------------------

def test_merge_equals_the_jax_merge_and_its_oracle():
    """Disjoint slices make the replicas' EMAs diverge; one merge returns
    the reference's divergence, leaves every replica on the reference's
    merged vector (the eager pooled Eq. 7 step, bit for bit) and zeroes
    the divergence; a quiet second merge decays from the merged base."""
    p = Pair(2, fleet=dict(merge_every=0, pulse_every=0))
    base = p.t.replicas[0].priority_np().copy()
    p.submit(16)
    assert p.t.divergence() == p.j.divergence() > 0.0
    counts = sum(r.window.numpy().astype(np.float64)
                 for r in p.t.replicas)
    assert counts.sum() == 16 * F
    p.check()

    pre = (p.j.merge_priorities(), p.t.merge_priorities())
    assert pre[1] == pre[0] > 0.0
    assert p.t.divergence() == 0.0 and p.t.merges == 1
    pcfg = p.j.replicas[0].server.online.priority or JCFG.priority
    oracle = np.asarray(priority_update(
        jnp.asarray(base), jnp.zeros(V, jnp.float32),
        jnp.asarray(counts, jnp.float32), pcfg), np.float32)
    for rep in p.t.replicas:
        np.testing.assert_array_equal(bits(rep.priority_np()), bits(oracle))
        assert rep.window.sum() == 0
    p.check()

    p.j.merge_priorities()
    p.t.merge_priorities()
    p.check()
    assert p.t._merge_base is p.t.replicas[1].server.store.priority


def test_a_fold_after_a_merge_changes_no_other_replica():
    """Every replica holds the one merged tensor; one replica's next fold
    makes a new tensor and leaves the others' priorities as they were."""
    p = Pair(3, fleet=dict(merge_every=0, pulse_every=0))
    p.submit(12)
    p.j.merge_priorities()
    p.t.merge_priorities()
    shared = p.t.replicas[0].server.store.priority
    assert all(r.server.store.priority is shared for r in p.t.replicas)
    before = shared.clone()
    for fleet in (p.j, p.t):               # one batch on replica0 alone
        rep = fleet.replicas[0]
        for r in range(12, 16):
            mb = rep.batcher.add(_request(r))
        rep.run_batch(mb)
    assert p.t.replicas[0].server.store.priority is not shared
    for rep in p.t.replicas[1:]:
        assert rep.server.store.priority is shared
    assert torch.equal(shared, before)
    assert p.t.divergence() == p.j.divergence() > 0.0
    p.check()


def test_periodic_merges_in_the_loop_equal_the_reference():
    p = Pair(2, fleet=dict(merge_every=8, pulse_every=4))
    jres = jrun_fleet(p.j, _request, 32)
    tres = run_fleet(p.t, _request, 32)
    for key in ("replicas", "policy", "requests", "merges", "divergence",
                "divergence_premerge", "swaps_colocated"):
        assert getattr(tres, key) == getattr(jres, key), key
    assert tres.merges >= 4 and tres.divergence_premerge > 0.0
    assert tres.divergence == 0.0
    assert p.t.reg.gauges["fleet.priority_divergence"] == 0.0
    assert p.t.reg.counters["fleet.merges"] == tres.merges
    p.check()


# -- staggered re-tier scheduling --------------------------------------

@pytest.mark.parametrize("n,stagger", [(2, True), (2, False), (3, True)])
def test_retier_schedule_staggers_and_fires_as_the_reference(n, stagger):
    p = Pair(n, fleet=dict(retier_every=8, stagger=stagger, pulse_every=4))
    assert p.t._next_retier == p.j._next_retier
    if (n, stagger) == (2, True):
        assert p.t._next_retier == [8, 12]
    p.submit(32)
    p.j.flush()
    p.t.flush()
    p.j._pulse()
    p.t._pulse()
    for rep in p.t.replicas:
        assert rep.server.stats.retiers >= 1
        assert any(rep._retiered)
        assert "store.tier_rows_int8" in rep.reg.gauges
    assert (p.t.reg.gauges["fleet.tier_skew_rows"]
            == p.j.reg.gauges["fleet.tier_skew_rows"])
    assert p.t._tier_skew() == p.j._tier_skew()
    p.check()


def test_async_replicas_on_an_explicit_schedule():
    """The boundary batch of each replica opens its shadow build, takes
    one chunk (a budget over every mover) and starts staging; nothing
    else ticks before the flush drains it.  The swap's spans, the
    build histogram and the in-flight gauge land in the replica's
    registry, none in the default one."""
    p = Pair(2, fleet=dict(retier_every=8, pulse_every=0),
             retier_async=True, verify_swap=True, shadow_rows_per_step=V)
    p.submit(16)
    for jr, tr in zip(p.j.replicas, p.t.replicas):
        st = tr.server.stats
        assert (st.shadow_builds, st.shadow_chunks, st.swaps) == (1, 1, 0)
        assert tr.server.shadow is not None
        assert not tr.server._retier_pending
        assert tr._retiered == jr._retiered == [False, True]
        assert tr.reg.gauges["serve.shadow.in_flight"] == 1.0
    p.j.flush()
    p.t.flush()
    p.check()
    for rep in p.t.replicas:
        srv, h = rep.server, rep.reg.histograms
        assert srv.stats.swaps == 1 and srv.shadow is None
        for name in ("plan", "chunk", "stage", "verify", "swap"):
            assert h[f"serve.shadow.{name}_us"].count >= 1, name
        assert h["serve.shadow.build_us"].count == srv.stats.swaps
        assert rep.reg.gauges["serve.shadow.in_flight"] == 0.0
        assert rep.reg.counters["serve.shadow.swaps"] == 1
    assert not tobs.get_registry().histograms
    assert not tobs.get_registry().counters
    p.submit(8, start=16)
    p.check()


# -- fleet percentiles + end-to-end ------------------------------------

def test_run_fleet_percentiles_and_snapshot_streams(tmp_path):
    p = Pair(3, fleet=dict(merge_every=16, pulse_every=8))
    paths = [str(tmp_path / f"r{i}.jsonl") for i in range(3)]
    paths.append(str(tmp_path / "router.jsonl"))
    jres = jrun_fleet(p.j, _request, 48)
    res = run_fleet(p.t, _request, 48, jsonl_paths=paths)
    p.check()
    for key in ("requests", "merges", "divergence", "divergence_premerge",
                "swaps_colocated"):
        assert getattr(res, key) == getattr(jres, key), key
    assert len(res.per_replica_qps) == 3
    assert all(q > 0 for q in res.per_replica_qps)
    assert res.aggregate_qps == sum(res.per_replica_qps)

    oracle = tobs.Histogram()
    for rep in p.t.replicas:
        oracle.merge(rep.reg.histograms["serve.request_us"])
    assert (res.p50_us, res.p95_us, res.p99_us) == tuple(
        oracle.percentile(q) for q in (50, 95, 99))
    assert res.route_p50_us == p.t.reg.histograms[
        "router.route_us"].percentile(50)

    snaps = [tobs.last_snapshot(path) for path in paths]
    assert [s["source"] for s in snaps] == \
        ["replica0", "replica1", "replica2", "router"]
    for s in snaps:
        assert not check_bench_schema.validate(s)
    agg = tobs.FleetAggregator.from_snapshots(snaps[:3])
    assert agg.percentiles("serve.request_us") == (
        res.p50_us, res.p95_us, res.p99_us)
    assert tobs.merge_snapshots(snaps) == p.t.aggregate().snapshot()
    rec = p.t.aggregate().snapshot()
    assert rec["schema"] == "metrics_snapshot/v1"
    assert rec["source"] == "fleet"
    assert not check_bench_schema.validate(rec)
    d = res.as_dict()
    assert set(d) == set(jres.as_dict())
    assert d["divergence"] == jres.as_dict()["divergence"]

    with pytest.raises(ValueError, match="snapshot paths"):
        run_fleet(p.t, _request, 1, jsonl_paths=paths[:2])


def test_fleet_gauges_lag_queue_and_skew_equal_the_reference():
    p = Pair(2, fleet=dict(pulse_every=0))
    p.submit(17)                         # odd: one request queued
    p.j._pulse()
    p.t._pulse()
    g = p.t.reg.gauges
    assert g == p.j.reg.gauges
    assert g["fleet.queue_depth"] == 1.0
    assert "fleet.tier_skew_rows" in g and "fleet.swaps_in_flight" in g
    p.check()
    assert Pair(1).t.divergence() == 0.0
    with pytest.raises(ValueError, match="at least one replica"):
        Fleet([], FleetConfig())


def test_a_server_that_is_not_packed_is_refused():
    st = qat_store_from_jax(_jstore())
    hier = OnlineServer(st, TCFG, OnlineConfig(cache_rows=8),
                        hier=HierConfig(hbm_budget_bytes=1 << 12))
    with pytest.raises(ValueError, match="'hier' backend"):
        Replica(0, hier, lambda mb: None, 4, F)

    class Hashed:
        kind = "hashed"

    class Server:
        backend = Hashed()

    with pytest.raises(ValueError, match="'hashed' backend"):
        Replica(1, Server(), lambda mb: None, 4, F)
