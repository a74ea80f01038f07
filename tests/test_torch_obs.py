"""The port's ``obs`` layer against ``repro.obs``, on the CPU.

Same value streams into both packages, tolerance 0: the histogram and
registry snapshots, merges, statsd lines and the JSONL sink's lines
(``seq`` / ``ticks`` cadence) are equal, and each package reads the
other's snapshots back to the same percentiles.  Spans: the disabled
span is the shared null singleton and records nothing; paths nest;
exceptions pop and record.  Served values: ``OnlineServer.lookup`` with
metrics on is bit-identical to metrics off, and its padding accounting
is the reference's.  At smoke size the online loop's counters, gauges
and histogram counts equal the JAX server's, fused and unfused, and the
serve driver's ``--metrics-out`` stream validates.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro import configs as jconfigs
from repro import obs as jobs
from repro.core import qat_store as jqs
from repro.core.tiers import TierConfig, plan_thresholds_for_ratio
from repro.serve import OnlineConfig as JOnlineConfig
from repro.serve import OnlineServer as JOnlineServer
from repro.serve import loop as jloop
from repro_torch import configs as tconfigs
from repro_torch import obs as tobs
from repro_torch.convert import params_from_jax, qat_store_from_jax
from repro_torch.core import qat_store as tqs
from repro_torch.launch import serve as tserve
from repro_torch.obs import trace as ttrace
from repro_torch.serve import loop as tloop
from repro_torch.serve.online import OnlineConfig, OnlineServer

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
    """Every test starts and leaves both default registries disabled,
    empty and without a sink: the process-global state must not leak."""
    _clean()
    yield
    _clean()


# -- histograms and registries ----------------------------------------------

def _streams():
    rng = np.random.default_rng(0)
    return {
        "edges": np.array([0.0, 1e-3, 0.5, 0.999999, 1.0, 1.0000001, 3.7,
                           10.0, 123.456, 1e6, 1e9, 2.5e9, 7e12]),
        "below_one": rng.uniform(0.0, 1.0, 300),
        "lognormal": rng.lognormal(7.0, 1.5, 2000),
        "past_1e9": rng.uniform(5e8, 5e10, 200),
        "constant": np.full(50, 1500.0),
        "with_zero": np.concatenate([np.zeros(7), rng.uniform(1, 1e4, 93)]),
        "empty": np.zeros(0),
    }


STREAMS = tuple(_streams())


@pytest.mark.parametrize("name", STREAMS)
def test_histogram_snapshot_equal(name):
    vals = _streams()[name]
    jh, th = jobs.Histogram(), tobs.Histogram()
    jh.record_many(vals)
    th.record_many(vals)
    assert th.snapshot() == jh.snapshot()
    for q in (0, 1, 50, 95, 99, 99.9, 100):
        assert th.percentile(q) == jh.percentile(q)
    back = tobs.Histogram.from_snapshot(jh.snapshot())
    assert back.snapshot() == jh.snapshot()


def _feed(obs_mod, reg, vals) -> None:
    for i, v in enumerate(vals):
        reg.observe("lat_us", v)
        reg.inc("n")
        reg.inc("bytes", 0.5 * i)
        reg.gauge("last", v)
    reg.histogram("never_us")


@pytest.mark.parametrize("name", STREAMS)
def test_registry_snapshot_equal(name):
    vals = _streams()[name]
    jreg, treg = jobs.Registry(), tobs.Registry(name="replica0")
    jreg.name = "replica0"
    _feed(jobs, jreg, vals)
    _feed(tobs, treg, vals)
    js, ts = jobs.snapshot(jreg), tobs.snapshot(treg)
    assert ts == js
    assert ts["source"] == "replica0"
    assert check_bench_schema.validate(ts) == []
    assert tobs.statsd_lines(treg) == jobs.statsd_lines(jreg)


def _dyadic(seed: int, n: int) -> np.ndarray:
    """Values whose float sums are exact in any order."""
    return np.random.default_rng(seed).integers(0, 1 << 20, n) / 8.0


def test_merge_is_associative_and_equal_to_the_reference():
    parts = [_dyadic(s, n) for s, n in ((1, 100), (2, 37), (3, 0), (4, 500))]

    def hist(mod, vals):
        h = mod.Histogram()
        h.record_many(vals)
        return h

    for mod in (jobs, tobs):
        left = hist(mod, parts[0]).merge(hist(mod, parts[1])).merge(
            hist(mod, parts[2]).merge(hist(mod, parts[3])))
        right = hist(mod, parts[0]).merge(
            hist(mod, parts[1]).merge(hist(mod, parts[2]))).merge(
            hist(mod, parts[3]))
        union = hist(mod, np.concatenate(parts))
        assert left.snapshot() == right.snapshot() == union.snapshot()
    merged = [hist(m, parts[0]).merge(hist(m, parts[3])).snapshot()
              for m in (jobs, tobs)]
    assert merged[0] == merged[1]
    jregs, tregs = [], []
    for mod, out in ((jobs, jregs), (tobs, tregs)):
        for s, vals in enumerate(parts):
            reg = mod.Registry()
            _feed(mod, reg, vals)
            reg.gauge("part", float(s))
            out.append(reg)
        out[0].merge(out[1]).merge(out[2]).merge(out[3])
    assert tobs.snapshot(tregs[0]) == jobs.snapshot(jregs[0])


# -- export ------------------------------------------------------------------

def _drive(mod, path, every: int) -> list[dict]:
    mod.enable()
    mod.set_sink(mod.JsonlSink(str(path), every=every))
    mod.ensure_histograms(["store.migrate_us"])
    for i, v in enumerate(_streams()["lognormal"][:11]):
        mod.inc("serve.requests")
        mod.inc("serve.lookups", 8)
        mod.gauge("serve.cache.hit_rate", 1.0 / (i + 1))
        mod.observe("serve.request_us", v)
        mod.tick()
    mod.flush()
    mod.inc("serve.requests")
    mod.tick()
    mod.close_sink()
    mod.close_sink()                     # idempotent
    mod.disable()
    return [json.loads(ln) for ln in path.read_text().splitlines()]


@pytest.mark.parametrize("every", [0, 2, 3])
def test_jsonl_sink_lines_equal(tmp_path, every):
    jrecs = _drive(jobs, tmp_path / "j.jsonl", every)
    trecs = _drive(tobs, tmp_path / "t.jsonl", every)
    assert trecs == jrecs
    assert [r["seq"] for r in trecs] == list(range(1, len(trecs) + 1))
    assert trecs[-1]["ticks"] == 12
    assert len(trecs) == {0: 2, 2: 7, 3: 5}[every]
    for r in trecs:
        assert check_bench_schema.validate(r) == []
    assert (tmp_path / "t.jsonl").read_text() == (
        tmp_path / "j.jsonl").read_text()


def test_tick_and_flush_are_noops_when_disabled(tmp_path):
    path = tmp_path / "m.jsonl"
    tobs.set_sink(tobs.JsonlSink(str(path), every=1))
    for _ in range(5):
        tobs.tick()
        tobs.inc("n")
    tobs.flush()
    tobs.close_sink()
    assert path.read_text() == ""
    assert tobs.get_registry().ticks == 0
    assert not tobs.get_registry().counters


def test_registry_from_snapshot_reads_the_other_package():
    for src, dst in ((jobs, tobs), (tobs, jobs)):
        reg = src.Registry(name="r1")
        _feed(src, reg, _streams()["lognormal"])
        snap = src.snapshot(reg)
        back = dst.registry_from_snapshot(snap)
        assert back.name == "r1" and back.counters == snap["counters"]
        h = back.histograms["lat_us"]
        for q in (50, 95, 99):
            assert h.percentile(q) == snap["histograms"]["lat_us"][f"p{q}"]
        assert dst.snapshot(back)["histograms"] == snap["histograms"]


# -- spans and timeblocks ----------------------------------------------------

def test_disabled_span_is_the_null_singleton():
    sp = tobs.span("serve.lookup")
    assert sp is ttrace._NULL_SPAN and tobs.span("other") is sp
    x = torch.ones(3)
    with sp as s:
        assert s.sync(x) is x
        assert tobs.current_path() == ""
    with tobs.timeblock("serve.request") as tb:
        pass
    assert tb.seconds >= 0.0
    assert not tobs.get_registry().histograms


def test_span_nesting_and_exceptions():
    tobs.enable()
    with tobs.span("a") as a:
        with tobs.span("b") as b:
            assert tobs.current_path() == "a/b"
        assert tobs.current_path() == "a"
    assert (a.path, b.path) == ("a", "a/b")
    assert tobs.current_path() == ""
    with pytest.raises(ValueError):
        with tobs.span("outer"):
            with tobs.span("boom"):
                raise ValueError("x")
    assert tobs.current_path() == ""
    hists = tobs.get_registry().histograms
    assert {k: h.count for k, h in hists.items()} == {
        "a_us": 1, "b_us": 1, "outer_us": 1, "boom_us": 1}
    tb = tobs.timeblock("pipeline.x").start()
    assert tb.stop() >= 0.0
    with tobs.timeblock():               # unnamed: measures, records nothing
        pass
    assert hists["pipeline.x_us"].count == 1 and len(hists) == 5


def test_bind_scopes_the_module_calls():
    tobs.enable()
    mine = tobs.Registry(name="replica3")
    with tobs.bind(mine):
        assert tobs.get_registry() is mine
        tobs.inc("serve.requests", 2)
        with tobs.span("serve.lookup"):
            pass
        tobs.tick()
    tobs.inc("serve.requests")
    assert mine.counters == {"serve.requests": 2} and mine.ticks == 1
    assert mine.histograms["serve.lookup_us"].count == 1
    assert tobs.get_registry().counters == {"serve.requests": 1}
    off = tobs.Registry(enabled=False)
    with tobs.bind(off):
        assert tobs.span("x") is ttrace._NULL_SPAN
        tobs.inc("n")
    assert not off.counters


# -- served values and accounting --------------------------------------------

V, D = 160, 24
TIERS = TierConfig(t8=5.0, t16=50.0)


def _jstore(seed: int):
    """The reference test's store (``tests/test_obs.py::_store``)."""
    cfg = jqs.FQuantConfig(tiers=TIERS, stochastic=False)
    rng = np.random.default_rng(seed)
    st = jqs.init(jax.random.PRNGKey(seed), V, D, scale=0.05)
    pri = jnp.asarray((rng.pareto(1.2, V) * 20).astype(np.float32))
    st = st._replace(priority=pri)
    return st._replace(table=jqs.snap(st.table, jqs.current_tiers(st, cfg),
                                      cfg)), cfg


def _tstore(seed: int):
    st, _ = _jstore(seed)
    return (qat_store_from_jax(jax.device_get(st)),
            tqs.FQuantConfig(tiers=TIERS, stochastic=False))


def test_eager_lookup_valid_excludes_padding_from_accounting():
    st, cfg = _tstore(5)
    jst, jcfg = _jstore(5)
    online = dict(cache_rows=24, retier_every=0)
    srv = OnlineServer(st, cfg, OnlineConfig(**online))
    ref = OnlineServer(st, cfg, OnlineConfig(**online))
    jsrv = JOnlineServer(jst, jcfg, JOnlineConfig(**online))
    hot = srv.cache.ids.numpy()[:2]
    assert np.array_equal(hot, np.asarray(jsrv.cache.ids)[:2])
    idx = np.stack([np.array([hot[0], hot[1]]),
                    np.array([0, 0])]).astype(np.int32)   # row 2 = pad
    valid = np.array([True, False])[:, None]
    out_m = srv.lookup(torch.from_numpy(idx), valid=valid, count=1)
    out_p = ref.lookup(torch.from_numpy(idx[:1]), count=1)
    jout = jsrv.lookup(jnp.asarray(idx), valid=valid, count=1)
    # masking fixes the books, never the rows
    assert torch.equal(out_m[:1], out_p)
    assert np.array_equal(out_m.numpy(), np.asarray(jout))
    assert srv.stats.lookups == ref.stats.lookups == jsrv.stats.lookups == 2
    assert srv.stats.hits == ref.stats.hits == jsrv.stats.hits == 2
    assert srv.stats.hit_rate == jsrv.stats.hit_rate == 1.0
    assert torch.equal(srv.store.priority, ref.store.priority)
    assert np.array_equal(srv.store.priority.numpy(),
                          np.asarray(jsrv.store.priority))


def test_serving_bit_identical_with_metrics_on(tmp_path):
    """Turning the registry on changes no served byte; with it off no
    metric is recorded.  The counters equal the JAX server's."""
    idx = np.arange(8, dtype=np.int32).reshape(4, 2)
    online = dict(cache_rows=16, retier_every=2)

    def serve_once():
        st, cfg = _tstore(6)
        srv = OnlineServer(st, cfg, OnlineConfig(**online))
        return torch.stack([srv.lookup(torch.from_numpy(idx), count=1)
                            for _ in range(4)])

    off = serve_once()
    assert not tobs.get_registry().histograms
    assert not tobs.get_registry().counters
    tobs.enable()
    path = tmp_path / "m.jsonl"
    tobs.set_sink(tobs.JsonlSink(str(path), every=2))
    on = serve_once()
    tobs.flush()
    assert torch.equal(on.view(torch.int32), off.view(torch.int32))

    jobs.enable()
    jst, jcfg = _jstore(6)
    jsrv = JOnlineServer(jst, jcfg, JOnlineConfig(**online))
    jon = np.stack([np.asarray(jsrv.lookup(jnp.asarray(idx), count=1))
                    for _ in range(4)])
    assert np.array_equal(jon, on.numpy())
    reg, jreg = tobs.get_registry(), jobs.get_registry()
    assert reg.counters == jreg.counters
    assert reg.counters["serve.requests"] == 4
    assert reg.gauges == jreg.gauges
    assert reg.gauges["serve.cache.rows"] == 16.0
    assert reg.histograms["serve.retier_us"].count == 2
    assert ({k: h.count for k, h in reg.histograms.items()}
            == {k: h.count for k, h in jreg.histograms.items()})
    recs = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert recs and all(check_bench_schema.validate(r) == [] for r in recs)


def test_backend_identity_occupancy_and_lookups_equal_jax():
    """The backends' new surface against the reference's on the same
    store: ``vocab``, ``dim``, ``priority``, ``live_counts``,
    ``occupancy`` (the gauges' names and values) and the eager ``lookup``
    / ``bag_lookup`` (bit for bit)."""
    from repro.store import build as jbuild
    from repro.store import hashed as jH
    from repro_torch.convert import (hashed_config_from_jax,
                                     hashed_store_from_jax)
    from repro_torch.store.api import build as tbuild
    jst, jcfg = _jstore(7)
    tst, tcfg = _tstore(7)
    jb, tb = jbuild("packed", jst, jcfg), tbuild("packed", tst, tcfg)
    assert (tb.vocab, tb.dim) == (jb.vocab, jb.dim) == (V, D)
    assert torch.equal(tb.priority, torch.from_numpy(np.array(jb.priority)))
    assert tb.live_counts() == jb.live_counts()
    assert tb.occupancy() == jb.occupancy()
    rng = np.random.default_rng(7)
    idx = rng.integers(0, V, (9, 3)).astype(np.int32)
    w = rng.standard_normal((9, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tb.lookup(torch.from_numpy(idx)).numpy(),
        np.asarray(jb.lookup(jnp.asarray(idx))))
    np.testing.assert_array_equal(
        tb.bag_lookup(torch.from_numpy(idx), torch.from_numpy(w)).numpy(),
        np.asarray(jb.bag_lookup(jnp.asarray(idx), jnp.asarray(w))))
    hcfg = jH.HashedConfig(vocab=V, dim=D, chunk_dim=8, num_slots=64)
    hs = jH.init_hashed(hcfg, priority=jst.priority)
    jh = jbuild("hashed", hs, hcfg)
    th = tbuild("hashed", hashed_store_from_jax(jax.device_get(hs)),
                hashed_config_from_jax(hcfg))
    assert th.live_counts() == jh.live_counts()
    assert th.occupancy() == jh.occupancy()


def _jax_server(name: str):
    """The reference CLI's online start at smoke size (random wide table,
    so that the wide branch is exercised)."""
    model = jconfigs.get(name).smoke_model
    spec = model.spec
    params = model.init(jax.random.PRNGKey(0))
    params["wide_table"] = jnp.asarray(np.random.default_rng(6).standard_normal(
        params["wide_table"].shape).astype(np.float32) * 0.1)
    pri = jnp.asarray((np.random.default_rng(0).pareto(1.2, spec.total_rows)
                       * 10).astype(np.float32))
    cfg = jqs.FQuantConfig(tiers=plan_thresholds_for_ratio(pri, spec.dim, 0.5),
                           stochastic=False)
    store = jqs.QATStore(params["embed_table"], pri)
    store = store._replace(table=jqs.snap(
        store.table, jqs.current_tiers(store, cfg), cfg))
    return model, params, store, cfg


@pytest.mark.parametrize("fuse_matmul", [False, True],
                         ids=["unfused", "fused"])
def test_online_loop_metrics_equal_jax(fuse_matmul):
    name, requests, batch = "wide-deep", 5, 48
    jmodel, jparams, jstore, jcfg = _jax_server(name)
    online = dict(cache_rows=256, retier_every=2)
    jobs.enable()
    jobs.ensure_histograms(f"{p}_us" for p in jloop.SERVE_PHASES)
    jserver = JOnlineServer(jstore, jcfg, JOnlineConfig(**online))
    jres = jloop.serve_forward_loop(jserver, jmodel, jmodel.spec, jparams,
                                    batch=batch, requests=requests,
                                    fuse_matmul=fuse_matmul)
    tmodel = tconfigs.get(name).smoke_model
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    tparams.pop("embed_table")
    tobs.enable()
    tobs.ensure_histograms(f"{p}_us" for p in tloop.SERVE_PHASES)
    assert tloop.SERVE_PHASES == jloop.SERVE_PHASES
    server = OnlineServer(qat_store_from_jax(jax.device_get(jstore)),
                          tqs.FQuantConfig(tiers=jcfg.tiers, stochastic=False),
                          OnlineConfig(**online))
    res = tloop.serve_forward_loop(server, tmodel, tmodel.spec, tparams,
                                   batch=batch, requests=requests,
                                   fuse_matmul=fuse_matmul)
    js, ts = jobs.snapshot(), tobs.snapshot()
    assert ts["counters"] == js["counters"]
    assert ts["gauges"] == js["gauges"]
    assert ({k: h["count"] for k, h in ts["histograms"].items()}
            == {k: h["count"] for k, h in js["histograms"].items()})
    assert ts["ticks"] == js["ticks"] == requests
    c = ts["counters"]
    assert c["serve.requests"] == res.stats["requests"] == requests
    assert c["serve.lookups"] == res.stats["lookups"] == jres.stats["lookups"]
    assert c["serve.cache.hits"] == res.stats["hits"]
    assert c["serve.retier.rows_moved"] == res.stats["rows_moved"] > 0
    assert ts["histograms"]["serve.retier_us"]["count"] == res.stats["retiers"]
    assert check_bench_schema.validate(ts) == []


def test_serve_cli_metrics_out_validates(tmp_path):
    path = tmp_path / "m.jsonl"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve.main(["--model", "smoke", "--device", "cpu", "--online",
                     "--requests", "5", "--batch", "32", "--metrics-out",
                     str(path), "--metrics-every", "2"])
    rec = json.loads(out.getvalue().strip().splitlines()[-1])
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert len(lines) == 3           # ticks 2 and 4, then the final flush
    for r in lines:
        assert check_bench_schema.validate(r) == []
    last = lines[-1]
    assert last["ticks"] == 5
    for key, metric in (("requests", "serve.requests"),
                        ("lookups", "serve.lookups"),
                        ("hits", "serve.cache.hits"),
                        ("rows_moved", "serve.retier.rows_moved")):
        assert last["counters"][metric] == rec[key], key
    assert last["histograms"]["serve.retier_us"]["count"] == rec["retiers"]
    assert set(last["histograms"]) == {f"{p}_us" for p in tloop.SERVE_PHASES}
    assert last["gauges"]["store.packed_bytes"] > 0
    tobs.disable()
    tobs.get_registry().reset()
    # the offline path records each request and flushes once
    path2 = tmp_path / "off.jsonl"
    with contextlib.redirect_stdout(io.StringIO()):
        tserve.main(["--model", "smoke", "--device", "cpu", "--requests",
                     "3", "--batch", "8", "--metrics-out", str(path2)])
    off = [json.loads(ln) for ln in path2.read_text().splitlines()]
    assert len(off) == 1 and off[0]["ticks"] == 3
    assert off[0]["histograms"]["serve.request_us"]["count"] == 3
