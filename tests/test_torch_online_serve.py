"""The port's online serving path against the JAX package, on the CPU.

Same numpy inputs through both packages.  Bit for bit: the eager Eq. 7
fold, ``tier_crossings``, ``quantize_rows``, ``repack_delta`` (leaf for
leaf), the hot-row cache's ids, rows and hit counts, the drifting-zipf
draws and the latency histogram.  The served logits of both smoke archs
under ``--fuse-matmul`` are held to ``|d| <= 1e-5 * max(1, |ref|)`` of
the JAX serving loop's forward: on the CPU the reference's fused bag -> matmul
takes its einsum branch and its CIN an einsum pair, which sum in another
order than the port's pinned FMA chains; the counters (retiers,
rows_moved, lookups, hits) are equal.
"""

from __future__ import annotations

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro import configs as jconfigs
from repro.core import packed_store as jps
from repro.core import qat_store as jqs
from repro.core.priority import PriorityConfig as JPriorityConfig
from repro.core.priority import serve_update as j_serve_update
from repro.core.tiers import TierConfig, plan_thresholds_for_ratio
from repro.core.tiers import tier_crossings as j_tier_crossings
from repro.obs.registry import Histogram as JHistogram
from repro.serve import OnlineConfig as JOnlineConfig
from repro.serve import OnlineServer as JOnlineServer
from repro.serve import cache as jcache
from repro.serve import loop as jloop
from repro_torch import configs as tconfigs
from repro_torch import kernels as tkernels
from repro_torch.convert import (packed_from_jax, params_from_jax,
                                 qat_store_from_jax)
from repro_torch.core import packed_store as tps
from repro_torch.core import qat_store as tqs
from repro_torch.core.priority import PriorityConfig, serve_fold, serve_update
from repro_torch.core.tiers import tier_crossings
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tL
from repro_torch.obs.registry import Histogram
from repro_torch.serve import cache as tcache
from repro_torch.serve import loop as tloop
from repro_torch.serve.online import OnlineConfig, OnlineServer
from repro_torch.store.api import PackedBackend

TOL = 1e-5


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        x = x.detach().cpu().numpy()
    a = np.asarray(x)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _close(want, got):
    want = np.asarray(want, np.float64)
    got = got.detach().cpu().numpy().astype(np.float64)
    assert want.shape == got.shape
    assert np.all(np.abs(got - want) <= TOL * np.maximum(1.0, np.abs(want)))


def _host(packed) -> jps.PackedStore:
    host = jps.PackedStore(*(np.asarray(x) for x in packed))
    return host._replace(payload16=host.payload16.view(np.uint16))


def _assert_leaves_equal(jpacked, tpacked):
    for name in jps.PackedStore._fields:
        want = np.asarray(getattr(jpacked, name))
        got = getattr(tpacked, name)
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_array_equal(bits(want), bits(got), err_msg=name)


# -- the Eq. 7 fold ----------------------------------------------------------

def test_eager_fold_bit_equal_to_eager_jax_serve_update():
    """The online fold rounds each op (the reference's eager
    ``serve_update``); the training form's FMA differs in the last bit
    for some touched rows."""
    rng = np.random.default_rng(0)
    v = 200_000
    w = (rng.pareto(1.2, v) * 10).astype(np.float32)
    idx = rng.integers(0, v, (512, 40)).astype(np.int32)
    want = np.asarray(j_serve_update(jnp.asarray(w), jnp.asarray(idx),
                                     JPriorityConfig()))
    got = serve_fold(torch.from_numpy(w), torch.from_numpy(idx),
                     PriorityConfig())
    np.testing.assert_array_equal(bits(want), bits(got))
    fused = serve_update(torch.from_numpy(w), torch.from_numpy(idx),
                         PriorityConfig())
    jitted = np.asarray(jax.jit(j_serve_update)(jnp.asarray(w),
                                                jnp.asarray(idx)))
    np.testing.assert_array_equal(bits(jitted), bits(fused))
    differ = int((bits(fused) != bits(got)).sum())
    assert differ > 0


def test_eager_fold_with_valid_mask():
    rng = np.random.default_rng(1)
    w = (rng.pareto(1.2, 5000) * 10).astype(np.float32)
    idx = rng.integers(0, 5000, (64, 6)).astype(np.int32)
    valid = rng.random((64, 6)) < 0.7
    want = j_serve_update(jnp.asarray(w), jnp.asarray(idx),
                          JPriorityConfig(), valid=jnp.asarray(valid))
    got = serve_fold(torch.from_numpy(w), torch.from_numpy(idx),
                     PriorityConfig(), valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(bits(want), bits(got))


@pytest.mark.parametrize("form", ["eager", "jitted"])
def test_fold_flushes_subnormals_as_jax(form):
    """Thirty folds decay unseen rows (x 0.01 a fold) through the
    subnormal range: the reference's XLA flushes them to zero, and so
    must the port, or the hot cache breaks its ties at 0 another way.
    Both forms: the online server's eager fold and the train step's
    jitted one."""
    rng = np.random.default_rng(2)
    v = 4000
    w = (rng.pareto(1.2, v) * 10).astype(np.float32)
    w[:3] = [1e-39, 2e-38, 1.1754944e-38]   # subnormal, normal, the least
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    jfold = j_serve_update if form == "eager" else jax.jit(j_serve_update)
    tfold = serve_fold if form == "eager" else serve_update
    for r in range(30):
        idx = rng.integers(0, v, (8, 5)).astype(np.int32)
        jw = jfold(jw, jnp.asarray(idx))         # the default config
        tw = tfold(tw, torch.from_numpy(idx), PriorityConfig())
        np.testing.assert_array_equal(bits(jw), bits(tw), err_msg=str(r))
    got = tw.numpy()
    assert (got == 0).sum() > v // 2
    assert not ((got != 0) & (np.abs(got) < np.finfo(np.float32).tiny)).any()


# -- re-tier ------------------------------------------------------------------

def test_tier_crossings_equal():
    rng = np.random.default_rng(2)
    old = rng.integers(0, 3, 4000).astype(np.int8)
    new = np.where(rng.random(4000) < 0.3,
                   rng.integers(0, 3, 4000), old).astype(np.int8)
    jc, jh = j_tier_crossings(old, new)
    tc, th = tier_crossings(torch.from_numpy(old), torch.from_numpy(new))
    np.testing.assert_array_equal(jc, tc.numpy())
    np.testing.assert_array_equal(jh, th.numpy())


@pytest.fixture(scope="module")
def retier_case():
    """A 3-tier store and a priority move that crosses rows every way."""
    rng = np.random.default_rng(3)
    v, d = 3000, 8
    table = (rng.standard_normal((v, d)) * 0.05).astype(np.float32)
    pri = (rng.random(v) * 2e5).astype(np.float32)
    cfg = jqs.FQuantConfig(tiers=TierConfig(5e4, 1.5e5), stochastic=False)
    store = jqs.QATStore(jnp.asarray(table), jnp.asarray(pri))
    store = store._replace(table=jqs.snap(
        store.table, jqs.current_tiers(store, cfg), cfg))
    packed = jps.pack(store, cfg)
    moved = pri.copy()
    sel = rng.random(v) < 0.25
    moved[sel] = (rng.random(int(sel.sum())) * 2e5).astype(np.float32)
    store2 = store._replace(priority=jnp.asarray(moved))
    return cfg, store, packed, store2


def test_repack_delta_leaf_equal_to_jax(retier_case):
    cfg, store, packed, store2 = retier_case
    tcfg = tqs.FQuantConfig(tiers=cfg.tiers, stochastic=False)
    old = jps.packed_tiers(packed)
    new = np.asarray(jqs.current_tiers(store2, cfg))
    changed, hist = j_tier_crossings(old, new)
    assert hist[0, 2] and hist[2, 0] and hist[1, 0]
    want = jps.repack_delta(packed, store2, cfg, changed)
    got = tps.repack_delta(packed_from_jax(_host(packed)),
                           qat_store_from_jax(store2), tcfg,
                           torch.from_numpy(changed))
    _assert_leaves_equal(_host(want), got)
    # a candidate superset moves the same rows
    everything = tps.repack_delta(packed_from_jax(_host(packed)),
                                  qat_store_from_jax(store2), tcfg,
                                  torch.arange(3000))
    _assert_leaves_equal(_host(want), everything)
    # and equals a fresh pack through the indirection
    fresh = tps.pack(qat_store_from_jax(store2), tcfg)
    probe = torch.arange(3000)
    np.testing.assert_array_equal(bits(tps.lookup(fresh, probe)),
                                  bits(tps.lookup(got, probe)))


def test_repack_delta_empties_a_tier(retier_case):
    cfg, store, packed, _ = retier_case
    tcfg = tqs.FQuantConfig(tiers=cfg.tiers, stochastic=False)
    store2 = store._replace(priority=jnp.full((3000,), 1e6, jnp.float32))
    changed = np.arange(3000)
    want = jps.repack_delta(packed, store2, cfg, changed)
    got = tps.repack_delta(packed_from_jax(_host(packed)),
                           qat_store_from_jax(store2), tcfg,
                           torch.from_numpy(changed))
    _assert_leaves_equal(_host(want), got)
    assert tps.live_counts(got) == [0, 0, 3000]


def test_quantize_rows_leaf_equal_to_jax(retier_case):
    cfg, store, _, _ = retier_case
    tcfg = tqs.FQuantConfig(tiers=cfg.tiers, stochastic=False)
    table = np.asarray(store.table)
    tiers = np.asarray(jqs.current_tiers(store, cfg))
    for ids in (np.array([5, 17, 2900, 44, 1000]), np.arange(0, 3000, 7),
                np.array([], np.int64)):
        want = jps.quantize_rows(table, ids, tiers, cfg)
        got = tps.quantize_rows(torch.from_numpy(table),
                                torch.from_numpy(ids),
                                torch.from_numpy(tiers), tcfg)
        host = want._replace(payload16=np.asarray(want.payload16).view(
            np.uint16))
        _assert_leaves_equal(host, got)


# -- hot-row cache ------------------------------------------------------------

def test_build_cache_ids_rows_and_hits_equal(retier_case):
    cfg, store, packed, _ = retier_case
    # after one fold most scores tie (counts x 0.99): ties go to the
    # lower row id in both
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 600, (256, 5)).astype(np.int32)
    pri = j_serve_update(jnp.zeros((3000,), jnp.float32), jnp.asarray(idx))
    jc = jcache.build_cache(packed, pri, 100)
    tpacked = packed_from_jax(_host(packed))
    tc = tcache.build_cache(tpacked, torch.from_numpy(np.asarray(pri)), 100)
    np.testing.assert_array_equal(np.asarray(jc.ids), tc.ids.numpy())
    np.testing.assert_array_equal(bits(jc.rows), bits(tc.rows))
    np.testing.assert_array_equal(np.asarray(jc.slot_of), tc.slot_of.numpy())
    probe = rng.integers(0, 3000, (64, 5)).astype(np.int32)
    jrows, jhits = jcache.cached_lookup(packed, jc, jnp.asarray(probe))
    trows, thits = tcache.cached_lookup(tpacked, tc,
                                        torch.from_numpy(probe))
    assert int(jhits) == int(thits) > 0
    np.testing.assert_array_equal(bits(jrows), bits(trows))
    np.testing.assert_array_equal(
        bits(trows), bits(tps.lookup(tpacked, torch.from_numpy(probe))))
    empty = tcache.build_cache(tpacked, torch.zeros(3000), 0)
    assert empty.capacity == 0


@pytest.mark.parametrize("v,k", [(1, 1), (500, 0), (500, 37), (500, 500),
                                 (500, 900)])
def test_top_rows_is_a_stable_descending_sort(v, k):
    """Heavy ties (scores are counts x 0.99): the top k by score, ties to
    the lower id, as ``jax.lax.top_k``."""
    rng = np.random.default_rng(v + k)
    pri = (rng.integers(0, 4, v) * 0.99).astype(np.float32)
    want = np.argsort(-pri, kind="stable")[:k]
    np.testing.assert_array_equal(
        tcache.top_rows(torch.from_numpy(pri), k).numpy(), want)
    if 0 < k <= v:
        _, jids = jax.lax.top_k(jnp.asarray(pri), k)
        np.testing.assert_array_equal(np.asarray(jids), want)


# -- loop helpers -------------------------------------------------------------

def test_drifting_zipf_batch_equal():
    cards = np.array([100, 7, 5000, 3])
    for r in (0, 1, 9):
        np.testing.assert_array_equal(
            jloop.drifting_zipf_batch(cards, 32, r, 10, drift=4.0, seed=2),
            tloop.drifting_zipf_batch(cards, 32, r, 10, drift=4.0, seed=2))


def test_histogram_and_latency_summary_equal():
    rng = np.random.default_rng(5)
    lat = rng.lognormal(6, 1, 40)
    ret = np.where(rng.random(40) < 0.2, lat * 0.5, 0.0)
    window = ret > 0
    jh, th = JHistogram(), Histogram()
    jh.record_many(lat)
    th.record_many(lat)
    for q in (0, 50, 95, 99, 100):
        assert jh.percentile(q) == th.percentile(q)
    assert (jloop._latency_summary(lat, ret, slice(1, None), window)
            == tloop._latency_summary(lat, ret, slice(1, None), window))


def test_mlp_tail_equals_mlp():
    gen = torch.Generator().manual_seed(0)
    params = tL.mlp_init(gen, (12, 8, 4, 1), torch.device("cpu"))
    x = torch.randn((5, 12), generator=gen)
    np.testing.assert_array_equal(
        bits(tL.mlp(params, x)),
        bits(tL.mlp_tail(params, x @ params["l0"]["w"])))


# -- the online loop at smoke size ------------------------------------------

def _jax_online(name: str, requests: int, batch: int):
    """The reference CLI's online start (repro/launch/serve.py) at smoke
    size, with a random wide table so that the wide branch is exercised;
    then its online loop, with each request's logits recorded."""
    arch = jconfigs.get(name)
    model = arch.smoke_model
    spec = model.spec
    params = model.init(jax.random.PRNGKey(0))
    wide = np.random.default_rng(6).standard_normal(
        params["wide_table"].shape).astype(np.float32) * 0.1
    params["wide_table"] = jnp.asarray(wide)
    rng = np.random.default_rng(0)
    pri = jnp.asarray((rng.pareto(1.2, spec.total_rows) * 10)
                      .astype(np.float32))
    cfg = jqs.FQuantConfig(tiers=plan_thresholds_for_ratio(pri, spec.dim,
                                                           0.5),
                           stochastic=False)
    store = jqs.QATStore(params["embed_table"], pri)
    store = store._replace(table=jqs.snap(
        store.table, jqs.current_tiers(store, cfg), cfg))
    server = JOnlineServer(store, cfg, JOnlineConfig(cache_rows=256,
                                                     retier_every=2))
    outs = []
    run_loop = jloop.run_loop

    def spy(server, serve_fn, make_batch, requests, batch):
        def recorded(idx):
            out = serve_fn(idx)
            outs.append(np.asarray(out))
            return out
        return run_loop(server, recorded, make_batch, requests, batch)

    jloop.run_loop = spy
    try:
        res = jloop.serve_forward_loop(server, model, spec, params,
                                       batch=batch, requests=requests,
                                       fuse_matmul=True)
    finally:
        jloop.run_loop = run_loop
    return params, store, cfg, outs, res.stats, server


@pytest.mark.parametrize("name", ["wide-deep", "xdeepfm"])
def test_online_fused_serve_matches_jax_loop(name):
    requests, batch = 6, 64
    jparams, jstore, jcfg, jouts, jstats, jserver = _jax_online(
        name, requests, batch)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    tparams.pop("embed_table")
    cfg = tqs.FQuantConfig(tiers=jcfg.tiers, stochastic=False)
    server = OnlineServer(qat_store_from_jax(jstore), cfg,
                          OnlineConfig(cache_rows=256, retier_every=2))
    model = tconfigs.get(name).smoke_model
    outs = []

    def audit(r, idx):
        return lambda out, emb: outs.append(out)

    tkernels.reset_launches()
    res = tloop.serve_forward_loop(server, model, model.spec, tparams,
                                   batch=batch, requests=requests,
                                   fuse_matmul=True, audit=audit)
    assert tkernels.launch_counts() == dict.fromkeys(
        ("dequant_bag", "bag_grad", "dequant_bag_rowgrid", "bag_grad_rowgrid",
         "bag_matmul", "cin", "hashed_gather", "quantize_rowwise"), 0)
    assert len(outs) == len(jouts) == requests
    for want, got in zip(jouts, outs):
        _close(want, got)
    for key in ("requests", "retiers", "rows_moved", "lookups", "hits"):
        assert res.stats[key] == jstats[key], key
    assert res.stats["retiers"] == 3 and res.stats["rows_moved"] > 0
    assert (res.stats["hits"] > 0) == (name == "xdeepfm")
    # the state the loop leaves behind is the reference's
    np.testing.assert_array_equal(bits(jserver.store.priority),
                                  bits(server.store.priority))
    _assert_leaves_equal(_host(jserver.host_packed), server.packed)


@pytest.mark.parametrize("name", ["wide-deep", "xdeepfm"])
def test_heads_match_jax(name):
    """The unfused heads (what the card check compares the fused logits
    to) against the reference on the same embeddings, and the fused head
    against the unfused one."""
    jmodel = jconfigs.get(name).smoke_model
    tmodel = tconfigs.get(name).smoke_model
    spec = jmodel.spec
    params = jmodel.init(jax.random.PRNGKey(1))
    params["wide_table"] = jnp.asarray(np.random.default_rng(7).standard_normal(
        params["wide_table"].shape).astype(np.float32))
    tparams = params_from_jax(jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(8)
    b = 9
    idx = (rng.random((b, spec.num_fields))
           * np.asarray(spec.cardinalities)[None, :]).astype(np.int32)
    emb = (rng.standard_normal((b, spec.num_fields, spec.dim)) * 0.1
           ).astype(np.float32)
    want = jmodel.head(params, jnp.asarray(emb), {"indices": jnp.asarray(idx)})
    tb = {"indices": torch.from_numpy(idx)}
    temb = torch.from_numpy(emb)
    got = tmodel.head(tparams, temb, tb)
    _close(want, got)

    def bm(w):
        return temb.reshape(b, -1) @ w

    fused = tmodel.extras["fused_head"]
    extra = (temb,) if tmodel.extras["fused_needs_emb"] else ()
    _close(np.asarray(got), fused(tparams, tb, bm, *extra))


def test_online_cli_on_cpu_records_zero_launches():
    for arch in ("wide-deep", "xdeepfm", "dlrm-rm2"):
        out = io.StringIO()
        argv = ["--arch", arch, "--online", "--model", "smoke",
                "--device", "cpu", "--requests", "3", "--batch", "32"]
        if arch != "dlrm-rm2":
            argv.append("--fuse-matmul")
        with contextlib.redirect_stdout(out):
            tserve.main(argv)
        rec = json.loads(out.getvalue().strip().splitlines()[-1])
        for key in ("qps", "steady_qps", "p50_us", "p95_us", "p99_us",
                    "latency_p99", "p99_retier_attributed",
                    "p99_while_retiering", "requests", "lookups", "hits",
                    "cache_hit_rate", "retiers", "rows_moved", "cache_rows",
                    "retier_every", "retier_async", "drift", "serve_batch",
                    "fuse_matmul", "store_backend", "packed_mib",
                    "packed_fp32_ratio", "mesh", "online", "device_name",
                    "model"):
            assert key in rec, key
        assert rec["kernel_launches"] == dict.fromkeys(
            ("dequant_bag", "bag_grad", "dequant_bag_rowgrid",
             "bag_grad_rowgrid", "bag_matmul", "cin", "hashed_gather",
             "quantize_rowwise"), 0)
        assert rec["device"] == "cpu" and rec["online"] is True
        assert rec["requests"] == 3 and rec["retiers"] == 1


@pytest.mark.parametrize("arch", ["wide-deep", "xdeepfm"])
def test_offline_cli_serves_the_new_archs_on_cpu(arch):
    rec = tserve.run(tserve.parse_args(
        ["--arch", arch, "--model", "smoke", "--device", "cpu",
         "--requests", "2", "--batch", "8"])).record
    assert rec["device"] == "cpu" and rec["kernel_launches"] == 0
    assert rec["arch"] == arch and sum(rec["tier_rows"]) > 0


def test_refusals():
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            tserve.parse_args(["--fuse-matmul"])
    with pytest.raises(ValueError, match="no fused head"):
        tserve.run(tserve.parse_args(
            ["--arch", "dlrm-rm2", "--online", "--fuse-matmul", "--model",
             "smoke", "--device", "cpu", "--requests", "1", "--batch", "4"]))
    store = tqs.QATStore(torch.zeros((10, 4)), torch.zeros(10))
    cfg = tqs.FQuantConfig()
    # shadow re-tiers are ported: a store with nothing to move opens none
    server = OnlineServer(store, cfg, OnlineConfig(retier_async=True))
    assert not server.begin_retier() and server.shadow is None
    assert server.stats.retiers == 1 and server.stats.shadow_builds == 0
    # the hier store is ported: a budget that cannot hold the table spills
    # to host RAM (no cold level without a host budget)
    from repro_torch.store.hier import HierConfig
    hsrv = OnlineServer(store, cfg, hier=HierConfig(hbm_budget_bytes=64))
    assert hsrv.backend.kind == "hier" and hsrv.hier.counts()["warm_rows"]
    with pytest.raises(ValueError, match="store_dir"):
        OnlineServer(store, cfg, hier=HierConfig(hbm_budget_bytes=64,
                                                 host_budget_bytes=64))
    backend = PackedBackend(store, cfg)
    assert backend.prewarm_retier(512) is None
    assert backend.begin_retier(512) is None
    assert backend.retier() == {"rows_moved": 0, "changed": False}
