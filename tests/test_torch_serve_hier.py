"""Online serving through the port's hierarchical store, against the JAX
package, on the CPU.

The bench DLRM (``benchmarks/qps.py``'s fixture, the reference's params
carried across by ``convert.py``) served micro-batched through
``OnlineServer(hier=HierConfig(...))`` on the reference's drifting-zipf
stream, synchronous migrations and shadow ones: every integer counter of
``LoopResult.stats`` (the hier counters and the level rows included) and
the cache ids equal the JAX server's, the Eq. 7 priorities and the levels
are bit-equal, and each batch's logits agree within ``TOL`` * max(1,
|ref|) (fp32, the head's matmuls); the embeddings the head got are the
flat store's bit for bit.  ``run_hier_sweep`` at a small config gives the
reference's integer fields and miss rates, and both records pass the
unchanged ``tools/check_bench_schema.py``.  The serve CLI serves the
smoke models through the hier store with ``--verify-hier`` (synchronous
and shadow migrations), and refuses the reference's flag combinations.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro.serve import loop as jloop
from repro.serve import OnlineConfig as JOnlineConfig
from repro.serve import OnlineServer as JOnlineServer
from repro.store import HierConfig as JHierConfig
from repro_torch.benchmarks import hier as thier_bench
from repro_torch.benchmarks import qps as tqps
from repro_torch.convert import params_from_jax
from repro_torch.core import packed_store as tps
from repro_torch.launch import serve as tserve
from repro_torch.serve import loop as tloop
from repro_torch.serve.online import OnlineConfig, OnlineServer
from repro_torch.store.hier import HierConfig, hier_lookup

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import hier as jhier_bench  # noqa: E402
from benchmarks import qps as jqps  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "check_bench_schema", ROOT / "tools" / "check_bench_schema.py")
check_bench_schema = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(check_bench_schema)

TOL = 1e-5
STAT_KEYS = ("requests", "lookups", "hits", "retiers", "rows_moved",
             "shadow_builds", "swaps", "staged_rows", "warm_hits",
             "cold_hits", "migrations", "promoted", "demoted", "hot_rows",
             "warm_rows", "cold_rows", "hier_miss_rate", "cache_hit_rate")


def _capture(monkeypatch, module, outs: list) -> None:
    """Record every batch's output of ``module``'s staged loop."""
    inner = module.run_microbatched_loop

    def loop(server, serve_fn, *args, **kw):
        def fn(mb):
            out = serve_fn(mb)
            outs.append(np.asarray(out.detach().numpy()
                                   if isinstance(out, torch.Tensor)
                                   else out))
            return out
        return inner(server, fn, *args, **kw)
    monkeypatch.setattr(module, "run_microbatched_loop", loop)


@pytest.fixture(scope="module")
def bench():
    """The reference's bench store and the port's from its params."""
    jsetup, jspec, jparams, jstore, jcfg = jqps._bench_store(0.5)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    tsetup, tspec, tparams, tstore, tcfg = tqps._bench_store(
        0.5, params=tparams, device="cpu")
    return (jsetup, jspec, jparams, jstore, jcfg), (tsetup, tspec, tparams,
                                                    tstore, tcfg)


@pytest.mark.parametrize("retier_async", [False, True])
def test_serve_forward_matches_the_jax_server(bench, tmp_path, monkeypatch,
                                              retier_async):
    (jsetup, jspec, jparams, jstore, jcfg), (tsetup, tspec, tparams, tstore,
                                             tcfg) = bench
    full = tps.pack(tstore, tcfg).nbytes()
    budget = full // 10
    online = dict(cache_rows=16, retier_every=16, retier_async=retier_async,
                  shadow_rows_per_step=1 << 16)
    jsrv = JOnlineServer(jstore, jcfg, JOnlineConfig(**online),
                         hier=JHierConfig(budget, budget,
                                          store_dir=str(tmp_path / "j")))
    tsrv = OnlineServer(tstore, tcfg, OnlineConfig(**online),
                        hier=HierConfig(budget, budget,
                                        store_dir=str(tmp_path / "t")))
    assert tsrv.hier.counts() == jsrv.hier.counts()
    jouts, touts, embs = [], [], []
    _capture(monkeypatch, jloop, jouts)
    _capture(monkeypatch, tloop, touts)
    kw = dict(serve_batch=8, requests=56, drift=4.0,
              num_dense=tsetup.ds.cfg.num_dense)
    jres = jloop.serve_forward_hier(jsrv, jsetup.model, jspec, jparams, **kw)

    def audit(hot, sb, gidx, emb):
        # the levels have not moved since the batch staged: its embeddings
        # are the host oracle's rows of the live store, bit for bit
        want = tsrv.hier.gather_fp32_host(gidx.numpy())
        embs.append(np.array_equal(want.view(np.uint32),
                                   emb.numpy().view(np.uint32)))
    tres = tloop.serve_forward(tsrv, tsetup.model, tspec, tparams, **kw,
                               audit=audit)
    for key in STAT_KEYS:
        assert tres.stats[key] == jres.stats[key], key
    assert tres.stats["migrations"] == (0 if retier_async else 3)
    assert tres.stats["cold_hits"] and tres.stats["warm_hits"]
    if retier_async:
        assert tres.stats["shadow_builds"] >= 1
        jsrv.drain_shadow()
        tsrv.drain_shadow()
        assert tsrv.stats.swaps == jsrv.stats.swaps >= 1
    assert len(touts) == len(jouts) == 7
    for got, want in zip(touts, jouts):
        assert np.all(np.abs(got - want) <= TOL * np.maximum(1.0,
                                                             np.abs(want)))
    np.testing.assert_array_equal(
        np.asarray(jsrv.store.priority).view(np.uint32),
        tsrv.store.priority.numpy().view(np.uint32))
    np.testing.assert_array_equal(np.asarray(jsrv.cache.ids),
                                  tsrv.cache.ids.numpy())
    for f in ("level", "slot", "tiers"):
        np.testing.assert_array_equal(getattr(jsrv.hier, f),
                                      getattr(tsrv.hier, f))
    assert embs and all(embs)
    # at a re-tier boundary the levels serve what a fresh pack serves
    tsrv.retier()
    flat = tps.lookup(tps.pack(tsrv.store, tcfg),
                      torch.arange(tsrv.hier.vocab))
    got = hier_lookup(tsrv.hier, np.arange(tsrv.hier.vocab))
    assert torch.equal(got.view(torch.int32), flat.view(torch.int32))


def test_eager_lookup_through_the_backend_matches_jax(bench, tmp_path):
    (_, _, _, jstore, jcfg), (_, _, _, tstore, tcfg) = bench
    budget = tps.pack(tstore, tcfg).nbytes() // 8
    jsrv = JOnlineServer(jstore, jcfg, JOnlineConfig(cache_rows=32),
                         hier=JHierConfig(budget, budget,
                                          store_dir=str(tmp_path / "j")))
    tsrv = OnlineServer(tstore, tcfg, OnlineConfig(cache_rows=32),
                        hier=HierConfig(budget, budget,
                                        store_dir=str(tmp_path / "t")))
    assert np.array_equal(jsrv.cache_mask, tsrv.cache_mask)
    rng = np.random.default_rng(0)
    for _ in range(3):
        idx = rng.integers(0, tsrv.hier.vocab, (4, 10))
        valid = np.array([True, True, True, False])[:, None]
        want = np.asarray(jsrv.lookup(jax.numpy.asarray(idx), valid=valid,
                                      count=3))
        got = tsrv.lookup(torch.from_numpy(idx), valid=valid, count=3)
        np.testing.assert_array_equal(want.view(np.uint32),
                                      got.numpy().view(np.uint32))
    for key in ("requests", "lookups", "hits"):
        assert getattr(tsrv.stats, key) == getattr(jsrv.stats, key), key
    assert tsrv.hier.stats.as_dict() == jsrv.hier.stats.as_dict()
    assert tsrv.backend.occupancy() == jsrv.backend.occupancy()
    with pytest.raises(ValueError, match="fully resident"):
        tsrv.bag_matmul_fn()


def test_run_hier_sweep_matches_the_reference(tmp_path):
    kw = dict(fractions=(0.1, 0.5), requests=32, retier_every=16)
    jrec = jhier_bench.run_hier_sweep(**kw,
                                      store_dir=str(tmp_path / "j"))
    tparams = params_from_jax(jax.tree.map(
        np.asarray, jqps._bench_store(0.5)[2]))
    trec = thier_bench.run_hier_sweep(**kw, params=tparams, device="cpu")
    assert check_bench_schema.validate(jrec) == []
    assert check_bench_schema.validate(trec) == []
    for key, want in jrec.items():
        if key != "sweep":
            assert trec[key] == want, key
    for je, te in zip(jrec["sweep"], trec["sweep"]):
        for key in STAT_KEYS[1:] + ("hbm_budget_bytes",
                                    "hbm_budget_fraction"):
            if key in je:
                assert te[key] == je[key], (je["hbm_budget_fraction"], key)
    assert trec["sweep"][0]["hier_miss_rate"] > trec["sweep"][1][
        "hier_miss_rate"]
    assert trec["device"] == "cpu"


def _cli(argv: list[str]) -> tuple[dict, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve.main(argv)
    text = out.getvalue()
    return json.loads(text.strip().splitlines()[-1]), text


@pytest.mark.parametrize("arch,extra", [
    ("wide-deep", []),
    ("dlrm-rm2", ["--retier-async", "--verify-swap", "--shadow-rows",
                  "65536"])])
def test_serve_cli_hier_on_cpu(tmp_path, arch, extra):
    rec, text = _cli(["--arch", arch, "--online", "--serve-batch", "8",
                      "--store-backend", "hier", "--hbm-budget-mb", "0.5",
                      "--host-budget-mb", "0.5", "--store-dir",
                      str(tmp_path / "cold"), "--model", "smoke",
                      "--device", "cpu", "--verify-hier", "--requests", "24",
                      "--retier-every", "8"] + extra)
    assert "hier verify OK" in text
    assert rec["store_backend"] == "hier" and rec["hbm_budget_mb"] == 0.5
    assert rec["level_rows"]["cold_rows"] > 0
    assert rec["cold_hits"] > 0
    assert rec["device"] == "cpu" and rec["verify_s"] > 0
    if extra:
        # the loop opens builds; the drain swaps the last one in, verified
        assert rec["retier_async"] is True and rec["shadow_builds"] >= 1
        assert "swaps (bit-identity verified at every swap)" in text
        assert " 0 swaps" not in text
    else:
        assert rec["retiers"] == rec["migrations"] == 3
    # the reference's spelling: --hbm-budget-mb alone picks the hier store
    args = tserve.parse_args(["--online", "--serve-batch", "8",
                              "--hbm-budget-mb", "1"])
    assert args.store_backend == "hier"


@pytest.mark.parametrize("argv,match", [
    (["--online", "--hbm-budget-mb", "1"],
     "--hbm-budget-mb requires --online --serve-batch N"),
    (["--online", "--serve-batch", "8", "--verify-hier"],
     "--verify-hier requires --hbm-budget-mb"),
    (["--online", "--serve-batch", "8", "--hbm-budget-mb", "1",
      "--fuse-matmul"], "requires a fully resident store"),
    (["--online", "--serve-batch", "8", "--store-backend", "hier"],
     "needs --hbm-budget-mb"),
    (["--online", "--serve-batch", "8", "--store-backend", "hashed",
      "--verify-hier"], "--verify-hier requires --hbm-budget-mb")])
def test_serve_cli_hier_argument_errors(argv, match):
    err = io.StringIO()
    with pytest.raises(SystemExit), contextlib.redirect_stderr(err):
        tserve.parse_args(argv)
    assert match in err.getvalue()
