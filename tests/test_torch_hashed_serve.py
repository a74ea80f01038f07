"""The port's hashed store and its online serve against the JAX package,
on the CPU.

Same numpy inputs through both packages.  Bit for bit: the pool plan,
``quantize_pool`` on a converted pool, the backend's K = 1 lookups and
cache rows, its eager Eq. 7 fold, and the cache's ids after a fold (ties
to the lower id).  Within a tolerance: ``fit_pool_from_table`` (within
1e-5 x max|pool| of JAX's pool: the CG dot products reduce in another
order; 1.96e-7 x max|pool| at this size on the CPU) and each served
request's logits when both packages serve the same converted pool
(``|d| <= 1e-5 * max(1, |ref|)``: the MLP head's dots).  The serve CLIs
(``--online --store-backend hashed``, 32- and 8-bit pools) count the same
lookups, hits, re-tiers and pool.
"""

from __future__ import annotations

import contextlib
import io
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro import configs as jconfigs
from repro.core.priority import PriorityConfig as JPriorityConfig
from repro.launch import serve as jserve_cli
from repro.serve import loop as jloop
from repro.store import api as japi
from repro.store import hashed as jh
from repro_torch import kernels as tkernels
from repro_torch.convert import (hashed_config_from_jax, hashed_store_from_jax,
                                 params_from_jax)
from repro_torch.core.priority import PriorityConfig
from repro_torch.launch import serve as tserve
from repro_torch.serve import loop as tloop
from repro_torch.serve.online import OnlineConfig, OnlineServer
from repro_torch.store import api as tapi
from repro_torch.store import hashed as th

TOL = 1e-5


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    a = np.asarray(x)
    return a.view({1: np.uint8, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


@pytest.mark.parametrize("vocab,dim,z,ratio,pool_bits",
                         [(22_216_192, 32, 8, 100.0, 32),
                          (22_216_192, 32, 8, 100.0, 8),
                          (179_712, 8, 8, 100.0, 32), (1000, 16, 4, 3.0, 8),
                          (10, 4, 4, 1e12, 32)])
def test_plan_pool_slots_equal(vocab, dim, z, ratio, pool_bits):
    assert (th.plan_pool_slots(vocab, dim, z, ratio, pool_bits)
            == jh.plan_pool_slots(vocab, dim, z, ratio, pool_bits))
    cfg = th.HashedConfig(vocab=vocab, dim=dim, chunk_dim=z,
                          num_slots=th.plan_pool_slots(vocab, dim, z, ratio,
                                                       pool_bits),
                          pool_bits=pool_bits)
    jcfg = jh.HashedConfig(*cfg)
    assert cfg.pool_nbytes() == jcfg.pool_nbytes()
    assert cfg.compression_ratio() == jcfg.compression_ratio()


def test_full_width_wide_deep_plan():
    """The served configuration: 22,216,192 rows x 32 at ratio 100."""
    assert th.plan_pool_slots(22_216_192, 32, 8, 100.0) == 888_648
    assert th.plan_pool_slots(22_216_192, 32, 8, 100.0, 8) == 2_369_727
    with pytest.raises(ValueError, match="must divide"):
        th.HashedConfig(vocab=10, dim=10, chunk_dim=8).num_chunks


def test_init_hashed_draws_the_reference_distribution():
    """Same shapes, unit scales, zero priorities and the 0.05/sqrt(NH)
    spread; the numbers are torch's, not ``jax.random``'s."""
    cfg = th.HashedConfig(vocab=500, dim=16, chunk_dim=4, num_slots=20_000)
    hs = th.init_hashed(cfg)
    jhs = jh.init_hashed(jh.HashedConfig(*cfg))
    assert tuple(hs.pool.shape) == np.asarray(jhs.pool).shape
    np.testing.assert_array_equal(hs.pool_scale.numpy(), 1.0)
    np.testing.assert_array_equal(hs.priority.numpy(), np.zeros(500))
    want = 0.05 / np.sqrt(2)
    assert abs(float(hs.pool.std()) - want) < 0.02 * want
    assert abs(float(np.asarray(jhs.pool).std()) - want) < 0.02 * want
    again = th.init_hashed(cfg)
    np.testing.assert_array_equal(bits(hs.pool), bits(again.pool))


@pytest.fixture(scope="module")
def fitted():
    """JAX's and the port's fits of one 20,000 x 16 table (Z = 4)."""
    rng = np.random.default_rng(0)
    v, d = 20_000, 16
    table = (rng.standard_normal((v, d)) * 0.05).astype(np.float32)
    pri = (rng.pareto(1.2, v) * 10).astype(np.float32)
    jcfg = jh.HashedConfig(vocab=v, dim=d, chunk_dim=4,
                           num_slots=jh.plan_pool_slots(v, d, 4, 10.0),
                           seed=5)
    jhs = jh.fit_pool_from_table(jnp.asarray(table), jcfg,
                                 priority=jnp.asarray(pri))
    tcfg = hashed_config_from_jax(jcfg)
    ths = th.fit_pool_from_table(torch.from_numpy(table), tcfg,
                                 priority=torch.from_numpy(pri))
    return table, pri, jcfg, jhs, tcfg, ths


def test_fit_pool_within_tolerance_of_jax(fitted):
    table, pri, jcfg, jhs, tcfg, ths = fitted
    want = np.asarray(jhs.pool)
    got = ths.pool.numpy()
    assert got.shape == want.shape == (tcfg.num_slots, 4)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 1e-5 * scale
    np.testing.assert_array_equal(ths.pool_scale.numpy(), 1.0)
    np.testing.assert_array_equal(bits(ths.priority), bits(pri))
    # the fit's materialisation (fwd) equals the reference's at K = 1:
    # both pools read back through the kernel path bit for bit
    ids = torch.arange(table.shape[0], dtype=torch.int32)
    conv = th.HashedStore(torch.from_numpy(want.copy()),
                          torch.ones(tcfg.num_slots), torch.zeros(0))
    rows = th.hashed_lookup(conv, tcfg, ids)
    jrows = jh.hashed_lookup(jhs, jcfg, jnp.arange(table.shape[0]),
                             use_pallas=False)
    np.testing.assert_array_equal(bits(jrows), bits(rows))
    # and CG improves on its scatter-mean seed (a random table cannot be
    # compressed 10x: most of it is the hashing scheme's own loss)
    seed = th.fit_pool_from_table(torch.from_numpy(table), tcfg, cg_iters=0)

    def residual(hs):
        fit = th.hashed_lookup(hs, tcfg, ids).numpy()
        return np.linalg.norm(fit - table) / np.linalg.norm(table)
    assert residual(ths) < residual(seed) < 1.0


def test_quantize_pool_bit_equal_on_a_converted_pool(fitted):
    _, _, jcfg, jhs, tcfg, _ = fitted
    tkernels.reset_launches()
    tq = th.quantize_pool(hashed_store_from_jax(jax.tree.map(np.asarray,
                                                             jhs)))
    jq = jh.quantize_pool(jhs)
    assert tq.pool.dtype == torch.int8 and tq.pool_scale.shape == (
        tcfg.num_slots,)
    np.testing.assert_array_equal(bits(jq.pool), bits(tq.pool))
    np.testing.assert_array_equal(bits(jq.pool_scale), bits(tq.pool_scale))
    assert tq.nbytes() == jq.nbytes()
    np.testing.assert_array_equal(bits(jh.pool_f32(jq)),
                                  bits(th.pool_f32(tq)))
    assert tkernels.launch_counts()["quantize_rowwise"] == 0


@pytest.fixture(scope="module", params=[32, 8])
def backends(request, fitted):
    """The JAX backend and the port's, serving the same converted pool."""
    _, _, jcfg, jhs, tcfg, _ = fitted
    if request.param == 8:
        jhs = jh.quantize_pool(jhs)
        jcfg = jcfg._replace(pool_bits=8)
        tcfg = tcfg._replace(pool_bits=8)
    jb = japi.build("hashed", jhs, jcfg)
    tb = tapi.build("hashed", hashed_store_from_jax(
        jax.tree.map(np.asarray, jhs)), tcfg)
    return jb, tb


def test_backend_lookup_bag_and_empty_bags(backends):
    jb, tb = backends
    rng = np.random.default_rng(1)
    idx = rng.integers(0, jb.vocab, (64, 5)).astype(np.int32)
    got = tb.lookup(torch.from_numpy(idx))
    assert got.shape == (64, 5, tb.dim)
    np.testing.assert_array_equal(bits(jb.lookup(idx)), bits(got))
    flat = torch.from_numpy(idx.reshape(-1, 1))
    np.testing.assert_array_equal(bits(tb.bag_lookup(flat)),
                                  bits(got.reshape(-1, tb.dim)))
    zero = tb.bag_lookup(torch.from_numpy(idx), torch.zeros((64, 5)))
    np.testing.assert_array_equal(bits(zero),
                                  np.zeros((64, tb.dim), np.uint32))
    assert tb.nbytes() == jb.nbytes() and tb.kind == jb.kind == "hashed"
    assert tb.retier() == jb.retier() == {"rows_moved": 0, "changed": False}
    with pytest.raises(ValueError, match="fused"):
        tb.bag_matmul_fn()
    # the mesh runs now (tests/test_torch_dist_hashed.py); what it still
    # refuses is a mesh that is not a repro_torch.dist.Mesh
    with pytest.raises(TypeError, match="Mesh"):
        tapi.HashedBackend(tb.hs, tb.hcfg, mesh=object())


def test_backend_fold_and_cache_ties_match_jax(backends):
    jb, tb = backends
    rng = np.random.default_rng(2)
    jb.hs = jb.hs._replace(priority=jnp.zeros((jb.vocab,), jnp.float32))
    tb.hs = tb.hs._replace(priority=torch.zeros(tb.vocab))
    idx = rng.integers(0, 700, (256, 6)).astype(np.int32)
    jb.fold_priority(jnp.asarray(idx), JPriorityConfig())
    tb.fold_priority(torch.from_numpy(idx), PriorityConfig())
    np.testing.assert_array_equal(bits(jb.priority), bits(tb.hs.priority))
    jc, _ = jb.build_cache(100)
    tc = tb.build_cache(100)
    # most folded scores tie (counts x 0.99): both take the lower ids
    assert len(np.unique(np.asarray(jb.priority)[np.asarray(jc.ids)])) < 100
    np.testing.assert_array_equal(np.asarray(jc.ids), tc.ids.numpy())
    np.testing.assert_array_equal(bits(jc.rows), bits(tc.rows))
    np.testing.assert_array_equal(np.asarray(jc.slot_of), tc.slot_of.numpy())
    assert tb.build_cache(0).capacity == 0


def test_backend_manifest_round_trips(backends):
    jb, tb = backends
    tree = tb.snapshot_manifest()
    assert tree["kind"] == "hashed_store/v1"
    back = tapi.from_manifest(tree)
    assert isinstance(back, tapi.HashedBackend) and back.hcfg == tb.hcfg
    for f in th.HashedStore._fields:
        np.testing.assert_array_equal(bits(getattr(tb.hs, f)),
                                      bits(getattr(back.hs, f)))
    # the reference's manifest, brought to numpy, rebuilds the same store
    jtree = jax.tree.map(np.asarray, jb.snapshot_manifest())
    from_j = tapi.from_manifest(jtree)
    assert from_j.hcfg == tb.hcfg
    for f in th.HashedStore._fields:
        np.testing.assert_array_equal(bits(getattr(jb.hs, f)),
                                      bits(getattr(from_j.hs, f)))
    with pytest.raises(ValueError, match="no backend"):
        tapi.from_manifest({"kind": "nope/v1"})
    with pytest.raises(ValueError, match="unknown store backend"):
        tapi.build("tiered")
    assert tapi.backend_names() == ("hashed", "hier", "packed")


# -- the online serve --------------------------------------------------------

def _reference_cli(argv: list[str]):
    """Run ``python -m repro.launch.serve`` in-process; return its record,
    each request's logits and its server."""
    outs, seen = [], {}
    run_loop = jloop.run_loop

    def spy(server, serve_fn, make_batch, requests, batch):
        seen["server"] = server

        def recorded(idx):
            out = serve_fn(idx)
            outs.append(np.asarray(out))
            return out
        return run_loop(server, recorded, make_batch, requests, batch)

    buf = io.StringIO()
    old_argv = sys.argv
    jloop.run_loop = spy
    sys.argv = ["serve", *argv]
    try:
        with contextlib.redirect_stdout(buf):
            jserve_cli.main()
    finally:
        jloop.run_loop = run_loop
        sys.argv = old_argv
    return (json.loads(buf.getvalue().strip().splitlines()[-1]), outs,
            seen["server"])


@pytest.mark.parametrize("hash_bits", ["32", "8"])
def test_hashed_serve_cli_matches_reference(hash_bits):
    requests, batch = 6, 64
    argv = ["--arch", "wide-deep", "--online", "--store-backend", "hashed",
            "--requests", str(requests), "--batch", str(batch),
            "--hash-bits", hash_bits]
    jrec, jouts, jserver = _reference_cli(argv)

    out = io.StringIO()
    tkernels.reset_launches()
    with contextlib.redirect_stdout(out):
        tserve.main([*argv, "--model", "smoke", "--device", "cpu"])
    rec = json.loads(out.getvalue().strip().splitlines()[-1])
    assert tkernels.launch_counts() == dict.fromkeys(
        tkernels.launch_counts(), 0)
    for key in ("requests", "lookups", "hits", "retiers", "rows_moved",
                "pool_slots", "hash_bits", "hash_ratio", "packed_mib",
                "packed_fp32_ratio", "store_backend", "cache_rows"):
        assert rec[key] == jrec[key], key
    assert rec["hits"] > 0 and rec["retiers"] == 3 and rec["rows_moved"] == 0
    assert rec["fit_s"] > 0 and rec["device"] == "cpu"

    # the same converted pool through the port's server and loop
    jb = jserver.backend
    spec = tserve.configs.get("wide-deep").smoke_model.spec
    pri, _ = tserve.plan_store(spec, torch.device("cpu"))
    hs = hashed_store_from_jax(jax.tree.map(np.asarray, jb.hs))._replace(
        priority=pri)
    server = OnlineServer(online=OnlineConfig(cache_rows=256,
                                              retier_every=2),
                          backend=tapi.build("hashed", hs,
                                             hashed_config_from_jax(jb.hcfg)))
    model = tserve.configs.get("wide-deep").smoke_model
    jparams = jconfigs.get("wide-deep").smoke_model.init(
        jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    params.pop("embed_table")
    outs, embs = [], []

    def audit(r, idx):
        def after(out, emb):
            outs.append(out)
            embs.append(emb)
        return after

    res = tloop.serve_forward_loop(server, model, spec, params, batch=batch,
                                   requests=requests, audit=audit)
    assert len(outs) == len(jouts) == requests
    # the loop hands each request's served embeddings to the audit
    assert all(e.shape == (batch, spec.num_fields, spec.dim) for e in embs)
    for want, got in zip(jouts, outs):
        want = np.asarray(want, np.float64)
        got = got.numpy().astype(np.float64)
        assert np.all(np.abs(got - want) <= TOL * np.maximum(1.0,
                                                             np.abs(want)))
    for key in ("requests", "lookups", "hits", "retiers", "rows_moved"):
        assert res.stats[key] == jrec[key], key
    np.testing.assert_array_equal(bits(jb.hs.priority),
                                  bits(server.backend.hs.priority))
    np.testing.assert_array_equal(np.asarray(jserver.cache.ids),
                                  server.cache.ids.numpy())


@pytest.mark.parametrize("argv,match", [
    (["--store-backend", "hashed"], "requires --online"),
    (["--store-backend", "hashed", "--online", "--fuse-matmul"],
     "no fused bag->matmul"),
    (["--store-backend", "hashed", "--online", "--hash-bits", "16"],
     "invalid choice"),
    (["--store-backend", "hier", "--online"], "needs --hbm-budget-mb"),
    (["--store-backend", "hashed", "--online", "--serve-batch", "8",
      "--hbm-budget-mb", "1"], "incompatible with --hbm-budget-mb")])
def test_cli_argument_errors(argv, match):
    err = io.StringIO()
    with pytest.raises(SystemExit), contextlib.redirect_stderr(err):
        tserve.parse_args(argv)
    assert match in err.getvalue()


def test_chunk_dim_must_divide_the_dim():
    """xDeepFM's smoke dim is 6: the default chunk width 8 is an error,
    as in the reference."""
    with pytest.raises(ValueError, match="must divide"):
        tserve.run(tserve.parse_args(
            ["--arch", "xdeepfm", "--online", "--store-backend", "hashed",
             "--model", "smoke", "--device", "cpu", "--requests", "1",
             "--batch", "4"]))


def test_hashed_serve_raises_without_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("the no-GPU rule is checked where there is no GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.run(tserve.parse_args(
            ["--arch", "wide-deep", "--online", "--store-backend", "hashed",
             "--model", "smoke", "--requests", "1"]))
