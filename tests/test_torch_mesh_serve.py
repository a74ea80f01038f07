"""The port's serving paths under a mesh (``OnlineServer(mesh=)``, the shadow
re-tier, ``build_hier(mesh=)``, ``launch.serve --mesh``, the pipeline's
``--mesh``, ``benchmarks.qps_sharded``) against the JAX package on a
4-device host mesh, on the CPU.

The reference runs once, in one subprocess for this file
(``torch_mesh_jax``): an online server's requests with synchronous
re-tiers (unshard, ``repack_delta``, reshard), a shadow re-tier on an
explicit begin / drain schedule, the hier store built and migrated under
the mesh, and its serve CLI with ``--online --mesh 4``.  The port runs
the same at mesh 4 in process, every shard a row view on the CPU.  Bit
for bit: every served embedding (each row comes from one shard), the rows
moved, the re-tiered pack's leaves, the hier levels (four shards on the
port's one device are charged as the reference's one unsharded device,
so its levels are the reference's single-device ones) and lookups, and
the CLI record's
counters.  The pipeline at mesh 2 gives its mesh-1 record's losses,
tiers and verify flags; ``qps_sharded``'s records pass the schema tool.
"""

from __future__ import annotations

import contextlib
import io as _io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_jax
import torch_threads

from repro.core import qat_store as jqs
from repro.core.tiers import TierConfig as JTierConfig
from repro_torch.convert import qat_store_from_jax
from repro_torch.core import packed_store as tps
from repro_torch.core import qat_store as tqs
from repro_torch.core.tiers import TierConfig
from repro_torch.dist import make_mesh
from repro_torch.dist.packed import ShardedPack
from repro_torch.launch import pipeline as tpipe
from repro_torch.launch import serve as tserve
from repro_torch.serve.online import OnlineConfig, OnlineServer
from repro_torch.store import hier as thier

V, D = 160, 24
JCFG = jqs.FQuantConfig(tiers=JTierConfig(t8=5.0, t16=50.0),
                        stochastic=False)
TCFG = tqs.FQuantConfig(tiers=TierConfig(t8=5.0, t16=50.0), stochastic=False)
CLI = ["--online", "--mesh", "4", "--requests", "4"]


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    st = jqs.init(jax.random.PRNGKey(0), V, D, scale=0.05)
    st = st._replace(priority=jnp.asarray(
        (rng.pareto(1.2, V) * 20).astype(np.float32)))
    st = st._replace(table=jqs.snap(st.table, jqs.current_tiers(st, JCFG),
                                    JCFG))
    pri2 = np.asarray(st.priority).copy()
    pri2[rng.choice(V, 12, replace=False)] = 1e6     # promote to fp32
    return {"table": np.asarray(st.table), "pri": np.asarray(st.priority),
            "pri2": pri2,
            "req": rng.integers(0, V, (3, 8, 4)).astype(np.int32),
            "probe": rng.integers(0, V, (9, 5)).astype(np.int32)}


JAX_MESH4 = """
import contextlib, io, json, tempfile
from repro.core import FQuantConfig, pack
from repro.core import packed_store as ps
from repro.core import qat_store as qs
from repro.core.tiers import TierConfig
from repro.serve import OnlineConfig, OnlineServer
from repro.store import HierConfig, build_hier, hier_lookup

CFG = FQuantConfig(tiers=TierConfig(t8=5.0, t16=50.0), stochastic=False)
mesh = jax.make_mesh((4,), ("model",))
st = qs.QATStore(jnp.asarray(inp["table"]), jnp.asarray(inp["pri"]))

def leaves(prefix, packed):
    host = jax.device_get(packed)
    save(**{f"{prefix}_{f}": (np.asarray(getattr(host, f)).view(np.uint16)
                              if f == "payload16" else getattr(host, f))
            for f in ps.PackedStore._fields})

srv = OnlineServer(st, CFG, OnlineConfig(cache_rows=16, retier_every=2),
                   mesh=mesh)
for r, bidx in enumerate(inp["req"]):
    save(**{f"emb{r}": srv.lookup(jnp.asarray(bidx))})
save(stats=np.array([srv.stats.requests, srv.stats.lookups, srv.stats.hits,
                     srv.stats.retiers, srv.stats.rows_moved]))
leaves("sync", srv.host_packed)

shadow = OnlineServer(st, CFG, OnlineConfig(cache_rows=16, retier_async=True,
                                            shadow_rows_per_step=8),
                      mesh=mesh)
for bidx in inp["req"][:2]:
    shadow.observe(jnp.asarray(bidx))
assert shadow.begin_retier()
shadow.drain_shadow()
save(shadow_stats=np.array([shadow.stats.swaps, shadow.stats.rows_moved]),
     shadow_emb=shadow.lookup(jnp.asarray(inp["req"][2])))
leaves("shadow", shadow.host_packed)

b = pack(st, CFG).nbytes() // 16
hier = build_hier(st, CFG, HierConfig(
    hbm_budget_bytes=b, host_budget_bytes=b, rows_per_shard=16,
    store_dir=tempfile.mkdtemp()), mesh=mesh)
save(hot_ids=hier.hot_ids, warm_ids=hier.warm_ids, cold_ids=hier.cold_ids,
     hier_probe=hier_lookup(hier, jnp.asarray(inp["probe"])))
moved = hier.migrate(st._replace(priority=jnp.asarray(inp["pri2"])), CFG)
save(hier_moved=np.array([moved["promoted"], moved["demoted"],
                          moved["crossed"]]),
     hot_ids2=hier.hot_ids, hier_all=hier_lookup(hier, jnp.arange(160)))
one = build_hier(st, CFG, HierConfig(
    hbm_budget_bytes=b, host_budget_bytes=b, rows_per_shard=16,
    store_dir=tempfile.mkdtemp()))
save(one_hot_ids=one.hot_ids, one_warm_ids=one.warm_ids,
     one_cold_ids=one.cold_ids)
moved = one.migrate(st._replace(priority=jnp.asarray(inp["pri2"])), CFG)
save(one_moved=np.array([moved["promoted"], moved["demoted"],
                         moved["crossed"]]), one_hot_ids2=one.hot_ids)

from repro.launch import serve as cli
out = io.StringIO()
sys.argv = ["serve", *%r]
with contextlib.redirect_stdout(out):
    cli.main()
save(cli=np.array(out.getvalue().strip().splitlines()[-1]))
""" % (CLI,)


@pytest.fixture(scope="module")
def io(tmp_path_factory):
    inp = _inputs()
    return inp, torch_mesh_jax.run(JAX_MESH4, inp,
                                   str(tmp_path_factory.mktemp("smesh4")))


def _tstore(inp, pri="pri") -> tqs.QATStore:
    return tqs.QATStore(torch.from_numpy(np.array(inp["table"])),
                        torch.from_numpy(np.array(inp[pri])))


def _assert_leaves(out, prefix, packed):
    for f in tps.PackedStore._fields:
        np.testing.assert_array_equal(bits(getattr(packed, f)),
                                      bits(out[f"{prefix}_{f}"]))


def test_online_server_mesh4_retiers_as_jax(io):
    """Three requests, a synchronous re-tier after the second: each served
    embedding,
    the counters and the re-tiered pack equal the reference's at mesh 4,
    and the port's own unsharded server's."""
    inp, out = io
    servers = {n: OnlineServer(
        _tstore(inp), TCFG, OnlineConfig(cache_rows=16, retier_every=2),
        mesh=None if n == 1 else make_mesh(n, device="cpu")) for n in (1, 4)}
    srv = servers[4]
    assert isinstance(srv.packed, ShardedPack) and srv.mesh.size == 4
    for r, bidx in enumerate(inp["req"]):
        ids = torch.from_numpy(bidx)
        got = srv.lookup(ids)
        np.testing.assert_array_equal(bits(got), bits(out[f"emb{r}"]))
        np.testing.assert_array_equal(bits(got),
                                      bits(servers[1].lookup(ids)))
        # the served store is the pack of record's row views
        assert srv.packed.base is srv.host_packed
    st = srv.stats
    assert [st.requests, st.lookups, st.hits, st.retiers,
            st.rows_moved] == out["stats"].tolist()
    assert st.rows_moved > 0 and st.retiers == 1
    _assert_leaves(out, "sync", srv.host_packed)
    np.testing.assert_array_equal(
        bits(tps.unpack(srv.host_packed)),
        bits(tps.unpack(tps.pack(srv.store, TCFG))))


def test_shadow_retier_mesh4_swaps_as_jax(io):
    """Two folds, then an explicit shadow build drained to its swap: the
    rows moved, the swapped pack's leaves and the next request's
    embeddings equal the reference's at mesh 4; the swapped store is
    served row-sharded."""
    inp, out = io
    srv = OnlineServer(_tstore(inp), TCFG,
                       OnlineConfig(cache_rows=16, retier_async=True,
                                    shadow_rows_per_step=8),
                       mesh=make_mesh(4, device="cpu"))
    for bidx in inp["req"][:2]:
        srv.observe(torch.from_numpy(bidx))
    assert srv.begin_retier()
    srv.drain_shadow()
    assert [srv.stats.swaps, srv.stats.rows_moved] == out[
        "shadow_stats"].tolist()
    assert isinstance(srv.packed, ShardedPack)
    _assert_leaves(out, "shadow", srv.host_packed)
    np.testing.assert_array_equal(
        bits(srv.lookup(torch.from_numpy(inp["req"][2]))),
        bits(out["shadow_emb"]))


def test_build_hier_mesh4_matches_jax(io, tmp_path):
    """Four shards on one device hold the whole hot level once, so the
    planner charges the device as the reference charges one unsharded
    device: the levels and a migration equal the reference's single-device
    store at the same budget, and the device holds no more than it.  The
    hot level is served through its row shards; every lookup equals the
    reference's mesh-4 store bit for bit."""
    inp, out = io
    st = _tstore(inp)
    b = tps.pack(st, TCFG).nbytes() // 16
    hier = thier.build_hier(st, TCFG, thier.HierConfig(
        b, b, 16, str(tmp_path / "cold")), mesh=make_mesh(4, device="cpu"))
    assert hier.n_shards == 1
    for f in ("hot_ids", "warm_ids", "cold_ids"):
        np.testing.assert_array_equal(getattr(hier, f), out[f"one_{f}"])
    assert hier.hot_ids.size < out["hot_ids"].size  # the reference: b a device
    assert hier.served.nbytes() <= b
    assert isinstance(hier.served, ShardedPack)
    assert hier.served.base is hier.hot_dev
    np.testing.assert_array_equal(
        bits(thier.hier_lookup(hier, inp["probe"])), bits(out["hier_probe"]))
    moved = hier.migrate(_tstore(inp, "pri2"), TCFG)
    assert [moved["promoted"], moved["demoted"], moved["crossed"]] == out[
        "one_moved"].tolist()
    np.testing.assert_array_equal(hier.hot_ids, out["one_hot_ids2"])
    assert hier.served.base is hier.hot_dev     # re-sharded at the commit
    np.testing.assert_array_equal(
        bits(thier.hier_lookup(hier, np.arange(V))), bits(out["hier_all"]))


def _cli(argv) -> tuple[dict, object]:
    out = _io.StringIO()
    with contextlib.redirect_stdout(out):
        served = tserve.run(tserve.parse_args(argv))
    return served.record, served


def test_serve_cli_mesh4_beside_the_reference_cli(io):
    """``launch.serve --online --mesh 4 --model smoke --device cpu``: the
    record's counters equal the reference CLI's with the same arguments
    (its model is the smoke one); offline, mesh 4 serves the mesh-1
    logits bit for bit."""
    _, out = io
    want = json.loads(str(out["cli"]))
    rec, _ = _cli([*CLI, "--model", "smoke", "--device", "cpu"])
    for k in ("mesh", "requests", "lookups", "hits", "cache_hit_rate",
              "retiers", "rows_moved", "packed_mib", "packed_fp32_ratio"):
        assert rec[k] == want[k], k
    assert rec["mesh"] == 4
    logits = {}
    for n in (1, 4):
        rec, served = _cli(["--model", "smoke", "--device", "cpu",
                            "--requests", "2", "--mesh", str(n)])
        assert rec["mesh"] == n
        batch = served.make_request(0)
        logits[n] = tserve.serve_request(served.model, served.params,
                                         served.packed, batch)
    assert isinstance(served.packed, ShardedPack)
    np.testing.assert_array_equal(bits(logits[4]), bits(logits[1]))
    with pytest.raises(SystemExit):
        tserve.parse_args(["--mesh", "0"])


@pytest.mark.parametrize("backend", ["packed", "hashed"])
def test_pipeline_mesh2_gives_the_mesh1_record(tmp_path, backend):
    """``launch.pipeline --mesh 2 --fast`` (smoke size, the CPU) runs to
    the end with every verify flag true; the packed branch's losses,
    tiers, bytes and served counters equal the mesh-1 run's (the sharded
    step is the unsharded one bit for bit)."""
    recs = {}
    for n in ((1, 2) if backend == "packed" else (2,)):
        out = _io.StringIO()
        with contextlib.redirect_stdout(out):
            recs[n] = tpipe.main([
                "--model", "smoke", "--device", "cpu", "--fast", "--mesh",
                str(n), "--store-backend", backend, "--steps", "6",
                "--serve-requests", "16",
                "--ckpt-dir", str(tmp_path / f"m{n}")])
    assert recs[2]["mesh"] == 2 and not tpipe.verify_failures(recs[2])
    if backend == "packed":
        for k in ("train_losses", "finetune_losses", "tier_rows_int8",
                  "tier_rows_half", "tier_rows_fp32", "bytes_packed",
                  "eval_loss_packed", "retiers", "cache_hit_rate"):
            assert recs[2][k] == recs[1][k], k


def test_qps_sharded_records_pass_the_schema_tool(tmp_path):
    """``benchmarks.qps_sharded`` at a tiny size: one schema-valid
    ``bench_qps/v1`` record a mesh (the unchanged tool, in a subprocess),
    with the mesh size and the same traffic counters at every mesh."""
    from repro_torch.benchmarks import qps_sharded
    with contextlib.redirect_stdout(_io.StringIO()):
        recs = qps_sharded.main(["--meshes", "1,4", "--requests", "16",
                                 "--serve-batches", "1,8", "--device", "cpu",
                                 "--emit-dir", str(tmp_path)])
    paths = sorted(str(p) for p in tmp_path.glob("BENCH_qps_mesh*.json"))
    assert [os.path.basename(p) for p in paths] == [
        "BENCH_qps_mesh1.json", "BENCH_qps_mesh4.json"]
    r = subprocess.run([sys.executable, "tools/check_bench_schema.py",
                        *paths], capture_output=True, text=True,
                       cwd=torch_mesh_jax.ROOT,
                       env=torch_threads.subprocess_env())
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("valid bench_qps/v1") == 2
    for n, rec in recs.items():
        assert rec["mesh"] == n
        assert rec["benchmark"] == "qps_online_microbatch_sharded"
    for a, b in zip(recs[1]["sweep"], recs[4]["sweep"]):
        for k in ("serve_batch", "lookups", "hits", "retiers", "rows_moved"):
            assert a[k] == b[k], k
