"""The port's hierarchical store against the JAX package, on the CPU.

At the reference tests' size (V = 160, D = 24, 16 rows a cold shard,
``tests/test_hier_store.py``) and from the same state (the reference's
store carried across by ``convert.py``): the budget plan and
``hot_shard_bytes`` equal (ties, empty tiers, no host budget, shards);
``np_lookup`` bit-equal to the reference's and to the port's plain
``lookup``; cold shards written by either package open in the other, with
the same manifest and leaves, ``gather_fp32`` and ``extract`` bit-equal,
and an aborted generation leaves the live one readable; ``build_hier``
gives the reference's levels, slots, ids, bytes and leaves; the
three-level lookups equal the flat one; ``_stage`` resolves, dedups and
counts as the reference does; ``migrate`` after the same priority moves
gives the reference's counts and levels and stays bit-identical to a
fresh ``pack``; ``ShadowMigrate`` in chunks lands on the synchronous
migration (a cold rewrite included) in the reference's number of steps,
and a discard before the swap leaves the live store as it was.
Tolerance 0 everywhere (bits).
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro.core import packed_store as jps
from repro.core import qat_store as jqs
from repro.core.tiers import TierConfig
from repro.core.tiers import assign_tiers as jassign
from repro.serve.shadow import ShadowMigrate as JShadowMigrate
from repro.store import budget as jbudget
from repro.store import hier as jhier
from repro.store import manifest as jman
from repro_torch.convert import (hier_store_from_jax, packed_from_jax,
                                 qat_store_from_jax)
from repro_torch.core import packed_store as tps
from repro_torch.core import qat_store as tqs
from repro_torch.serve.shadow import ShadowMigrate
from repro_torch.store import budget as tbudget
from repro_torch.store import hier as thier
from repro_torch.store import manifest as tman
from repro_torch.store.api import HierBackend

V, D = 160, 24
TIERS = TierConfig(t8=5.0, t16=50.0)
JCFG = jqs.FQuantConfig(tiers=TIERS, stochastic=False)
TCFG = tqs.FQuantConfig(tiers=TIERS, stochastic=False)
ROWS = 16                     # rows a cold shard, as the reference tests


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.view(torch.int16)
        x = x.detach().cpu().numpy()
    a = np.asarray(x)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.dtype.itemsize])


def assert_leaves_equal(want, got) -> None:
    for name in jps.PackedStore._fields:
        w, g = getattr(want, name), getattr(got, name)
        assert tuple(np.shape(w)) == tuple(g.shape), name
        np.testing.assert_array_equal(bits(w), bits(g), err_msg=name)


def _jstore(seed=0, cfg=JCFG):
    """The reference tests' store: pareto priorities, snapped table."""
    rng = np.random.default_rng(seed)
    st = jqs.init(jax.random.PRNGKey(seed), V, D, scale=0.05)
    st = st._replace(priority=jnp.asarray(
        (rng.pareto(1.2, V) * 20).astype(np.float32)))
    return st._replace(table=jqs.snap(st.table, jqs.current_tiers(st, cfg),
                                      cfg))


def _tstore(jst) -> tqs.QATStore:
    return qat_store_from_jax(jax.tree.map(np.asarray, jst))


def _host(packed) -> jps.PackedStore:
    return jps.PackedStore(*(np.asarray(x) for x in packed))


def _budget(jst, frac) -> int:
    return jps.pack(jst, JCFG).nbytes() // frac


def _pair(tmp_path, seed=0, frac=8, host=True, jst=None):
    """The reference's and the port's ``build_hier`` from one state, each
    with a cold dir of its own."""
    jst = _jstore(seed) if jst is None else jst
    b = _budget(jst, frac)
    hb = b if host else None
    jh = jhier.build_hier(jst, JCFG, jhier.HierConfig(
        b, hb, ROWS, str(tmp_path / "jcold")))
    th = thier.build_hier(_tstore(jst), TCFG, thier.HierConfig(
        b, hb, ROWS, str(tmp_path / "tcold")))
    return jst, jh, th


def assert_hier_equal(jh, th) -> None:
    for f in ("level", "slot", "tiers", "hot_ids", "warm_ids", "cold_ids"):
        np.testing.assert_array_equal(getattr(jh, f), getattr(th, f),
                                      err_msg=f)
    assert jh.nbytes() == th.nbytes()
    assert jh.counts() == th.counts()
    assert_leaves_equal(_host(jh.hot_host), th.hot_dev)
    assert_leaves_equal(_host(jh.warm), th.warm)
    assert (jh.cold is None) == (th.cold is None)
    if jh.cold is not None:
        assert_cold_equal(jh.cold, th.cold)


def assert_cold_equal(jc, tc) -> None:
    """Two open cold generations: the same manifest, row ids and shard
    leaves."""
    assert jc.manifest == tc.manifest
    np.testing.assert_array_equal(jc.row_ids, tc.row_ids)
    for js, ts in zip(jc._shards, tc._shards):
        assert_leaves_equal(js, ts)


def _flat_rows(jst) -> np.ndarray:
    """Every row of a fresh pack of the port's store, the plain lookup."""
    tst = _tstore(jst)
    return tps.lookup(tps.pack(tst, TCFG), torch.arange(V)).numpy()


# ------------------------------------------------------------ the planner

def _plan_case(name):
    rng = np.random.default_rng(3)
    pri = (rng.pareto(1.2, V) * 20).astype(np.float32)
    if name == "ties":
        pri = rng.integers(0, 4, V).astype(np.float32) * 10.0
    elif name == "zeros":
        pri = np.zeros(V, np.float32)
    tiers = np.asarray(jassign(jnp.asarray(pri), TIERS)).astype(np.int8)
    total = int(jbudget.row_bytes(tiers, D).sum())
    hbm, host, shards = total // 8, total // 8, 1
    if name == "no_host":
        host = None
    elif name == "tiny":
        hbm, host = 1, 0
    elif name == "all_hot":
        hbm = 10 * total
    elif name == "shards":
        shards = 4
    return pri, tiers, hbm, host, shards


@pytest.mark.parametrize("name", ["pareto", "ties", "zeros", "no_host",
                                  "tiny", "all_hot", "shards"])
def test_plan_placement_equals_reference(name):
    pri, tiers, hbm, host, shards = _plan_case(name)
    want = jbudget.plan_placement(pri, tiers, D, hbm, host, shards)
    for got in (tbudget.plan_placement(pri, tiers, D, hbm, host, shards),
                tbudget.plan_placement(torch.from_numpy(pri),
                                       torch.from_numpy(tiers), D, hbm,
                                       host, shards)):
        for f in ("level", "hot_ids", "warm_ids", "cold_ids"):
            w, g = getattr(want, f), getattr(got, f)
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(w, g, err_msg=f)
        for f in ("hot_bytes", "warm_bytes", "cold_bytes"):
            assert getattr(got, f) == getattr(want, f), f
    order = np.argsort(-pri.astype(np.float64), kind="stable")
    for n in (1, 7, V // 2, V):
        for s in (1, 2, 4):
            assert (tbudget.hot_shard_bytes(tiers, D, n, s, order)
                    == jbudget.hot_shard_bytes(tiers, D, n, s, order))
            assert (tbudget.hot_shard_bytes(tiers, D, n, s)
                    == jbudget.hot_shard_bytes(tiers, D, n, s))


# ------------------------------------------------------ host lookup, shards

@pytest.mark.parametrize("strict", [False, True])
def test_np_lookup_bit_equal_to_reference_and_plain_lookup(strict):
    jcfg = JCFG._replace(strict_fp16=strict)
    jst = _jstore(1, jcfg)
    host = _host(jps.pack(jst, jcfg))
    tp = packed_from_jax(host)
    ids = np.random.default_rng(0).integers(0, V, 300)
    want = jman.np_lookup(host, ids)
    got = tman.np_lookup(tp, ids)
    np.testing.assert_array_equal(bits(want), bits(got))
    np.testing.assert_array_equal(bits(tps.lookup(tp, torch.from_numpy(ids))),
                                  bits(got))
    assert tman.np_lookup(tp, np.zeros(0, np.int64)).shape == (0, D)


@pytest.mark.parametrize("strict", [False, True])
def test_cold_shards_open_in_either_package(tmp_path, strict):
    """The port's writer and the reference's give the same files: each
    opens the other's with the same manifest, row ids and leaves, and the
    two readers' ``gather_fp32`` and ``extract`` agree bit for bit."""
    jcfg = JCFG._replace(strict_fp16=strict)
    host = _host(jps.pack(_jstore(2, jcfg), jcfg))
    row_ids = np.sort(np.random.default_rng(1).choice(V, 100, replace=False))
    jsub = jps.extract_rows(host, row_ids)
    tsub = tps.extract_rows(packed_from_jax(host), torch.from_numpy(row_ids))
    assert_leaves_equal(jsub, tsub)
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jman_ = jman.write_cold_shards(jdir, jsub, row_ids, ROWS)
    tman_ = tman.write_cold_shards(tdir, tsub, row_ids, ROWS)
    assert json.loads(json.dumps(tman_)) == jman_
    assert jman_["payload16_dtype"] == ("float16" if strict else "bfloat16")
    files = sorted(os.path.relpath(os.path.join(r, f), jdir)
                   for r, _, fs in os.walk(jdir) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(r, f), tdir)
                           for r, _, fs in os.walk(tdir) for f in fs)
    for rel in files:
        if rel.endswith(".npy"):
            a = np.load(os.path.join(jdir, rel))
            b = np.load(os.path.join(tdir, rel))
            assert a.dtype == b.dtype, rel
            np.testing.assert_array_equal(a, b, err_msg=rel)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 100, 57)            # any order, repeats
    for written in (jdir, tdir):
        jc, tc = jman.ColdShards(written), tman.ColdShards(written)
        assert_cold_equal(jc, tc)
        assert tc.num_shards == jc.num_shards == 7 and tc.nbytes() == \
            jc.nbytes()
        np.testing.assert_array_equal(bits(jc.gather_fp32(ids)),
                                      bits(tc.gather_fp32(ids)))
        assert_leaves_equal(jc.extract(ids), tc.extract(ids))


def test_shard_writer_abort_keeps_the_live_generation(tmp_path):
    host = _host(jps.pack(_jstore(3), JCFG))
    tp = packed_from_jax(host)
    store_dir = str(tmp_path / "cold")
    ids1, ids2 = np.arange(0, 80), np.arange(40, 150)
    tman.write_cold_shards(store_dir, tps.extract_rows(tp, ids1), ids1, ROWS)
    live = tman.ColdShards(store_dir)
    want = live.gather_fp32(np.arange(80))
    w = tman.ShardWriter(store_dir, tps.extract_rows(tp, ids2), ids2, ROWS)
    assert w.shards_left == 7 and w.write_next() and w.write_next()
    assert os.path.isdir(w.tmp)
    w.abort()
    w.abort()                                   # idempotent
    assert not os.path.exists(w.tmp)
    for reader in (tman.ColdShards(store_dir), jman.ColdShards(store_dir),
                   live):
        np.testing.assert_array_equal(
            bits(reader.gather_fp32(np.arange(80))), bits(want))
    # a crash between the publish renames: the previous generation is
    # moved back into place on open
    os.rename(store_dir, store_dir + ".old_deadbeef")
    back = tman.ColdShards(store_dir)
    np.testing.assert_array_equal(bits(back.gather_fp32(np.arange(80))),
                                  bits(want))
    with pytest.raises(ValueError, match="schema"):
        m = json.load(open(os.path.join(store_dir, "manifest.json")))
        m["schema"] = "hier_store/v0"
        json.dump(m, open(os.path.join(store_dir, "manifest.json"), "w"))
        tman.ColdShards(store_dir)


# --------------------------------------------------------- build, lookups

@pytest.mark.parametrize("frac,host", [(8, True), (3, True), (1, True),
                                       (8, False)])
def test_build_hier_equals_reference(tmp_path, frac, host):
    _, jh, th = _pair(tmp_path, 0, frac, host)
    assert_hier_equal(jh, th)
    assert (th.cold is not None) == (frac > 2 and host)
    # the reference's state tree carried across gives the same store
    back = hier_store_from_jax(jax.tree.map(np.asarray, jh.state_tree()),
                               th.cfg._replace(
                                   store_dir=str(tmp_path / "jcold")))
    assert_hier_equal(jh, back)


def test_build_requires_store_dir_for_cold():
    jst = _jstore(0)
    b = _budget(jst, 8)
    with pytest.raises(ValueError, match="store_dir"):
        thier.build_hier(_tstore(jst), TCFG, thier.HierConfig(b, b, ROWS))
    # the mesh runs now (tests/test_torch_mesh_serve.py); a mesh that is
    # not a repro_torch.dist.Mesh is refused
    with pytest.raises(TypeError, match="Mesh"):
        thier.build_hier(_tstore(jst), TCFG, thier.HierConfig(b), mesh=4)


def test_hier_lookups_bit_equal_to_the_flat_store(tmp_path):
    jst, jh, th = _pair(tmp_path, 1)
    flat = _flat_rows(jst)
    probe = np.arange(V)
    got = thier.hier_lookup(th, probe).numpy()
    np.testing.assert_array_equal(bits(got), bits(flat))
    np.testing.assert_array_equal(
        bits(got), bits(np.asarray(jhier.hier_lookup(jh,
                                                     jnp.asarray(probe)))))
    np.testing.assert_array_equal(bits(th.gather_fp32_host(probe)),
                                  bits(flat))
    rng = np.random.default_rng(5)
    idx = rng.integers(0, V, (12, 5))
    w = rng.standard_normal((12, 5)).astype(np.float32)
    seg = np.repeat(np.arange(12), 5)
    want = np.asarray(jhier.hier_bag_lookup(
        jh, idx.reshape(-1), jnp.asarray(seg), 12,
        jnp.asarray(w.reshape(-1))))
    got = thier.hier_bag_lookup(th, idx.reshape(-1), torch.from_numpy(seg),
                                12, torch.from_numpy(w.reshape(-1)))
    np.testing.assert_array_equal(bits(want), bits(got))
    backend = HierBackend(_tstore(jst), TCFG, hier=th)
    np.testing.assert_array_equal(
        bits(backend.bag_lookup(torch.from_numpy(idx),
                                torch.from_numpy(w))), bits(want))
    # an empty bag sums to zeros
    empty = thier.hier_bag_lookup(th, np.zeros(0, np.int64),
                                  torch.zeros(0, dtype=torch.int64), 3)
    assert torch.equal(empty, torch.zeros(3, D))


def test_stage_resolves_dedups_and_counts_as_the_reference(tmp_path):
    _, jh, th = _pair(tmp_path, 2)
    rng = np.random.default_rng(6)
    g = rng.integers(0, V, (8, 6))
    g[3] = g[1]                             # repeats
    skip = rng.random((8, 6)) < 0.2
    valid = np.ones((8, 1), bool)
    valid[6:] = False                       # padding
    for kw in ({}, {"skip": skip}, {"valid": valid},
               {"skip": skip, "valid": valid}):
        want = jh._stage(g, **kw)
        got = th._stage(g, **kw)
        for f in ("hot_local", "stage_slot", "staging"):
            np.testing.assert_array_equal(bits(np.asarray(getattr(want, f))),
                                          bits(getattr(got, f)), err_msg=f)
        for f in ("warm_hits", "cold_hits", "staged"):
            assert getattr(got, f) == getattr(want, f), f
    assert th.stats == thier.HierStats(**jh.stats.as_dict())
    assert th.stats.warm_hits and th.stats.cold_hits
    empty = th._stage(np.zeros((0,), np.int64))
    assert empty.staging.shape == (1, D) and empty.staged == 0
    # a torch index tensor stages as its numpy ids
    got = th._stage(torch.from_numpy(g))
    np.testing.assert_array_equal(got.stage_slot.numpy(),
                                  np.asarray(jh._stage(g).stage_slot))


# -------------------------------------------------------------- migration

def _moves(jst, jh):
    """The reference test's priority moves: three cold rows hammered, the
    hot rows cooled."""
    pri = np.asarray(jst.priority).copy()
    pri[jh.cold_ids[:3]] = 1e4
    pri[jh.hot_ids[: max(1, jh.hot_ids.size // 2)]] = 0.0
    return jst._replace(priority=jnp.asarray(pri))


@pytest.mark.parametrize("frac", [8, 3])
def test_migrate_equals_reference_and_pack(tmp_path, frac):
    jst, jh, th = _pair(tmp_path, 3, frac)
    moved = _moves(jst, jh)
    want = jh.migrate(moved, JCFG)
    got = th.migrate(_tstore(moved), TCFG)
    assert got == want and got["promoted"] and got["demoted"]
    assert th.stats == thier.HierStats(**jh.stats.as_dict())
    assert_hier_equal(jh, th)
    flat = _flat_rows(moved)
    np.testing.assert_array_equal(
        bits(thier.hier_lookup(th, np.arange(V))), bits(flat))
    # again with nothing moved: the port reuses the live levels, the
    # reference rebuilds them, and the stores stay equal
    assert th.migrate(_tstore(moved), TCFG) == jh.migrate(moved, JCFG)
    assert_hier_equal(jh, th)
    np.testing.assert_array_equal(
        bits(thier.hier_lookup(th, np.arange(V))), bits(flat))


class _Server:
    """What ``ShadowMigrate.commit`` calls on the server."""

    def __init__(self):
        self.placed = 0

    def _place(self):
        self.placed += 1


def _drive(sh, budget):
    steps = 0
    while not sh.step(budget):
        steps += 1
    return steps + 1


def test_shadow_migrate_lands_on_the_synchronous_migration(tmp_path):
    jst = _jstore(4)
    _, jh, sync = _pair(tmp_path / "a", jst=jst)
    _, _, th = _pair(tmp_path / "b", jst=jst)
    moved = _moves(jst, jh)
    tmoved = _tstore(moved)
    js = JShadowMigrate(jh, moved, JCFG, chunk_rows=7)
    sh = ShadowMigrate(th, tmoved, TCFG, chunk_rows=7)
    assert sh._cold_needed and js._cold_needed      # a cold rewrite
    assert (sh.total_rows, sh.moved) == (js.total_rows, js.moved)
    assert _drive(sh, 11) == _drive(js, 11)
    sh.verify()
    assert sh.commit(_Server(), None) == js.commit(_Server(), None) == \
        sync.migrate(tmoved, TCFG)["crossed"]
    assert_hier_equal(jh, th)
    assert_hier_equal(jh, sync)
    np.testing.assert_array_equal(bits(thier.hier_lookup(th, np.arange(V))),
                                  bits(_flat_rows(moved)))


def test_shadow_migrate_discard_leaves_the_live_store(tmp_path):
    jst, _, th = _pair(tmp_path, 5)
    before = thier.hier_lookup(th, np.arange(V)).numpy()
    state = {f: getattr(th, f).copy() for f in ("level", "slot", "tiers")}
    cold_dir = th.cfg.store_dir
    manifest = dict(th.cold.manifest)
    pri = np.asarray(jst.priority).copy()
    pri[th.cold_ids[:5]] = 1e4
    sh = ShadowMigrate(th, _tstore(jst._replace(priority=jnp.asarray(pri))),
                       TCFG, chunk_rows=64)
    while sh.writer is None or sh.writer.shards_left == sh.writer.num_shards:
        sh.step(1 << 20)
    tmp = sh.writer.tmp
    assert os.path.isdir(tmp)
    sh.discard()
    assert not os.path.exists(tmp)
    for f, v in state.items():
        np.testing.assert_array_equal(getattr(th, f), v)
    assert tman.ColdShards(cold_dir).manifest == manifest
    np.testing.assert_array_equal(
        bits(thier.hier_lookup(th, np.arange(V))), bits(before))
    # a failed verify raises
    sh = ShadowMigrate(th, _tstore(jst), TCFG)
    _drive(sh, 1 << 20)
    for name in ("hot", "warm"):
        sh.results[name] = sh.results[name]._replace(
            payload32=sh.results[name].payload32 + 1.0)
    with pytest.raises(AssertionError, match="verify FAILED"):
        sh.verify()
