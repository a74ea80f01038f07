"""The port's shadow re-tiers against the JAX package, on the CPU.

At the reference harness's size (V = 160, D = 24, ``tests/test_shadow_swap
.py``) and the same numpy inputs: ``extract_rows``, ``merge_stores`` and
``concat_stores`` leaf-equal to the reference's (bf16 and fp16 payloads
as bits); ``ShadowRepack``'s movers equal and its ``materialize`` leaf-
equal to the reference's at every chunk boundary; a deterministic
schedule (explicit begin, chunk, drain and discard) served bit for bit
as the JAX ``OnlineServer`` serves it, with equal counters, cache ids and
``serve.shadow.*`` metrics.  Random schedules, where the tick a swap
lands on depends on the staging thread, are held to the port's own
``pack`` after every op (the lockstep oracle of the reference's
harness).  Also: the verify failure path, the hashed backend, snapshot
isolation, the serve CLI's and the benchmark's ``--retier-async``, and
the loops' ``p99_while_retiering`` window.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import pathlib
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro import obs as jobs
from repro.core import packed_store as jps
from repro.core import qat_store as jqs
from repro.core.tiers import TierConfig
from repro.serve import OnlineConfig as JOnlineConfig
from repro.serve import OnlineServer as JOnlineServer
from repro_torch import obs as tobs
from repro_torch.benchmarks import qps as tqps
from repro_torch.convert import (hashed_config_from_jax,
                                 hashed_store_from_jax, packed_from_jax,
                                 qat_store_from_jax)
from repro_torch.core import packed_store as tps
from repro_torch.core import qat_store as tqs
from repro_torch.launch import serve as tserve
from repro_torch.serve import loop as tloop
from repro_torch.serve import shadow as tshadow
from repro_torch.serve.online import OnlineConfig, OnlineServer
from repro_torch.store.api import build as tbuild

V, D = 160, 24
TIERS = TierConfig(t8=5.0, t16=50.0)
JCFG = jqs.FQuantConfig(tiers=TIERS, stochastic=False)
TCFG = tqs.FQuantConfig(tiers=TIERS, stochastic=False)

# the reference harness's op mix: mostly traffic, with enough begin /
# chunk / tick to keep a build in flight, and the rare drain / discard
OPS = ("serve", "serve", "serve", "fold", "fold", "begin", "chunk",
       "chunk", "tick", "drain", "discard")

_TOOL = (pathlib.Path(__file__).resolve().parents[1] / "tools"
         / "check_bench_schema.py")
_spec = importlib.util.spec_from_file_location("check_bench_schema", _TOOL)
check_bench_schema = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(check_bench_schema)


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.view(torch.int16)
        x = x.detach().cpu().numpy()
    a = np.asarray(x)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.dtype.itemsize])


def assert_leaves_equal(want, got) -> None:
    """A reference ``PackedStore`` (JAX or numpy leaves) against the
    port's: every leaf's shape and bits."""
    for name in jps.PackedStore._fields:
        w = np.asarray(getattr(want, name))
        g = getattr(got, name)
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_array_equal(bits(w), bits(g), err_msg=name)


def _jstore(seed=0, scale_pri=20.0, cfg=JCFG):
    """The reference harness's store: pareto priorities, snapped table."""
    rng = np.random.default_rng(seed)
    st_ = jqs.init(jax.random.PRNGKey(seed), V, D, scale=0.05)
    pri = jnp.asarray((rng.pareto(1.2, V) * scale_pri).astype(np.float32))
    st_ = st_._replace(priority=pri)
    return st_._replace(table=jqs.snap(st_.table,
                                       jqs.current_tiers(st_, cfg), cfg))


def _tstore(jst) -> tqs.QATStore:
    return qat_store_from_jax(jax.tree.map(np.asarray, jst))


def _host(packed) -> jps.PackedStore:
    """A reference pack with numpy leaves (bf16 / fp16 kept as bits)."""
    return jps.PackedStore(*(np.asarray(x) for x in packed))


def _tpack(jpacked) -> tps.PackedStore:
    host = _host(jpacked)
    if host.payload16.dtype != np.float16:
        host = host._replace(payload16=host.payload16.view(np.uint16))
    return packed_from_jax(host)


def _unpack(packed) -> np.ndarray:
    return tps.unpack(packed).numpy()


# -- extract_rows / merge_stores / concat_stores -----------------------------

@pytest.fixture(scope="module", params=[False, True], ids=["bf16", "fp16"])
def packs(request):
    """(reference pack, the port's copy of it) of a 3-tier store, with the
    half tier in bf16 or fp16."""
    cfg = JCFG._replace(strict_fp16=request.param)
    jpacked = jps.pack(_jstore(1, cfg=cfg), cfg)
    tpacked = _tpack(jpacked)
    assert all(tps.live_counts(tpacked))
    return jpacked, tpacked


def _row_sets(jpacked) -> dict:
    rng = np.random.default_rng(3)
    tiers = np.asarray(jps.packed_tiers(jpacked))
    return {
        "permuted_40": rng.permutation(V)[:40],
        "unsorted_repeats": rng.integers(0, V, 97),
        "all": np.arange(V),
        "empty": np.zeros((0,), np.int64),
        "no_half_tier": np.nonzero(tiers != 1)[0][::-1].copy(),
        "fp32_only": np.nonzero(tiers == 2)[0][:3],
        "int32_ids": rng.integers(0, V, 31).astype(np.int32),
    }


@pytest.mark.parametrize("case", ["permuted_40", "unsorted_repeats", "all",
                                  "empty", "no_half_tier", "fp32_only",
                                  "int32_ids"])
def test_extract_rows_leaf_equal_to_jax(packs, case):
    jpacked, tpacked = packs
    rows = _row_sets(jpacked)[case]
    want = jps.extract_rows(jpacked, rows)
    got = tps.extract_rows(tpacked, torch.from_numpy(rows))
    assert_leaves_equal(want, got)
    # numpy ids are taken as they are
    assert_leaves_equal(want, tps.extract_rows(tpacked, rows))
    if rows.size:
        np.testing.assert_array_equal(
            bits(tps.lookup(got, torch.arange(rows.size))),
            bits(tps.lookup(tpacked, torch.from_numpy(rows))))


@pytest.mark.parametrize("parts", [
    ["permuted_40", "all"], ["fp32_only", "no_half_tier", "fp32_only"],
    ["empty", "unsorted_repeats", "empty"], ["fp32_only"],
    ["int32_ids", "permuted_40", "fp32_only", "unsorted_repeats"]])
def test_merge_stores_leaf_equal_to_jax(packs, parts):
    """Emptied tiers' placeholders dropped from the middle, later stores
    rebased past the running counts: the reference's leaves."""
    jpacked, tpacked = packs
    sets = _row_sets(jpacked)
    jsubs = [jps.extract_rows(jpacked, sets[p]) for p in parts]
    tsubs = [tps.extract_rows(tpacked, sets[p]) for p in parts]
    want = jps.merge_stores(jsubs)
    got = tps.merge_stores(tsubs)
    assert_leaves_equal(want, got)
    both = np.concatenate([sets[p] for p in parts]).astype(np.int64)
    if both.size:
        np.testing.assert_array_equal(
            bits(tps.lookup(got, torch.arange(both.size))),
            bits(tps.lookup(tpacked, torch.from_numpy(both))))
    if len(parts) == 2:
        assert_leaves_equal(want, tps.concat_stores(*tsubs))


def test_concat_stores_cases_of_the_hier_tests(packs):
    """``tests/test_hier_store.py``'s two concat cases, leaf-equal: two
    disjoint row ranges of different tier mix, and two fp32-only stores
    whose empty tiers' placeholders must not leak into the result."""
    jpacked, tpacked = packs
    a_rows, b_rows = np.arange(0, 30), np.arange(90, 150)
    want = jps.concat_stores(jps.extract_rows(jpacked, a_rows),
                             jps.extract_rows(jpacked, b_rows))
    got = tps.concat_stores(tps.extract_rows(tpacked, a_rows),
                            tps.extract_rows(tpacked, b_rows))
    assert_leaves_equal(want, got)
    only32 = np.nonzero(np.asarray(jps.packed_tiers(jpacked)) == 2)[0]
    want = jps.concat_stores(jps.extract_rows(jpacked, only32[:2]),
                             jps.extract_rows(jpacked, only32[2:4]))
    got = tps.concat_stores(tps.extract_rows(tpacked, only32[:2]),
                            tps.extract_rows(tpacked, only32[2:4]))
    assert_leaves_equal(want, got)
    assert tps.live_counts(got) == [0, 0, 4]
    np.testing.assert_array_equal(
        bits(tps.lookup(got, torch.arange(4))),
        bits(tps.lookup(tpacked, torch.from_numpy(only32[:4]))))
    with pytest.raises(ValueError, match="at least one"):
        tps.merge_stores([])


# -- ShadowRepack ------------------------------------------------------------

def _drifted(seed: int, folds: int = 6):
    """A reference store and the port's copy after ``folds`` drifting
    folds from the pack of the fresh store: (jpacked, jst2, tpacked,
    tst2)."""
    rng = np.random.default_rng(seed)
    jst = _jstore(seed % 5)
    jpacked = jps.pack(jst, JCFG)
    pri = np.asarray(jst.priority)
    for _ in range(folds):
        idx = rng.integers(0, V, (64,))
        pri = pri * np.float32(0.5) + np.bincount(idx, minlength=V).astype(
            np.float32) * np.float32(4.0)
    jst2 = jst._replace(priority=jnp.asarray(pri.astype(np.float32)))
    return jpacked, jst2, _tpack(jpacked), _tstore(jst2)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_shadow_repack_leaf_equal_to_jax_at_every_chunk(seed):
    from repro.serve.shadow import ShadowRepack as JShadowRepack
    jpacked, jst2, tpacked, tst2 = _drifted(seed)
    jsh = JShadowRepack(jps.PackedStore(*(np.asarray(x) for x in jpacked)),
                        jst2, JCFG, chunk_rows=7)
    tsh = tshadow.ShadowRepack(tpacked, tst2, TCFG)
    np.testing.assert_array_equal(jsh.movers, tsh.movers.numpy())
    assert tsh.moved == jsh.moved > 10
    rng = np.random.default_rng(seed)
    while not tsh.staged:
        budget = int(rng.integers(1, 12))
        assert jsh.step(budget) == tsh.step(budget)
        assert (tsh.pos, tsh.remaining_rows) == (jsh.pos, jsh.remaining_rows)
        want = jsh.result if jsh.staged else jsh.materialize()
        got = tsh.result if tsh.staged else tsh.materialize()
        assert_leaves_equal(want, got)
        delta = tps.repack_delta(tpacked, tst2, TCFG, tsh.movers[:tsh.pos])
        np.testing.assert_array_equal(bits(_unpack(got)),
                                      bits(_unpack(delta)))
    assert jsh.staged
    np.testing.assert_array_equal(
        bits(_unpack(tsh.place())),
        bits(_unpack(tps.pack(tst2, TCFG))))
    tsh.verify()
    # the live store was read, never written
    assert_leaves_equal(jpacked, tpacked)


def test_shadow_repack_materializes_in_one_merge_whatever_the_steps(
        monkeypatch):
    """A build of one-row steps ends in one two-store merge (the live
    rows and the mover blocks), not one store a step, and its leaves
    equal the reference's after the same steps."""
    from repro.serve.shadow import ShadowRepack as JShadowRepack
    jpacked, jst2, tpacked, tst2 = _drifted(4)
    merged = []
    merge = tshadow.merge_stores
    monkeypatch.setattr(tshadow, "merge_stores",
                        lambda stores: merged.append(len(stores))
                        or merge(stores))
    tsh = tshadow.ShadowRepack(tpacked, tst2, TCFG)
    jsh = JShadowRepack(jps.PackedStore(*(np.asarray(x) for x in jpacked)),
                        jst2, JCFG, chunk_rows=7)
    steps = 0
    while not tsh.staged:
        tsh.step(1)
        jsh.step(1)
        steps += 1
    assert jsh.staged and steps == tsh.moved > 10
    assert merged == [2]
    assert_leaves_equal(jsh.result, tsh.result)


def _flip_first_row(packed: tps.PackedStore) -> None:
    """Flip one bit of the payload row that global row 0 reads."""
    code = int(packed.indirect[0])
    t, loc = code >> 28, code & ((1 << 28) - 1)
    payload = (packed.payload8, packed.payload16, packed.payload32)[t]
    as_int = payload.view({1: torch.int8, 2: torch.int16,
                           4: torch.int32}[payload.element_size()])
    as_int[loc, 0] ^= 1


def _server(seed=0, retier_every=0, rows=16, verify=True, cache_rows=24):
    return OnlineServer(
        _tstore(_jstore(seed)), TCFG,
        OnlineConfig(cache_rows=cache_rows, retier_every=retier_every,
                     retier_async=True, shadow_rows_per_step=rows,
                     verify_swap=verify))


def _fold(server, rng, n=4, hot=V, size=64, lo=0) -> None:
    """``n`` folds of ``size`` ids drawn from rows [lo, lo + hot)."""
    for _ in range(n):
        server.observe(torch.from_numpy(
            rng.integers(lo, lo + hot, (size,)).astype(np.int32)), count=16)


def _heat(server, rng, lo: int) -> None:
    """Two folds that lift rows [lo, lo + 16) into the half tier while
    the rest decay into int8: some rows cross tiers every time the hot
    range moves."""
    _fold(server, rng, 2, hot=16, size=256, lo=lo)


def test_verify_failure_raises_at_the_swap_and_keeps_the_live_store():
    rng = np.random.default_rng(5)
    server = _server(seed=2)
    _fold(server, rng, 6)
    live = server.packed
    ptrs = [x.data_ptr() for x in live]
    before = [x.clone() for x in live]
    assert server.begin_retier()
    sh = server.shadow
    sh.step(1 << 20)                       # staged, staging not started
    sh.verify()
    _flip_first_row(sh.result)
    with pytest.raises(AssertionError, match="verify FAILED"):
        sh.verify()
    with pytest.raises(AssertionError, match="verify FAILED"):
        server.drain_shadow()
    assert server.shadow is None and server._warmup is None
    assert server.stats.swaps == 0 and server._stage_err is None
    assert server.packed is live
    assert [x.data_ptr() for x in server.packed] == ptrs
    for a, b in zip(before, server.packed):
        assert torch.equal(a, b)
    # serving goes on from the old generation, and the next build swaps
    assert server.begin_retier()
    server.drain_shadow()
    assert server.stats.swaps == 1


def run_flat_schedule(server, ops, rng) -> int:
    """The reference harness's scheduler on the port: after every op the
    live store unpacks to the lockstep oracle, a full ``pack`` at the
    last swap's snapshot fold state, and every chunk's materialized store
    to the partial ``repack_delta``.  A swap may land inside any op (the
    staging thread's end is not scheduled), so the swap counter is read
    after each.  Returns the swaps."""
    mirror = _unpack(server.packed)
    np.testing.assert_array_equal(
        bits(mirror), bits(_unpack(tps.pack(server.store, TCFG))))
    last_snap = None
    swaps = 0
    for op in ops:
        pre = server.stats.swaps
        if op == "serve":
            idx = rng.integers(0, V, (8,)).astype(np.int32)
            rows = server.lookup(torch.from_numpy(idx))
            np.testing.assert_array_equal(bits(rows), bits(mirror[idx]))
        elif op == "fold":
            server.observe(torch.from_numpy(
                rng.integers(0, V, (16,)).astype(np.int32)), count=4)
        elif op == "begin":
            server.begin_retier()
        elif op == "chunk":
            sh = server.shadow
            if sh is not None and not sh.staged:
                sh.step(int(rng.integers(1, 48)))
                ref = tps.repack_delta(server.packed, sh.snapshot, TCFG,
                                       sh.movers[:sh.pos])
                np.testing.assert_array_equal(
                    bits(_unpack(sh.materialize())), bits(_unpack(ref)))
        elif op == "tick":
            server._shadow_tick(1)
        elif op == "drain":
            server.drain_shadow()
        elif op == "discard":
            server.discard_shadow()
            np.testing.assert_array_equal(bits(_unpack(server.packed)),
                                          bits(mirror))
        if server.stats.swaps > pre:
            swaps += server.stats.swaps - pre
            mirror = _unpack(tps.pack(last_snap, TCFG))
        np.testing.assert_array_equal(bits(_unpack(server.packed)),
                                      bits(mirror))
        if server.shadow is not None:
            last_snap = server.shadow.snapshot
    pre = server.stats.swaps
    server.drain_shadow()
    if server.stats.swaps > pre:
        swaps += server.stats.swaps - pre
        mirror = _unpack(tps.pack(last_snap, TCFG))
    np.testing.assert_array_equal(bits(_unpack(server.packed)), bits(mirror))
    return swaps


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=10, deadline=None, derandomize=True)
def test_flat_schedules_hold_the_lockstep_oracle(seed):
    rng = np.random.default_rng(seed)
    server = _server(seed=seed % 5)
    ops = [OPS[i] for i in rng.integers(0, len(OPS), 40)]
    run_flat_schedule(server, ops, rng)


def test_auto_mode_swaps_under_traffic():
    """``retier_every``-triggered builds open, chunk and swap on their
    own while every lookup stays on the oracle; a short switch interval
    interleaves the staging thread with the serving one often."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        rng = np.random.default_rng(3)
        server = _server(seed=3, retier_every=2)
        swaps = run_flat_schedule(server, ["serve"] * 60, rng)
    finally:
        sys.setswitchinterval(interval)
    assert server.stats.shadow_builds >= 1 and swaps >= 1
    assert server.stats.rows_moved > 0


def test_swap_during_drift_lands_the_snapshot_state():
    """Priorities folded after the snapshot stay out of the swapped store
    (it equals ``pack`` at the snapshot); the next build picks them up."""
    rng = np.random.default_rng(11)
    server = _server(seed=1)
    _fold(server, rng, 6)
    assert server.begin_retier()
    snap = server.shadow.snapshot
    while server.shadow is not None and not server.shadow.staged:
        _fold(server, rng, 1, hot=16, size=256)   # rows 0-15 heat up
        if server.shadow is not None:
            server.shadow.step(16)
    drifted = server.store
    server.drain_shadow()
    assert server.stats.swaps == 1
    np.testing.assert_array_equal(
        bits(_unpack(server.packed)), bits(_unpack(tps.pack(snap, TCFG))))
    crossed = tps.packed_tiers(server.packed).to(torch.int64) != \
        tqs.current_tiers(drifted, TCFG)
    assert bool(crossed.any())
    assert not np.array_equal(bits(_unpack(server.packed)),
                              bits(_unpack(tps.pack(drifted, TCFG))))
    assert server.begin_retier()
    final = server.shadow.snapshot
    server.drain_shadow()
    np.testing.assert_array_equal(
        bits(_unpack(server.packed)), bits(_unpack(tps.pack(final, TCFG))))


def test_double_swap_and_crash_before_swap():
    rng = np.random.default_rng(23)
    server = _server(seed=2)
    before = _unpack(server.packed)
    _fold(server, rng)
    assert server.begin_retier()
    server.shadow.step(8)
    server.discard_shadow()                 # crash before the swap
    np.testing.assert_array_equal(bits(_unpack(server.packed)), bits(before))
    assert server.stats.swaps == 0 and server.shadow is None
    for n in (1, 2):                        # two full cycles
        _heat(server, rng, 40 * n)
        assert server.begin_retier()
        snap = server.shadow.snapshot
        server.drain_shadow()
        assert server.stats.swaps == n
        np.testing.assert_array_equal(
            bits(_unpack(server.packed)), bits(_unpack(tps.pack(snap, TCFG))))
    # a begin with nothing to move is the synchronous no-move path
    retiers = server.stats.retiers
    assert not server.begin_retier()
    assert server.shadow is None and server.stats.retiers == retiers + 1


def test_synchronous_retier_supersedes_a_shadow():
    rng = np.random.default_rng(31)
    server = _server(seed=4)
    _fold(server, rng, 6)
    assert server.begin_retier()
    server.shadow.step(3)
    server._retier_pending = True
    assert server.retier()
    assert server.shadow is None and not server._retier_pending
    assert server.stats.swaps == 0 and server.stats.retiers == 1
    np.testing.assert_array_equal(
        bits(_unpack(server.packed)),
        bits(_unpack(tps.pack(server.store, TCFG))))
    # a build whose staging thread is running is joined, then dropped
    _heat(server, rng, 100)
    assert server.begin_retier()
    server._shadow_tick(1 << 20)
    assert server.shadow.staged and server._warmup is not None
    server.retier()
    assert server.shadow is None and server._warmup is None
    assert server.stats.swaps == 0


def test_snapshot_is_isolated_from_later_folds():
    """The fold returns a new priority tensor, so the shadow's snapshot
    (the ``QATStore`` it keeps) does not drift: this guards against a
    later in-place fold."""
    rng = np.random.default_rng(7)
    server = _server(seed=0, rows=1)
    _fold(server, rng, 6)
    assert server.begin_retier()
    snap = server.shadow.snapshot
    held = snap.priority.clone()
    _fold(server, rng, 3)               # each advances the build 16 rows
    assert server.shadow.snapshot is snap and not server.shadow.staged
    assert server.store.priority is not snap.priority
    assert not torch.equal(server.store.priority, held)
    assert torch.equal(snap.priority.view(torch.int32),
                       held.view(torch.int32))
    server.drain_shadow()


# -- the JAX server on one deterministic schedule ----------------------------

def _clean_metrics():
    for o in (jobs, tobs):
        o.disable()
        o.get_registry().reset()


def test_deterministic_schedule_matches_the_jax_server():
    """Explicit begin, chunk, serve, drain and discard on both servers:
    no swap can land on a tick (the schedule never serves while a build
    is staged), so rows, counters, cache ids and the ``serve.shadow.*``
    metrics are all determined."""
    jst = _jstore(1)
    online = dict(cache_rows=24, retier_every=0, retier_async=True,
                  shadow_rows_per_step=4, verify_swap=True)
    _clean_metrics()
    jobs.enable()
    tobs.enable()
    try:
        jsrv = JOnlineServer(jst, JCFG, JOnlineConfig(**online))
        tsrv = OnlineServer(_tstore(jst), TCFG, OnlineConfig(**online))
        rng = np.random.default_rng(8)

        def fold(n=4, lo=0, hot=V):
            for _ in range(n):
                idx = rng.integers(lo, lo + hot, (128,)).astype(np.int32)
                jsrv.observe(jnp.asarray(idx), count=16)
                tsrv.observe(torch.from_numpy(idx), count=16)

        def serve():
            idx = rng.integers(0, V, (8, 3)).astype(np.int32)
            want = np.asarray(jsrv.lookup(jnp.asarray(idx)))
            got = tsrv.lookup(torch.from_numpy(idx))
            np.testing.assert_array_equal(bits(want), bits(got))

        def begin():
            assert jsrv.begin_retier() and tsrv.begin_retier()
            np.testing.assert_array_equal(jsrv.shadow.movers,
                                          tsrv.shadow.movers.numpy())

        def chunk(n):
            assert jsrv.shadow.step(n) == tsrv.shadow.step(n) is False

        serve()
        fold(6)
        begin()
        assert tsrv.shadow.moved >= 30
        for n in (5, 2):
            chunk(n)
            serve()                     # a tick: 4 more rows, not staged
            assert not tsrv.shadow.staged and not jsrv.shadow.staged
        jsrv.drain_shadow()
        tsrv.drain_shadow()
        serve()
        fold(2, lo=40, hot=16)
        begin()
        chunk(3)
        serve()
        jsrv.discard_shadow()
        tsrv.discard_shadow()
        serve()
        for f in ("requests", "lookups", "hits", "retiers", "rows_moved",
                  "shadow_builds", "shadow_chunks", "swaps"):
            assert getattr(tsrv.stats, f) == getattr(jsrv.stats, f), f
        assert tsrv.stats.swaps == 1 and tsrv.stats.shadow_builds == 2
        np.testing.assert_array_equal(np.asarray(jsrv.cache.ids),
                                      tsrv.cache.ids.numpy())
        np.testing.assert_array_equal(bits(jps.unpack(jsrv.host_packed)),
                                      bits(_unpack(tsrv.packed)))
        jreg, treg = jobs.get_registry(), tobs.get_registry()
        want = {k: v for k, v in jreg.counters.items()
                if k.startswith(("serve.shadow.", "serve.retier"))}
        got = {k: v for k, v in treg.counters.items()
               if k.startswith(("serve.shadow.", "serve.retier"))}
        assert got == want and want["serve.shadow.swaps"] == 1
        assert treg.gauges["serve.shadow.in_flight"] == 0.0
        for h in ("serve.shadow.plan_us", "serve.shadow.chunk_us",
                  "serve.shadow.stage_us", "serve.shadow.verify_us",
                  "serve.shadow.swap_us", "serve.shadow.build_us",
                  "serve.retier_us"):
            assert (treg.histograms[h].count
                    == jreg.histograms[h].count > 0), h
    finally:
        _clean_metrics()


def test_hashed_backend_refreshes_the_cache_at_each_boundary():
    """The hashed pool has no shadow: each boundary counts a re-tier and
    rebuilds the cache from the live priorities, as the reference's
    server does."""
    from repro.store import HashedConfig, build as jbuild
    from repro.store import plan_pool_slots
    from repro.store.hashed import init_hashed
    hcfg = HashedConfig(vocab=V, dim=D, chunk_dim=8,
                        num_slots=plan_pool_slots(V, D, 8, 4.0), pool_bits=32)
    hs = init_hashed(hcfg, seed=0)
    hs = hs._replace(priority=_jstore(0).priority)
    online = dict(cache_rows=16, retier_every=2, retier_async=True)
    jsrv = JOnlineServer(backend=jbuild("hashed", hs, hcfg),
                         online=JOnlineConfig(**online))
    tsrv = OnlineServer(backend=tbuild(
        "hashed", hashed_store_from_jax(jax.tree.map(np.asarray, hs)),
        hashed_config_from_jax(hcfg)), online=OnlineConfig(**online))
    rng = np.random.default_rng(4)
    for _ in range(5):
        idx = rng.integers(0, V, (16, 4)).astype(np.int32)
        jsrv.lookup(jnp.asarray(idx))
        tsrv.lookup(torch.from_numpy(idx))
        np.testing.assert_array_equal(np.asarray(jsrv.cache.ids),
                                      tsrv.cache.ids.numpy())
    assert tsrv.stats.retiers == jsrv.stats.retiers == 2
    assert tsrv.stats.hits == jsrv.stats.hits
    assert tsrv.shadow is None and tsrv.stats.shadow_builds == 0
    assert tsrv.stats.swaps == jsrv.stats.swaps == 0


# -- the serve CLI, the benchmark and the loops' window ----------------------

@pytest.fixture
def joined_staging(monkeypatch):
    """The staging thread joined as soon as it starts, so a build swaps on
    the tick after it is staged: the CLI's counters, not the thread's
    timing, are under test here (the schedules above cover the timing)."""
    begin = OnlineServer._begin_staging

    def joined(self):
        begin(self)
        self._warmup.join()
    monkeypatch.setattr(OnlineServer, "_begin_staging", joined)


def test_serve_cli_retier_async_on_cpu(monkeypatch, joined_staging):
    """``--online --retier-async --verify-swap``: the record says so,
    swaps land on request ticks, and the final store equals ``pack`` at
    the last swap's snapshot."""
    snaps = []
    commit = tshadow.ShadowRepack.commit

    def spy(self, server, staged):
        snaps.append(self.snapshot)
        return commit(self, server, staged)
    monkeypatch.setattr(tshadow.ShadowRepack, "commit", spy)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        served = tserve.run(tserve.parse_args(
            ["--online", "--retier-async", "--verify-swap", "--model",
             "smoke", "--device", "cpu", "--requests", "12",
             "--shadow-rows", "65536"]))
    rec, server = served.record, served.server
    assert rec["retier_async"] is True and rec["swaps"] >= 1
    assert rec["shadow_builds"] >= rec["swaps"]
    assert server.shadow is None and len(snaps) == server.stats.swaps
    assert "shadow: " in out.getvalue() and "verified" in out.getvalue()
    np.testing.assert_array_equal(
        bits(_unpack(server.packed)),
        bits(_unpack(tps.pack(snaps[-1], server.cfg))))


@pytest.mark.parametrize("argv,msg", [
    (["--retier-async"], "--retier-async requires --online"),
    (["--online", "--verify-swap"], "--verify-swap requires --retier-async")])
def test_serve_cli_shadow_argument_errors(argv, msg):
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit):
        tserve.parse_args(argv)
    assert msg in err.getvalue()


def test_bench_qps_retier_async_on_cpu(joined_staging):
    """Keys and counters only: the card's run applies the tail budget."""
    with contextlib.redirect_stdout(io.StringIO()):
        rec = tqps.main(["--online", "--retier-async", "--serve-batch",
                         "1,8", "--device", "cpu"])
    assert rec["retier_async"] is True
    errors = check_bench_schema.validate(rec)
    assert not [e for e in errors if "tail budget" not in e], errors
    for e in rec["sweep"]:
        assert e["shadow_builds"] >= e["swaps"] >= 1
        assert e["retiers"] >= e["swaps"] and e["rows_moved"] > 0
    with contextlib.redirect_stdout(io.StringIO()):
        one = tqps.run_online(batch=16, requests=6, retier_every=2,
                              retier_async=True, device="cpu")
    assert one["retier_async"] is True and one["shadow_builds"] >= 1


def _slow_shadow_ticks(monkeypatch, seconds: float) -> list:
    """Make every shadow step take ``seconds`` longer and log, a request
    at a time, whether it stepped."""
    stepped = []
    step = tshadow.ShadowRepack.step

    def slow(self, budget):
        stepped.append(True)
        time.sleep(seconds)
        return step(self, budget)
    monkeypatch.setattr(tshadow.ShadowRepack, "step", slow)
    return stepped


@pytest.mark.parametrize("micro", [False, True], ids=["request", "micro"])
def test_loops_count_shadow_batches_in_the_retier_window(monkeypatch,
                                                         micro):
    """A build that never finishes inside the loop: no request re-tiers,
    yet the requests that stepped the shadow make up the
    ``p99_while_retiering`` window, as in the reference's loops."""
    _slow_shadow_ticks(monkeypatch, 0.02)
    from repro_torch import configs
    arch = configs.get("dlrm-rm2")
    model = arch.smoke_model
    spec = model.spec
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, torch.device("cpu"), with_table=True)
    table = params.pop("embed_table")
    pri = torch.from_numpy((np.random.default_rng(0).pareto(
        1.2, spec.total_rows) * 10).astype(np.float32))
    store = tqs.QATStore(table, pri)
    server = OnlineServer(store, TCFG, OnlineConfig(
        cache_rows=0, retier_every=2, retier_async=True,
        shadow_rows_per_step=1))
    kw = dict(requests=12, drift=4.0, num_dense=arch.smoke_num_dense)
    if micro:
        res = tloop.serve_forward_microbatched(server, model, spec, params,
                                               serve_batch=2, **kw)
    else:
        res = tloop.serve_forward_loop(server, model, spec, params,
                                       batch=8, **kw)
    assert res.stats["retiers"] == 0 and res.stats["swaps"] == 0
    assert server.shadow is not None and server.stats.shadow_chunks >= 3
    assert res.p99_while_retiering >= 0.02 * 1e6
    server.discard_shadow()
