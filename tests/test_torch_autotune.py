"""The port's autotune cache beside the reference's (``kernels.autotune``).

The cache file, its keys (the backend aside: the reference keys by JAX
backend, the port by card name), the reload, invalidation and disabling
rules are the reference's; the candidate tilings put the analytic pick
first; a sweep skips a failing candidate and raises when all fail; a
wrapper resolves an explicit tiling, then a cache hit, then the analytic
pick.  All on the CPU: the CUDA launches are card tests
(``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import json
import os

import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro.kernels import autotune as jat
from repro_torch.kernels import autotune as tat
from repro_torch.kernels.bag_matmul import kernel as bm_kernel
from repro_torch.kernels.bag_matmul import ops as bm_ops
from repro_torch.kernels.dequant_bag import kernel as db_kernel
from repro_torch.kernels.dequant_bag import ops as db_ops
from repro_torch.kernels.hashed_gather import kernel as hg_kernel
from repro_torch.kernels.hashed_gather import ops as hg_ops

MODULES = {"reference": jat, "port": tat}


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = tmp_path / "sub" / "autotune.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    for mod in MODULES.values():
        mod._loaded.update(path=None, mtime=None, entries={})
    return path


def test_key_format_matches_the_reference_backend_aside():
    for args in (("dequant_bag", "int8", 64, 8, 64),
                 ("bag_matmul", "float32", 512, 40, 32, "|h=1024"),
                 ("hashed_gather", "int8", 20480, 2, 8)):
        jk, tk = jat.cache_key(*args), tat.cache_key(*args)
        assert jk.split("|", 1)[1] == tk.split("|", 1)[1]
        assert tk.split("|", 1)[0] == "cpu"        # no card here


@pytest.mark.parametrize("name", list(MODULES))
def test_store_lookup_round_trip(cache, name):
    mod = MODULES[name]
    assert mod.lookup_cached("dequant_bag", "int8", 64, 8, 64) is None
    assert mod.store("dequant_bag", "int8", 64, 8, 64, 32, 16, 3.5) == \
        str(cache)
    mod.store("bag_matmul", "int8", 64, 8, 64, 32, 64, 9.0, extra="|h=32")
    assert mod.lookup_cached("dequant_bag", "int8", 64, 8, 64) == (32, 16)
    assert mod.lookup_cached("bag_matmul", "int8", 64, 8, 64,
                             extra="|h=32") == (32, 64)
    assert mod.lookup_cached("bag_matmul", "int8", 64, 8, 64) is None
    doc = json.loads(cache.read_text())
    assert doc["schema"] == "autotune_cache/v1" == mod.CACHE_SCHEMA
    assert len(doc["entries"]) == 2
    assert not os.path.exists(str(cache) + ".tmp")     # atomic replace


@pytest.mark.parametrize("name", list(MODULES))
@pytest.mark.parametrize("text", [
    '{"schema": "autotune_cache/v0", "entries": {}}',
    "{not json",
    '["a list"]',
    '{"schema": "autotune_cache/v1", "entries": []}'])
def test_wrong_schema_or_corrupt_file_reads_as_empty(cache, name, text):
    mod = MODULES[name]
    cache.parent.mkdir(parents=True)
    cache.write_text(text)
    assert mod.lookup_cached("dequant_bag", "int8", 64, 8, 64) is None
    # a store over a bad file starts a fresh one
    mod.store("dequant_bag", "int8", 64, 8, 64, 8, 8, 1.0)
    assert mod.lookup_cached("dequant_bag", "int8", 64, 8, 64) == (8, 8)


@pytest.mark.parametrize("name", list(MODULES))
@pytest.mark.parametrize("entry", [
    {"block_b": "32", "block_d": 16}, {"block_b": 0, "block_d": 16},
    {"block_b": 32}, [32, 16], {"block_b": 2.5, "block_d": 1}])
def test_malformed_entry_is_a_miss(cache, name, entry):
    mod = MODULES[name]
    cache.parent.mkdir(parents=True)
    key = mod.cache_key("dequant_bag", "int8", 64, 8, 64)
    cache.write_text(json.dumps({"schema": "autotune_cache/v1",
                                 "entries": {key: entry}}))
    assert mod.lookup_cached("dequant_bag", "int8", 64, 8, 64) is None


@pytest.mark.parametrize("name", list(MODULES))
def test_empty_path_disables_the_cache(monkeypatch, name):
    mod = MODULES[name]
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", "")
    assert mod.cache_path() is None
    assert mod.store("dequant_bag", "int8", 1, 1, 1, 1, 1, 1.0) is None
    assert mod.lookup_cached("dequant_bag", "int8", 1, 1, 1) is None
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE")
    assert mod.cache_path() == os.path.join("results", "autotune.json")


def test_set_cache_path_points_the_process_at_a_file(tmp_path,
                                                     monkeypatch):
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE", raising=False)
    tat.set_cache_path(str(tmp_path / "c.json"))
    assert tat.cache_path() == str(tmp_path / "c.json")
    assert os.environ["REPRO_AUTOTUNE_CACHE"] == str(tmp_path / "c.json")
    tat.set_cache_path("")
    assert tat.cache_path() is None
    tat.set_cache_path(None)
    assert "REPRO_AUTOTUNE_CACHE" not in os.environ


@pytest.mark.parametrize("name", list(MODULES))
def test_reload_when_the_file_changes(cache, name):
    mod = MODULES[name]
    mod.store("dequant_bag", "int8", 64, 8, 64, 32, 16, 1.0)
    assert mod.lookup_cached("dequant_bag", "int8", 64, 8, 64) == (32, 16)
    # another process rewrites the file: picked up through its mtime
    doc = json.loads(cache.read_text())
    key = mod.cache_key("dequant_bag", "int8", 64, 8, 64)
    doc["entries"][key] = {"block_b": 64, "block_d": 32, "us": 0.5}
    cache.write_text(json.dumps(doc))
    st = os.stat(cache)
    os.utime(cache, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    assert mod.lookup_cached("dequant_bag", "int8", 64, 8, 64) == (64, 32)
    os.remove(cache)
    assert mod.lookup_cached("dequant_bag", "int8", 64, 8, 64) is None


@pytest.mark.parametrize("kernel,analytic,shape", [
    ("dequant_bag", db_kernel.dequant_bag_analytic(64, 8, 64),
     dict(b=64, k=8, d=64)),
    ("dequant_bag", db_kernel.dequant_bag_analytic(20000, 1, 64),
     dict(b=20000, k=1, d=64)),
    ("dequant_bag", db_kernel.dequant_bag_analytic(512, 39, 10),
     dict(b=512, k=39, d=10)),
    ("bag_grad", db_kernel.bag_grad_analytic(64), dict(d=64)),
    ("bag_grad", db_kernel.bag_grad_analytic(10), dict(d=10)),
    ("bag_matmul", bm_kernel.bag_matmul_analytic(512, 1024),
     dict(b=512, h=1024)),
    ("bag_matmul", bm_kernel.bag_matmul_analytic(512, 400),
     dict(b=512, h=400)),
    ("hashed_gather", hg_kernel.hashed_gather_analytic(4, 8),
     dict(num_chunks=4, z=8)),
    ("hashed_gather", hg_kernel.hashed_gather_analytic(2, 5),
     dict(num_chunks=2, z=5))])
def test_candidates_put_the_analytic_pick_first(kernel, analytic, shape):
    cands = tat.candidate_tilings(kernel, analytic, "cuda", **shape)
    assert cands[0] == tuple(analytic)
    assert len(cands) == len(set(cands)) and 2 <= len(cands) <= 12
    assert all(bb >= 1 and bd >= 1 for bb, bd in cands)
    if kernel == "bag_grad":
        assert all(db_kernel.bag_grad_tiling_ok(t, 4 if shape["d"] % 4 == 0
                                                else 2) for t in cands)
    if kernel == "hashed_gather":
        assert all(hg_kernel.hashed_gather_tiling_ok(t, **shape)
                   for t in cands)
    # the plain versions have no tiling: the analytic pick alone
    assert tat.candidate_tilings(kernel, analytic, "cpu", **shape) == [
        tuple(analytic)]


def test_the_analytic_mirrors_follow_the_kernels_rules():
    # dequant_bag: a row's columns in one group; 4 bags a group at K = 1
    # once the grid gives the 132 SMs two blocks each
    assert db_kernel.dequant_bag_analytic(13312, 1, 64) == (16, 64)
    assert db_kernel.dequant_bag_analytic(1703936, 1, 64) == (64, 64)
    assert db_kernel.dequant_bag_analytic(512, 40, 32) == (32, 32)
    assert db_kernel.dequant_bag_analytic(512, 39, 10) == (85, 12)
    assert db_kernel.bag_grad_analytic(64) == (1, 64)
    assert db_kernel.bag_grad_analytic(8) == (4, 8)
    assert bm_kernel.bag_matmul_analytic(512, 1024) == (32, 64)
    assert bm_kernel.bag_matmul_analytic(512, 400) == (32, 32)
    assert hg_kernel.hashed_gather_analytic(4, 8) == (64, 8)


def test_sweep_skips_a_failing_candidate_and_raises_when_all_fail():
    def run(bb, bd):
        if bb == 2:
            raise RuntimeError("not built")
        return lambda: sum(range(100 * bb))
    res = tat.sweep(run, [(1, 1), (2, 1), (3, 1)], iters=1, device="cpu")
    assert [r["us"] is None for r in res["sweep"]] == [False, True, False]
    assert res["best"] in ((1, 1), (3, 1))
    assert res["best_us"] == min(r["us"] for r in res["sweep"]
                                 if r["us"] is not None)
    with pytest.raises(RuntimeError, match="every candidate failed"):
        tat.sweep(lambda bb, bd: (_ for _ in ()).throw(ValueError()),
                  [(1, 1), (2, 2)], iters=1, device="cpu")
    # the reference's contract is the same
    res_j = jat.sweep(run, [(1, 1), (2, 1), (3, 1)], iters=1)
    assert [r["us"] is None for r in res_j["sweep"]] == [False, True,
                                                         False]


def test_resolve_tiling_argument_then_cache_then_analytic(cache):
    key = ("dequant_bag", "int8", 64, 8, 64)
    assert tat.resolve_tiling(*key) == (0, 0)
    tat.store(*key, 32, 16, 1.0)
    assert tat.resolve_tiling(*key) == (32, 16)
    assert tat.resolve_tiling(*key, tiling=(64, 64)) == (64, 64)
    # a hit the launch cannot take falls back to the analytic pick
    assert tat.resolve_tiling(*key, valid=lambda t: False) == (0, 0)
    with pytest.raises(ValueError):
        tat.resolve_tiling(*key, tiling=(-1, 0))


def _capture(monkeypatch, module, name):
    seen = []
    monkeypatch.setattr(module, name, lambda *a, **kw: seen.append(
        kw["tiling"]))
    return seen


def test_wrappers_resolve_argument_then_cache_then_analytic(cache,
                                                            monkeypatch):
    """The ops' dispatch off the CPU (a meta tensor stands in for a CUDA
    one, the dry run's meta branch patched away: ``tests/test_torch_
    dryrun.py`` holds that branch): the launch gets the explicit tiling,
    else the cache's, else (0, 0)."""
    from repro_torch.core import op_counter
    monkeypatch.setattr(op_counter, "on_meta", lambda t: False)
    meta = torch.device("meta")
    payload = torch.empty((100, 64), dtype=torch.int8, device=meta)
    idx = torch.empty((64, 8), dtype=torch.int32, device=meta)
    w = torch.empty((64, 8), device=meta)
    seen = _capture(monkeypatch, db_ops, "dequant_bag_cuda")
    db_ops.dequant_bag(payload, None, idx, w)
    tat.store("dequant_bag", "int8", 64, 8, 64, 32, 16, 1.0, device=meta)
    db_ops.dequant_bag(payload, None, idx, w)
    db_ops.dequant_bag(payload, None, idx, w, tiling=(16, 64))
    assert seen == [(0, 0), (32, 16), (16, 64)]

    w3 = torch.empty((8, 64, 32), device=meta)
    seen = _capture(monkeypatch, bm_ops, "bag_matmul_cuda")
    bm_ops.bag_matmul(payload, None, idx, w, w3)
    tat.store("bag_matmul", "int8", 64, 8, 64, 32, 32, 1.0,
              extra="|h=32", device=meta)
    bm_ops.bag_matmul(payload, None, idx, w, w3)
    assert seen == [(0, 0), (32, 32)]

    pool = torch.empty((1000, 8), device=meta)
    ids = torch.empty((64, 1), dtype=torch.int64, device=meta)
    seen = _capture(monkeypatch, hg_ops, "hashed_gather_ids_cuda")
    hg_ops.hashed_gather_ids(pool, None, ids, num_chunks=4, num_hashes=2)
    tat.store("hashed_gather", "float32", 64, 2, 8, 16, 4, 1.0,
              device=meta)
    hg_ops.hashed_gather_ids(pool, None, ids, num_chunks=4, num_hashes=2)
    # a cached bags-a-block beyond what C = 40 chunks allow is not taken
    hg_ops.hashed_gather_ids(pool, None, ids, num_chunks=40, num_hashes=2)
    assert seen == [(0, 0), (16, 4), (0, 0)]


def test_the_serve_cli_points_the_cache_at_its_file(tmp_path,
                                                    monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE", raising=False)
    path = str(tmp_path / "tuned.json")
    args = serve.parse_args(["--model", "smoke", "--requests", "2",
                             "--batch", "8", "--device", "cpu",
                             "--autotune-cache", path])
    serve.run(args)
    assert tat.cache_path() == path
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE")
