"""The SHARK pipeline over a device list (``launch.pipeline --device
cpu,cpu --mesh 2``), every stage from the placed train state, on the CPU.

The reference cannot train at mesh > 1 under the installed JAX
(``tests/test_pipeline.py::test_compressed_step_mesh2_equivalent``), so
the port's pipeline over two shards is held to its own mesh-1 run, and
mesh 1 to the JAX pipeline by ``tests/test_torch_pipeline.py``.  Both runs
start from the reference's initial train state.  The CPU has one device,
so two cards are stood in for by copies: ``dist.packed.shares_device`` is
made to answer False, so ``place_rows`` and ``shard_packed`` copy every
shard (no ``base``) as they do across cards.  A stage that wrote the
whole leaf instead of its shards would then leave the shards untouched,
and one that read the whole would show in the bound test, which records
the largest op output of each stage under a dispatch mode.  The cards
themselves: ``tests/test_torch_cuda.py::*over_devices*``.
"""

from __future__ import annotations

import contextlib
import io
import math

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro import configs as jconfigs
from repro.core.qat_store import FQuantConfig as JFQuantConfig
from repro.train.setup import build_recsys_training as jbuild
from repro_torch import configs as tconfigs
from repro_torch.convert import train_state_from_jax
from repro_torch.core import packed_store as tps
from repro_torch.core import qat_store as tqs
from repro_torch.core.tiers import TierConfig
from repro_torch.dist import make_mesh
from repro_torch.dist import packed as tdp
from repro_torch.launch import pipeline as tpipe
from repro_torch.obs import trace as ttrace
from repro_torch.store import hashed as H

SAME = ("train_losses", "finetune_losses", "gradcheck_max_abs_err",
        "tier_rows_int8", "tier_rows_half", "tier_rows_fp32", "bytes_packed",
        "eval_loss_fp32", "eval_loss_packed", "eval_auc_fp32",
        "eval_auc_packed", "retiers", "cache_hit_rate", "final_pack_digest")
RESUMED = ("tier_rows_int8", "tier_rows_half", "tier_rows_fp32",
           "bytes_packed", "eval_loss_fp32", "eval_loss_packed",
           "eval_auc_fp32", "eval_auc_packed", "final_pack_digest")
BATCH = 32


@pytest.fixture(scope="module")
def initial():
    """The reference pipeline's initial train state, on the host."""
    return jax.device_get(jbuild(jconfigs.get("dlrm-rm2"), batch=BATCH,
                                 fq_cfg=JFQuantConfig()).state)


def _cards(mp) -> None:
    """Two 'cards' on the CPU: every placement copies its shards."""
    mp.setattr(tdp, "shares_device", lambda mesh: False)


def run(initial, ckpt: str, devices: str, backend: str = "packed",
        resume: bool = False, audit=None) -> dict:
    """``launch.pipeline``'s CLI path (its parse and config) at the fast
    config and smoke size from ``initial``; the record."""
    argv = ["--model", "smoke", "--fast", "--batch", str(BATCH),
            "--device", devices, "--mesh", str(devices.count(",") + 1),
            "--store-backend", backend, "--ckpt-dir", ckpt]
    cfg = tpipe.config_from_args(tpipe.parse_args(
        argv + (["--resume"] if resume else [])))
    with contextlib.redirect_stdout(io.StringIO()):
        return tpipe.run_pipeline(cfg, state=train_state_from_jax(initial),
                                  audit=audit)


@pytest.fixture(scope="module")
def runs(initial, tmp_path_factory):
    """Mesh 1 and the cloned two-card run of each backend; the packed
    cloned run's served stores as its audit saw them."""
    tmp = tmp_path_factory.mktemp("pipeline_mesh")
    out, served = {}, []
    for backend in ("packed", "hashed"):
        out[backend, 1] = run(initial, str(tmp / f"{backend}1"), "cpu",
                              backend)
        with pytest.MonkeyPatch.context() as mp:
            _cards(mp)
            out[backend, 2] = run(
                initial, str(tmp / f"{backend}2"), "cpu,cpu", backend,
                audit=(lambda stage, store, g, e: served.append(store))
                if backend == "packed" else None)
    out["tmp"], out["served"] = tmp, served
    return out


@pytest.mark.parametrize("backend", ["packed", "hashed"])
def test_over_two_cards_equals_mesh1(runs, backend):
    """Every verify flag true over ``cpu,cpu``; the losses, the gradcheck's
    error, the tier rows, the bytes, the eval losses and AUCs, the
    re-tiers, the hit rate and the final served store (its digest) equal
    to mesh 1's; the record names both shards' devices."""
    one, two = runs[backend, 1], runs[backend, 2]
    assert tpipe.verify_failures(two) == tpipe.verify_failures(one) == []
    for k in SAME:
        assert two[k] == one[k], k
    assert two["mesh"] == 2 and two["devices"] == ["cpu", "cpu"]
    assert one["devices"] == ["cpu"] and two["reduced"] == []
    assert two["setup_peak_bytes_each"] == two["stage_peak_bytes_each"] == [0]
    assert two["device_peak_bytes_each"] == [0]
    assert two["max_memory_allocated_bytes"] is None
    if backend == "packed":
        # the serve stage read shards of their own, as on cards
        sharded = [s for s in runs["served"] if isinstance(s, tdp.ShardedPack)]
        assert sharded and all(s.base is None for s in sharded)


@pytest.mark.parametrize("direction", ["two_to_one", "one_to_two"])
def test_resume_onto_another_device_list(runs, initial, direction):
    """``--resume`` restores the other list's final train checkpoint onto
    its own mesh (elastic): no step runs, and the tier rows, bytes, eval
    figures and final store equal the run that wrote it."""
    two = direction == "two_to_one"
    src = runs["packed", 2 if two else 1]
    with pytest.MonkeyPatch.context() as mp:
        if not two:
            _cards(mp)
        got = run(initial, str(runs["tmp"] / f"packed{2 if two else 1}"),
                  "cpu" if two else "cpu,cpu", resume=True)
    assert got["train_losses"] == [] and tpipe.verify_failures(got) == []
    assert got["devices"] == (["cpu"] if two else ["cpu", "cpu"])
    assert got["finetune_losses"] == src["finetune_losses"]
    assert math.isfinite(got["train_loss_last"])
    for k in RESUMED:
        assert got[k] == src[k], k


class _StageLargest(TorchDispatchMode):
    """The most elements any op's output holds, by the pipeline stage
    whose timeblock is open (``pipeline.<stage>``; an unnamed block outside
    every stage is the eval's)."""

    def __init__(self):
        super().__init__()
        self.stack: list[str] = []
        self.numel: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.stack:
            top = self.stack[-1]
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    self.numel[top] = max(self.numel.get(top, 0), t.numel())
        return out


def _staged_timeblock(mode: _StageLargest):
    real = ttrace.timeblock

    class Staged:
        def __init__(self, name=None):
            self.tb = real(name)
            self.name = name or (mode.stack[-1] if mode.stack
                                 else "pipeline.eval")

        @property
        def seconds(self):
            return self.tb.seconds

        def start(self):
            mode.stack.append(self.name)
            self.tb.start()
            return self

        def stop(self):
            mode.stack.pop()
            return self.tb.stop()

        def __enter__(self):
            self.start()
            return self

        def __exit__(self, *exc):
            mode.stack.pop()
            return self.tb.__exit__(*exc)
    return Staged


@pytest.mark.parametrize("backend", ["packed", "hashed"])
def test_stages_hold_no_whole_table(runs, initial, monkeypatch, backend):
    """Over ``cpu,cpu`` with the row blocks (``CHUNK_ROWS``, the hashed
    fit's ``FIT_CHUNK_ROWS``) below the table's rows: no op output of the
    gradcheck, prune, fp32 and served eval, quantize, pack (the hashed fit
    included) or serve stage holds V x D elements or more, and the record
    still equals mesh 1's."""
    arch = tconfigs.get("dlrm-rm2")
    one = runs[backend, 1]
    v, d = one["rows"], arch.smoke_cfg.embed_dim
    block = v // 5 + 7
    for mod in (tqs, tps, tpipe):
        monkeypatch.setattr(mod, "CHUNK_ROWS", block)
    monkeypatch.setattr(H, "FIT_PLAN_SLOTS", 0)
    monkeypatch.setattr(H, "FIT_CHUNK_ROWS", block)
    _cards(monkeypatch)
    mode = _StageLargest()
    monkeypatch.setattr(tpipe, "timeblock", _staged_timeblock(mode))
    with mode:
        rec = run(initial, str(runs["tmp"] / f"bound_{backend}"), "cpu,cpu",
                  backend)
    stages = ("pipeline.gradcheck", "pipeline.prune", "pipeline.eval",
              "pipeline.quantize", "pipeline.pack", "pipeline.serve")
    assert set(stages) <= set(mode.numel), mode.numel
    for s in stages:
        assert mode.numel[s] < v * d, (s, mode.numel[s], v * d)
    for k in SAME:
        assert rec[k] == one[k], k
    if backend == "hashed":
        assert rec["fit_chunks"] == 5


def test_row_reads_of_a_placed_table():
    """``RowShards``' row block and row gather equal the whole tensor's,
    over views and over copies; a write goes through ``row_pieces``."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((24, 5), generator=g)
    mesh = make_mesh(4, device="cpu")
    views = tdp.place_rows(x, mesh)
    with pytest.MonkeyPatch.context() as mp:
        _cards(mp)
        copies = tdp.place_rows(x, mesh)
    assert views.base is not None and copies.base is None
    ids = torch.randint(0, 24, (7, 3), generator=g)
    for leaf in (views, copies):
        for r0, r1 in ((0, 24), (5, 17), (6, 12), (23, 24), (9, 9)):
            assert torch.equal(leaf[r0:r1], x[r0:r1])
        assert torch.equal(leaf[ids], x[ids])
        assert torch.equal(leaf[ids.to(torch.int32)], x[ids])
        with pytest.raises(IndexError):
            leaf.gather(torch.tensor([24]))
        with pytest.raises(TypeError):
            leaf[0:4:2]
        with pytest.raises(TypeError):
            leaf[ids > 3]
    for first, part in tdp.row_pieces(copies):
        part[0] = float(first)
    assert [float(copies[f:f + 1][0, 0]) for f in (0, 6, 12, 18)] == [
        0.0, 6.0, 12.0, 18.0]
    assert tdp.row_pieces(x) == [(0, x)]


def test_shard_packed_copies_every_window_across_cards():
    """Across cards every shard's windows are copies, shard 0's too, so no
    shard keeps the whole store alive; on one device they stay views."""
    g = torch.Generator().manual_seed(5)
    table = torch.randn((64, 8), generator=g) * 0.05
    pri = torch.rand(64, generator=g) * 100
    cfg = tqs.FQuantConfig(tiers=TierConfig(20.0, 60.0), stochastic=False)
    packed = tps.pack(tqs.QATStore(table, pri), cfg)
    mesh = make_mesh(2, device="cpu")

    def storages(sp):
        return {leaf.untyped_storage().data_ptr()
                for sh in sp.shards for leaf in list(sh)[:5]}
    whole_ptrs = {leaf.untyped_storage().data_ptr() for leaf in packed}
    views = tdp.shard_packed(packed, mesh)
    assert views.base is packed and storages(views) <= whole_ptrs
    with pytest.MonkeyPatch.context() as mp:
        _cards(mp)
        copies = tdp.shard_packed(packed, mesh)
    assert copies.base is None and not storages(copies) & whole_ptrs
    for a, b in zip(tdp.unshard_packed(copies), packed):
        assert torch.equal(a, b)
    ids = torch.randint(0, 64, (9, 3), generator=g)
    np.testing.assert_array_equal(
        tdp.sharded_lookup(copies, ids).numpy(),
        tps.lookup(packed, ids).numpy())
