"""The port's fleet CLI (``repro_torch.launch.fleet``) against
``repro.launch.fleet``, on the CPU.

``--model smoke --device cpu --replicas 1,2 --requests 32`` beside the
reference CLI with the same arguments, both from the reference's start
(``model.init(PRNGKey(0))``, pareto priorities, the 50% plan, the snap;
the port's through ``run(state=)``): the record's keys, integer fields
and divergences are equal, and every micro-batch's logits are within
``1e-4 * max(1, |ref|)`` (the GEMMs and the Gram interaction sum in other
orders).  The port's own start gives the same counters and divergences
(they depend on the priorities and the traffic, not the weights), and its
``--metrics-out`` streams and ``--emit`` record pass the schema tool,
with the per-source streams re-merging to the fleet stream.  The byte
count refuses a dlrm-rm2 fleet at full width above one replica on an
80 GB card before anything is built, and the CLI raises without a
GPU unless asked for the CPU.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's CPU threads)

import repro.serve as jserve
from repro import configs as jconfigs
from repro import obs as jobs
from repro.core import qat_store as jqs
from repro.core.tiers import plan_thresholds_for_ratio
from repro.launch import fleet as jfleet_cli
from repro_torch import configs as tconfigs
from repro_torch import obs as tobs
from repro_torch.convert import params_from_jax, qat_store_from_jax
from repro_torch.core import qat_store as tqs
from repro_torch.launch import fleet as tfleet

ARGV = ["--replicas", "1,2", "--requests", "32"]
TOL = 1e-4

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


def _reference_state():
    """The reference CLI's start at smoke size (dlrm-rm2)."""
    model = jconfigs.get("dlrm-rm2").smoke_model
    spec = model.spec
    params = model.init(jax.random.PRNGKey(0))
    pri = jnp.asarray((np.random.default_rng(0).pareto(1.2, spec.total_rows)
                       * 10).astype(np.float32))
    cfg = jqs.FQuantConfig(tiers=plan_thresholds_for_ratio(pri, spec.dim,
                                                           0.5),
                           stochastic=False)
    store = jqs.QATStore(params["embed_table"], pri)
    store = store._replace(table=jqs.snap(
        store.table, jqs.current_tiers(store, cfg), cfg))
    return params, store, cfg


@pytest.fixture(scope="module")
def runs():
    """The reference CLI's record and logits, and the port's from the
    reference's start."""
    jouts: list = []
    base = jserve.Replica

    class Spy(base):
        def __init__(self, rid, server, serve_fn, *a, **kw):
            def fn(mb):
                out = serve_fn(mb)
                jouts.append((rid, np.asarray(out)))
                return out
            super().__init__(rid, server, fn, *a, **kw)

    out, old = io.StringIO(), sys.argv
    sys.argv = ["fleet", *ARGV]
    jserve.Replica = Spy
    try:
        with contextlib.redirect_stdout(out):
            jfleet_cli.main()
    finally:
        sys.argv = old
        jserve.Replica = base
        _clean()
    jrec = json.loads(out.getvalue().strip().splitlines()[-1])

    params, store, cfg = _reference_state()
    tparams = params_from_jax(jax.tree.map(np.asarray, params))
    tparams.pop("embed_table")
    state = (tparams, qat_store_from_jax(store),
             tqs.FQuantConfig(tiers=cfg.tiers, stochastic=False))
    touts: list = []

    def after_batch(rep, mb, served):
        touts.append((rep.rid, served["logits"].numpy().copy()))

    with contextlib.redirect_stdout(io.StringIO()):
        trec = tfleet.run(tfleet.parse_args(
            ARGV + ["--model", "smoke", "--device", "cpu"]), state=state,
            after_batch=after_batch)
    return {"jrec": jrec, "trec": trec, "jouts": jouts, "touts": touts}


def _same_counts(rec, jrec):
    assert set(rec) == set(jrec)
    for key, want in jrec.items():
        if key != "sweep":
            assert rec[key] == want, key
    assert len(rec["sweep"]) == len(jrec["sweep"]) == 2
    for got, want in zip(rec["sweep"], jrec["sweep"]):
        assert set(got) == set(want)
        for key in ("replicas", "policy", "requests", "merges",
                    "divergence", "divergence_premerge", "swaps_colocated"):
            assert got[key] == want[key], key
        assert len(got["per_replica_qps"]) == got["replicas"]


def test_record_equals_the_reference_clis(runs):
    _same_counts(runs["trec"], runs["jrec"])
    sweep = runs["trec"]["sweep"]
    assert [e["replicas"] for e in sweep] == [1, 2]
    assert sweep[1]["merges"] == 1 and sweep[1]["divergence"] == 0.0
    assert sweep[1]["divergence_premerge"] > 0.0
    assert not check_bench_schema.validate(
        json.loads(json.dumps(runs["trec"])))


def test_logits_match_the_reference_clis(runs):
    jouts, touts = runs["jouts"], runs["touts"]
    assert len(touts) == len(jouts) == 8     # 4 batches an entry
    for (jr, want), (tr, got) in zip(jouts, touts):
        assert tr == jr
        want = want.astype(np.float64)
        got = got.astype(np.float64)
        assert want.shape == got.shape == (8,)
        assert np.all(np.abs(got - want)
                      <= TOL * np.maximum(1.0, np.abs(want)))


def test_cli_streams_and_emit(runs, tmp_path):
    """The port's own start: the same counters and divergences; every
    stream validates and the per-source streams re-merge to the fleet
    stream's line; ``--emit`` writes the printed record."""
    mdir, emit = tmp_path / "m", tmp_path / "BENCH_fleet.json"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rec = tfleet.main(ARGV + ["--model", "smoke", "--device", "cpu",
                                  "--metrics-out", str(mdir),
                                  "--emit", str(emit)])
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == rec
    assert json.loads(emit.read_text()) == rec
    assert not check_bench_schema.validate(rec)
    _same_counts(rec, runs["jrec"])
    names = sorted(p.name for p in mdir.iterdir())
    assert names == sorted(
        ["replicas1_replica0.jsonl", "replicas1_router.jsonl",
         "replicas1_fleet.jsonl", "replicas2_replica0.jsonl",
         "replicas2_replica1.jsonl", "replicas2_router.jsonl",
         "replicas2_fleet.jsonl"])
    for n in (1, 2):
        srcs = [tobs.last_snapshot(str(mdir / f"replicas{n}_replica{i}"
                                       ".jsonl")) for i in range(n)]
        srcs.append(tobs.last_snapshot(str(mdir / f"replicas{n}_router"
                                           ".jsonl")))
        fleet = tobs.last_snapshot(str(mdir / f"replicas{n}_fleet.jsonl"))
        assert tobs.merge_snapshots(srcs) == fleet
        for snap in srcs + [fleet]:
            assert not check_bench_schema.validate(snap)
        assert fleet["counters"]["serve.requests"] == 32
        assert fleet["counters"]["router.requests"] == 32


def test_byte_count_refuses_a_full_dlrm_fleet(monkeypatch):
    spec = tconfigs.get("dlrm-rm2").model.spec
    card = 85_045_149_696                 # an H100 80GB HBM3's memory
    assert tfleet.fleet_bytes(spec, 1) <= card < tfleet.fleet_bytes(spec, 2)
    wd = tconfigs.get("wide-deep").model.spec
    assert tfleet.fleet_bytes(wd, 8) < card / 4

    def never(*a, **kw):
        raise AssertionError("built before the byte count")
    monkeypatch.setattr(tfleet, "device_bytes", lambda device: card)
    monkeypatch.setattr(tfleet, "online_store", never)
    with pytest.raises(SystemExit, match="2 replicas need"):
        tfleet.run(tfleet.parse_args(
            ["--model", "full", "--replicas", "1,2", "--device", "cpu"]))
    with pytest.raises(SystemExit):
        tfleet.parse_args(["--replicas", "0,1"])
    with pytest.raises(SystemExit):
        tfleet.parse_args(["--replicas", ","])


def test_cli_raises_without_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("the no-GPU rule is checked where there is no GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        tfleet.run(tfleet.parse_args(["--replicas", "1", "--requests", "1"]))
