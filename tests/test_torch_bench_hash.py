"""The port's ``bench_hash/v1`` sweep and the runner's records against the
reference's ``benchmarks/hashed.py`` and ``benchmarks/manifest.py``.

``run_hashed_sweep`` at tiny budgets (ratios 4 and 100, 3 steps an arm,
40 requests by 8, one eval batch), each arm from the reference's params
and pools (``jax.random`` draws, carried across), gives the reference's
pool sizes, bytes and counters exactly, and its AUCs within 1e-3 (the
steps sum in other orders; here they agree to the printed digit).  Every
record written goes under ``tmp_path`` and passes the unchanged
``tools/check_bench_schema.py``.
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

from repro.store import hashed as JH
from repro_torch.benchmarks import hashed as thashed
from repro_torch.benchmarks import manifest as tmanifest
from repro_torch.benchmarks import run as trun
from repro_torch.convert import params_from_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import common as jcommon  # noqa: E402
from benchmarks import hashed as jhashed  # noqa: E402
from benchmarks import manifest as jmanifest  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "check_bench_schema", ROOT / "tools" / "check_bench_schema.py")
check_bench_schema = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(check_bench_schema)

TINY = dict(ratios=(4.0, 100.0), train_steps=3, requests=40,
            eval_batches=1)
EQUAL_KEYS = ("ratio_target", "pool_slots", "bytes", "bytes_combined",
              "ratio_actual", "lookups", "hits", "cache_hit_rate",
              "retiers")


def _reference_pool(hcfg) -> torch.Tensor:
    return torch.from_numpy(np.array(JH.init_hashed(
        JH.HashedConfig(**hcfg._asdict())).pool))


@pytest.fixture(scope="module")
def records():
    params = params_from_jax(jax.device_get(jcommon.make_setup(
        seed=0).params))
    trec = thashed.run_hashed_sweep(**TINY, params=params,
                                    init_pool=_reference_pool, device="cpu")
    return trec, jhashed.run_hashed_sweep(**TINY)


def test_sweep_matches_the_reference(records):
    trec, jrec = records
    for key, want in jrec.items():
        if key != "sweep":
            got = trec[key]
            if key == "auc_fp32":
                assert abs(got - want) <= 1e-3
            else:
                assert got == want, key
    assert len(trec["sweep"]) == len(jrec["sweep"]) == 2
    for te, je in zip(trec["sweep"], jrec["sweep"]):
        for key in EQUAL_KEYS:
            assert te[key] == je[key], (je["ratio_target"], key)
        for key in ("auc", "auc_combined", "auc_gap"):
            assert abs(te[key] - je[key]) <= 1e-3, key
        assert set(te) == set(je)
    assert trec["sweep"][0]["retiers"] == 1 and trec["sweep"][0]["hits"] > 0
    assert trec["device"] == "cpu"


def test_records_pass_the_schema_tool(records, tmp_path):
    trec, jrec = records
    assert check_bench_schema.validate(jrec) == []
    path = tmp_path / "BENCH_hash.json"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rec = thashed.main(["--ratios", "4,100", "--train-steps", "2",
                            "--requests", "8", "--device", "cpu", "--emit",
                            str(path)])
    written = json.loads(path.read_text())
    assert written == json.loads(json.dumps(rec))
    assert check_bench_schema.validate(written) == []
    assert json.loads(out.getvalue().splitlines()[0]) == written
    # without --emit nothing is written
    with contextlib.redirect_stdout(io.StringIO()):
        thashed.main(["--ratios", "4,100", "--train-steps", "1",
                      "--requests", "8", "--device", "cpu"])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["BENCH_hash.json"]


def test_manifest_matches_the_reference():
    assert set(tmanifest.COMMITTED_BENCH) == set(jmanifest.COMMITTED_BENCH)
    for name, (schema, command) in tmanifest.COMMITTED_BENCH.items():
        assert schema == jmanifest.COMMITTED_BENCH[name][0]
        assert command.startswith("python -m repro_torch.")
        assert command.endswith(f"--emit {name}")
        assert tmanifest.expected_schema(f"x/{name}") == schema
    assert tmanifest.expected_schema("BENCH_other.json") is None


def test_runner_emits_each_record_under_tmp_path(tmp_path, monkeypatch):
    """``--emit`` dispatches on the basename, as the reference; the
    hashed sweep runs at tiny budgets here."""
    monkeypatch.setattr(thashed, "sweep_budgets", lambda fast: dict(
        ratios=(4.0, 100.0), train_steps=2, requests=8, eval_batches=1))
    runs = {"BENCH_qps.json": ["--emit", str(tmp_path / "BENCH_qps.json")],
            "BENCH_hash.json": ["--emit",
                                str(tmp_path / "BENCH_hash.json")],
            "p.json": ["--emit-pipeline", str(tmp_path / "p.json")]}
    schemas = {"BENCH_qps.json": "bench_qps/v1",
               "BENCH_hash.json": "bench_hash/v1",
               "p.json": "bench_pipeline/v1"}
    for name, argv in runs.items():
        with contextlib.redirect_stdout(io.StringIO()):
            out = trun.main([*argv, "--fast", "--device", "cpu",
                             "--serve-batches", "1,8"])
        (res,) = out.values()
        written = json.loads((tmp_path / name).read_text())
        assert written == json.loads(json.dumps(res["record"]))
        assert written["schema"] == schemas[name]
        assert check_bench_schema.validate(written) == [], name
    assert [e["serve_batch"] for e in json.loads(
        (tmp_path / "BENCH_qps.json").read_text())["sweep"]] == [1, 8]
    assert sorted(p.name for p in tmp_path.iterdir() if p.is_file()) == (
        sorted(runs))
