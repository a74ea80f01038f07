"""The port's kernel record (``benchmarks/kernels.py`` -> ``bench_kernel/v1``)
and roofline (``benchmarks/roofline.py``) beside the reference's.

On the CPU the plain versions run: each sweep has the analytic pick as
its only candidate and the times are wall time (``interpret: true``), so
what is compared is the record's shape, its bytes models, the schema
tool's verdict, the roofline's kernel table over one file, and the
dry-run model's arithmetic with both modules' constants patched alike.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import pytest

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro_torch.benchmarks import kernels as tkernels
from repro_torch.benchmarks import roofline as troof

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import kernels as jkernels  # noqa: E402
from benchmarks import roofline as jroof  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "check_bench_schema", ROOT / "tools" / "check_bench_schema.py")
check_bench_schema = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(check_bench_schema)

SHAPE = (8, 3, 16, 8)


@pytest.fixture(scope="module")
def record(tmp_path_factory):
    path = tmp_path_factory.mktemp("rec") / "BENCH_kernel.json"
    rec = tkernels.main(["--shapes", "8:3:16:8", "--iters", "1",
                         "--device", "cpu", "--emit", str(path)])
    return rec, path


def test_record_passes_the_schema_tool(record):
    rec, path = record
    assert check_bench_schema.validate(rec) == []
    assert json.loads(path.read_text()) == json.loads(json.dumps(rec))
    assert rec["interpret"] is True and rec["backend"] == "cpu"
    assert rec["hbm_peak_gbs"] == 3350.0
    assert [e["kernel"] for e in rec["sweep"]] == [
        "dequant_bag_rowgrid", "dequant_bag", "bag_grad",
        "unfused_bag_matmul", "bag_matmul"]
    for e in rec["sweep"]:
        # one candidate a sweep on the CPU: measured is the analytic pick
        assert e["block_measured"] == e["block_analytic"]
        assert e["measured_us"] == e["analytic_us"] > 0


def test_bytes_moved_equal_the_reference_models(record):
    rec, _ = record
    b, k, d, h = SHAPE
    want = {"dequant_bag_rowgrid": jkernels._bytes_dequant(b, k, d, 1),
            "dequant_bag": jkernels._bytes_dequant(b, k, d, 1),
            "bag_grad": jkernels._bytes_bag_grad(b, k, d),
            "unfused_bag_matmul": jkernels._bytes_unfused(b, k, d, h, 1),
            "bag_matmul": jkernels._bytes_bag_matmul(b, k, d, h, 1)}
    assert {e["kernel"]: e["bytes_moved"] for e in rec["sweep"]} == want
    for e in rec["sweep"]:
        assert e["h"] == (h if "matmul" in e["kernel"] else 0)
    assert tkernels.VOCAB == jkernels.VOCAB
    assert tkernels.DEFAULT_SHAPES == jkernels.DEFAULT_SHAPES


def test_kernel_table_equals_the_reference_on_one_file(record):
    _, path = record
    assert troof.kernel_table(str(path)) == jroof.kernel_table(str(path))
    assert troof.kernel_markdown(str(path)).splitlines()[0] == \
        jroof.kernel_markdown(str(path)).splitlines()[0]
    with pytest.raises(ValueError, match="bench_kernel/v1"):
        bad = path.with_name("bad.json")
        bad.write_text('{"schema": "bench_qps/v1"}')
        troof.kernel_table(str(bad))


def test_dry_run_terms_equal_the_reference_with_constants_alike(
        monkeypatch, tmp_path):
    rec = {"arch": "qwen3-8b", "shape": "train_4k", "mesh": "single",
           "kind": "train", "num_devices": 4, "flops": 3.1e15,
           "hbm_bytes": 7.7e11, "collective_total": 2.2e10,
           "memory": {"peak_bytes": 3 * 2 ** 30}}
    for name, value in (("PEAK_FLOPS", 1e15), ("HBM_BW", 2e12)):
        monkeypatch.setattr(jroof, name, value)
        monkeypatch.setattr(troof, name, value)
    monkeypatch.setattr(jroof, "ICI_BW", 5e11)
    monkeypatch.setattr(troof, "NVLINK_BW", 5e11)
    assert troof.terms(rec) == jroof.terms(rec)
    rec2 = dict(rec, arch="dlrm-rm2", kind="serve", variant="optimized")
    assert troof.terms(rec2) == jroof.terms(rec2)
    # the dry-run path over a directory: one row, as the reference reads
    (tmp_path / "a.json").write_text(json.dumps(rec))
    assert troof.table("single", results=str(tmp_path)) == [
        troof.terms(rec)]
    assert "| qwen3-8b | train_4k |" in troof.markdown(
        "single", results=str(tmp_path))


def test_h100_constants_and_no_dry_run_records_yet():
    assert troof.PEAK_FLOPS == 989.4e12
    assert troof.HBM_BW == tkernels.HBM_BW == 3.35e12
    assert troof.NVLINK_BW == 900e9
    # no port module writes dry-run records yet: run() has no rows
    assert troof.load(str(ROOT / "results" / "no_such_dir")) == []


def test_seed_cache_writes_the_measured_pick(tmp_path, monkeypatch):
    from repro_torch.kernels import autotune
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "a.json"))
    rec = tkernels.run(shapes=(SHAPE,), iters=1, seed_cache=True,
                       device="cpu")
    assert rec["cache_path"] == str(tmp_path / "a.json")
    b, k, d, h = SHAPE
    for e in rec["sweep"]:
        extra = f"|h={h}" if e["kernel"] == "bag_matmul" else ""
        got = autotune.lookup_cached(e["kernel"], e["dtype"], b, k, d,
                                     extra=extra, device="cpu")
        if e["kernel"] in ("dequant_bag", "bag_grad", "bag_matmul"):
            assert got == tuple(e["block_measured"])
        else:
            assert got is None
