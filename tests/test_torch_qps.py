"""The port's ``bench_qps/v1`` benchmark against ``benchmarks/qps.py``.

With the reference's bench-DLRM params carried across by ``convert.py``,
the port's ``run_online_sweep`` at about 48 requests, serve batches
(1, 8) and a re-tier every 16 gives the reference's record in every
integer field, in ``packed_fp32_ratio`` and in the byte columns, and
both records pass the unchanged ``tools/check_bench_schema.py``.  The
offline proxy ``run`` gives the reference's byte rows (its priorities,
tiers and pack are the reference's: Eq. 7 is bit-equal).  The CLI writes
a valid record, refuses flag combinations it cannot run, and needs a GPU
unless the CPU is asked for.
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

from repro_torch.benchmarks import common as tcommon
from repro_torch.benchmarks import qps as tqps
from repro_torch.convert import params_from_jax
from repro_torch.core import packed_store as tps
from repro_torch.models import embedding as tE

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import common as jcommon  # noqa: E402
from benchmarks import qps as jqps  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "check_bench_schema", ROOT / "tools" / "check_bench_schema.py")
check_bench_schema = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(check_bench_schema)

SWEEP = dict(requests=48, retier_every=16)
INT_KEYS = ("serve_batch", "requests", "lookups", "hits", "retiers",
            "rows_moved", "swaps", "shadow_builds", "bytes_per_request_fp32",
            "bytes_per_request_packed")


def _jax_params() -> dict:
    setup = jcommon.make_setup(num_fields=10, important=5, train_steps=0)
    return params_from_jax(jax.tree.map(np.asarray, setup.params))


def test_make_setup_is_the_reference_bench_dlrm():
    jsetup = jcommon.make_setup(num_fields=10, important=5, train_steps=0)
    tsetup = tcommon.make_setup(num_fields=10, important=5, train_steps=0,
                                device="cpu")
    assert tsetup.model.spec == tE.FieldSpec(
        tuple(int(c) for c in jsetup.ds.cards), 16)
    assert tsetup.ds.cfg.num_dense == jsetup.ds.cfg.num_dense == 4
    jb, tb = jsetup.ds.batch(8, 3), tsetup.ds.batch(8, 3)
    for k in jb:
        np.testing.assert_array_equal(jb[k], tb[k])
    jshapes = jax.tree.map(np.shape, jsetup.params)
    tshapes = jax.tree.map(lambda t: tuple(t.shape), tsetup.params)
    assert jshapes == tshapes
    # the same seed gives the same params; the given ones are taken as is
    again = tcommon.make_setup(device="cpu")
    assert torch.equal(again.params["embed_table"],
                       tsetup.params["embed_table"])
    given = _jax_params()
    assert tcommon.make_setup(device="cpu", params=given).params is given


def test_run_online_sweep_matches_the_reference():
    jrec = jqps.run_online_sweep((1, 8), **SWEEP)
    trec = tqps.run_online_sweep((1, 8), **SWEEP, params=_jax_params(),
                                 device="cpu")
    assert check_bench_schema.validate(jrec) == []
    assert check_bench_schema.validate(trec) == []
    for key, want in jrec.items():
        if key != "sweep":
            assert trec[key] == want, key
    assert len(trec["sweep"]) == len(jrec["sweep"]) == 2
    for je, te in zip(jrec["sweep"], trec["sweep"]):
        for key in INT_KEYS:
            assert te[key] == je[key], (je["serve_batch"], key)
        assert te["cache_hit_rate"] == je["cache_hit_rate"]
    assert trec["sweep"][0]["retiers"] == 3
    assert trec["sweep"][0]["rows_moved"] > 0
    assert trec["device"] == "cpu"


def test_cli_writes_a_valid_record(tmp_path):
    path = tmp_path / "q.json"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rec = tqps.main(["--online", "--serve-batch", "1,4", "--requests",
                         "12", "--retier-every", "5", "--device", "cpu",
                         "--emit", str(path)])
    assert json.loads(path.read_text()) == json.loads(json.dumps(rec))
    printed = out.getvalue().strip().splitlines()
    assert json.loads(printed[-2]) == json.loads(json.dumps(rec))
    assert check_bench_schema.validate(rec) == []
    assert [e["serve_batch"] for e in rec["sweep"]] == [1, 4]
    assert len({e["bytes_per_request_packed"] for e in rec["sweep"]}) == 1
    assert all(e["retiers"] == 2 for e in rec["sweep"])
    with contextlib.redirect_stdout(io.StringIO()):
        one = tqps.main(["--online", "--requests", "3", "--batch", "16",
                         "--retier-every", "2", "--device", "cpu"])
    assert one["benchmark"] == "qps_online" and one["retiers"] == 1


def test_cli_refusals():
    with contextlib.redirect_stderr(io.StringIO()):
        with pytest.raises(SystemExit):
            tqps.parse_args(["--serve-batch", "1"])   # needs --online
        with pytest.raises(SystemExit):
            tqps.parse_args(["--online", "--emit", "x.json"])
    assert not tqps.parse_args([]).online             # the offline proxy
    # shadow re-tiers are ported: the async sweep runs
    rec = tqps.run_online_sweep((1,), requests=4, retier_every=2,
                                retier_async=True, device="cpu")
    assert rec["retier_async"] is True and rec["sweep"][0]["requests"] == 4
    if torch.cuda.is_available():
        pytest.skip("the no-GPU rule is checked where there is no GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        tqps.main(["--online", "--serve-batch", "1", "--requests", "2"])


OFFLINE_BYTE_ROWS = ("bytes_per_request_fp32", "bytes_per_request_packed",
                     "hbm_bytes_ratio (QPS headroom on bw-bound serving)",
                     "table_memory_ratio")


def test_offline_proxy_byte_rows_match_the_reference():
    want = {r["metric"]: r["value"] for r in jqps.run(iters=1)}
    seen = {}

    def audit(packed, gidx, emb):
        seen["equal"] = torch.equal(emb, tps.lookup(packed, gidx))
    rows = tqps.run(iters=1, device="cpu", audit=audit)
    got = {r["metric"]: r["value"] for r in rows}
    for key in OFFLINE_BYTE_ROWS:
        assert got[key] == want[key], key
    # the times are the device's, named for what they measure
    assert set(got) - set(OFFLINE_BYTE_ROWS) == {"forward_us_fp32",
                                                  "forward_us_packed"}
    assert all(got[k] > 0 for k in ("forward_us_fp32", "forward_us_packed"))
    assert seen["equal"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = tqps.main(["--batch", "64", "--device", "cpu"])
    assert [json.loads(ln)["metric"] for ln in out.getvalue().splitlines()
            ] == [r["metric"] for r in res["rows"]]
    assert res["rows"][0]["value"] == 64 * 10 * 16 * 4
