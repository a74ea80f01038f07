"""The port's SHARK pipeline against the JAX package, on the CPU.

``run_pipeline`` at the reference test's fast config
(``tests/test_pipeline.py::test_run_pipeline_fast_record_valid``), started
from the reference's initial train state (``convert.train_state_from_jax``),
gives a ``bench_pipeline/v1`` record whose integer fields, ratios and
flags equal the reference's, and whose losses and AUCs are within 1e-4
(losses) and 1e-3 (AUCs) of it: the training steps agree to fp32
rounding (``tests/test_torch_train.py``), and the record rounds to 5
decimals.  The compact gradcheck gives the (V, D) form's error exactly.
A ``packed_store/v1`` manifest round-trips between the two packages'
checkpoint managers bit for bit.  Both runs have their package's metrics
registry on (as ``--metrics-out`` turns it on): the port records every
histogram the reference records, with the same counts, and the same
serve counters and store gauges; its ``--metrics-out`` stream validates.
The hashed branch is in ``test_torch_pipeline_hashed.py``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro import configs as jconfigs
from repro import obs as jobs
from repro.ckpt.manager import CheckpointManager as JManager
from repro.core import packed_store as jps
from repro.core.qat_store import FQuantConfig as JFQuantConfig
from repro.launch.pipeline import fast_config as jfast
from repro.launch.pipeline import run_pipeline as jrun
from repro.serve.loop import SERVE_PHASES as JSERVE_PHASES
from repro.train.setup import build_recsys_training as jbuild
from repro_torch import configs as tconfigs
from repro_torch import obs as tobs
from repro_torch.ckpt.manager import CheckpointManager as TManager
from repro_torch.convert import train_state_from_jax
from repro_torch.core import packed_store as tps
from repro_torch.core import qat_store as tqs
from repro_torch.launch import pipeline as tpipe
from repro_torch.store.api import from_manifest
from repro_torch.train.setup import build_recsys_training as tbuild

ROOT = os.path.join(os.path.dirname(__file__), "..")
FAST = dict(steps=8, batch=16, ckpt_every=4, finetune_steps=2,
            serve_requests=12, retier_every=6, eval_batches=2)
EXACT = ("schema", "benchmark", "arch", "mesh", "train_steps", "batch",
         "fields_total", "fields_pruned", "kept_memory_fraction",
         "tier_rows_int8", "tier_rows_half", "tier_rows_fp32", "bytes_fp32",
         "bytes_packed", "compression_ratio", "serve_requests",
         "serve_batch", "cache_hit_rate", "retiers",
         "verify_pack_bit_identical", "verify_serve_bit_identical",
         "verify_grad_fp32_tolerance", "verify_accum_checkpointed",
         "store_backend")


def check_schema(rec: dict) -> list:
    path = os.path.join(ROOT, "tools", "check_bench_schema.py")
    spec = importlib.util.spec_from_file_location("check_bench_schema", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.validate(rec)


def initial_state(batch: int):
    """The reference pipeline's initial train state, on the host."""
    return jax.device_get(jbuild(jconfigs.get("dlrm-rm2"), batch=batch,
                                 fq_cfg=JFQuantConfig()).state)


def compare_records(jrec: dict, trec: dict) -> None:
    for key in EXACT:
        assert trec[key] == jrec[key], key
    for key in ("train_loss_first", "train_loss_last", "eval_loss_fp32",
                "eval_loss_packed"):
        assert abs(trec[key] - jrec[key]) <= 1e-4, key
    for key in ("eval_auc_fp32", "eval_auc_packed"):
        assert abs(trec[key] - jrec[key]) <= 1e-3, key
    assert abs(trec["gradcheck_max_abs_err"]
               - jrec["gradcheck_max_abs_err"]) <= 1e-6
    assert tpipe.verify_failures(trec) == []
    assert check_schema(trec) == []
    assert set(trec["stage_seconds"]) >= set(jrec["stage_seconds"])


def _with_metrics(obs, run):
    """``run()`` with ``obs``'s default registry on and the serving span
    catalog pre-registered, as the drivers' ``--metrics-out`` does; the
    result and the registry's snapshot, the registry left off and empty.
    The registry is emptied first too: a test of another file that ran
    earlier in this process may have left observations in it."""
    obs.get_registry().reset()
    obs.enable()
    obs.ensure_histograms(f"{p}_us" for p in JSERVE_PHASES)
    try:
        return run(), obs.snapshot()
    finally:
        obs.disable()
        obs.get_registry().reset()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference and the port at ``FAST`` from the reference's initial
    state, each with its metrics on."""
    tmp = tmp_path_factory.mktemp("pipeline")
    jrec, jsnap = _with_metrics(jobs, lambda: jrun(
        jfast(ckpt_dir=str(tmp / "jax"), **FAST)))
    trec, tsnap = _with_metrics(tobs, lambda: tpipe.run_pipeline(
        tpipe.fast_config(ckpt_dir=str(tmp / "port"), device="cpu", **FAST),
        state=train_state_from_jax(initial_state(FAST["batch"]))))
    return {"tmp": tmp, "jrec": jrec, "trec": trec, "jsnap": jsnap,
            "tsnap": tsnap}


def test_run_pipeline_matches_jax(runs):
    jrec, trec, tmp_path = runs["jrec"], runs["trec"], runs["tmp"]
    print({k: (jrec[k], trec[k]) for k in jrec if k != "stage_seconds"})
    compare_records(jrec, trec)
    assert trec["fields_pruned"] > 0 and trec["retiers"] == 2
    assert len(trec["train_losses"]) == 8 and len(trec["finetune_losses"]) == 2
    for stage in ("train", "gradcheck", "finetune", "pack", "eval", "serve"):
        assert set(trec["kernel_launches"][stage].values()) == {0}, stage
    # the train checkpoints carry the accumulator, in the reference's
    # format: the reference's manager restores the port's newest one
    assert TManager(str(tmp_path / "port" / "train")).latest_step() == 8
    writes = trec["checkpoints"]["train"]
    assert [w["step"] for w in writes] == [4, 8] and writes[0]["bytes"] > 0
    jstate = initial_state(FAST["batch"])
    restored, step = JManager(str(tmp_path / "port" / "train")).restore(
        jstate._replace(params=None, opt=None, priority=None, rng=None))
    assert step == 8 and float(restored.accum.count) == 8 * 16


def test_pipeline_metrics_match_jax(runs):
    js, ts = runs["jsnap"], runs["tsnap"]
    assert check_schema(ts) == []
    jh, th = js["histograms"], ts["histograms"]
    assert set(th) >= set(jh)
    for name, h in jh.items():
        assert th[name]["count"] == h["count"], name
    for stage in runs["trec"]["stage_seconds"]:
        assert th[f"pipeline.{stage}_us"]["count"] == 1, stage
    assert th["train.step_us"]["count"] == FAST["steps"]
    assert ts["counters"]["train.steps"] == js["counters"]["train.steps"] == 8
    for name in ("serve.requests", "serve.lookups", "serve.cache.hits",
                 "serve.retier.rows_moved"):
        assert ts["counters"][name] == js["counters"][name], name
    assert ts["counters"]["serve.requests"] == FAST["serve_requests"]
    for name, v in js["gauges"].items():
        if name.startswith(("store.", "serve.cache.")):
            assert ts["gauges"][name] == v, name
    assert ts["ticks"] == js["ticks"]


def test_pipeline_cli_metrics_out_validates(tmp_path, runs):
    path = tmp_path / "m.jsonl"
    with contextlib.redirect_stdout(io.StringIO()):
        rec = tpipe.main(["--model", "smoke", "--device", "cpu", "--fast",
                          "--steps", "4", "--serve-requests", "16",
                          "--ckpt-dir", str(tmp_path / "ck"),
                          "--metrics-out", str(path), "--metrics-every",
                          "3"])
    try:
        lines = [json.loads(ln) for ln in path.read_text().splitlines()]
        micro = -(-16 // rec["serve_batch"])
        # a line every 3 ticks (4 steps + 2 micro-batches), then the flush
        assert len(lines) == 3 and lines[-1]["ticks"] == 4 + micro
        assert all(check_schema(r) == [] for r in lines)
        last = lines[-1]
        assert set(last["histograms"]) >= set(runs["jsnap"]["histograms"])
        assert last["counters"]["train.steps"] == 4
        assert last["counters"]["serve.requests"] == 16
        for stage in rec["stage_seconds"]:
            assert last["histograms"][f"pipeline.{stage}_us"]["count"] == 1
    finally:
        tobs.disable()
        tobs.get_registry().reset()


@pytest.mark.parametrize("backend", ["packed", "hashed"])
def test_audit_sees_the_served_lookups(tmp_path, backend):
    from repro_torch.kernels.hashed_gather import ref as hg_ref
    from repro_torch.kernels.hashed_gather.ops import slot_plan

    seen = []

    def audit(stage, store, gidx, emb):
        if isinstance(store, tps.PackedStore):
            plain = tps.lookup(store, gidx)
        else:
            hcfg = store.hcfg
            slots, coeff = slot_plan(
                gidx.reshape(-1, 1), None, num_chunks=hcfg.num_chunks,
                num_hashes=hcfg.num_hashes, num_slots=hcfg.num_slots,
                seed=hcfg.seed)
            plain = hg_ref.hashed_gather_ref(
                store.hs.pool, store.hs.pool_scale, slots, coeff,
                num_chunks=hcfg.num_chunks).reshape(*gidx.shape, -1)
        assert torch.equal(emb, plain), stage
        seen.append((stage, tuple(gidx.shape)))

    cfg = tpipe.fast_config(ckpt_dir=str(tmp_path), device="cpu",
                            store_backend=backend,
                            **dict(FAST, steps=4, serve_requests=32,
                                   retier_every=12))
    rec = tpipe.run_pipeline(cfg, audit=audit)
    assert tpipe.verify_failures(rec) == [] and rec["retiers"] == 2
    fields = rec["fields_total"]
    # the first eval batch, then the 32 / 8 = 4 micro-batches less the
    # second and third, which re-tiered (at requests 12 and 24)
    assert seen == [("eval", (cfg.batch, fields))] + 2 * [
        ("serve", (cfg.serve_batch, fields))]


def test_compact_gradcheck_equals_the_full_form():
    setup = tbuild(tconfigs.get("dlrm-rm2"), batch=8, device=torch.device(
        "cpu"), model="smoke")
    params = setup.state.params
    b = setup.batch_fn(1_000_003)
    gidx = setup.indices_fn(b)
    compact = tpipe.gradcheck(setup.model, params, params["embed_table"],
                              gidx, b, compact=True)
    full = tpipe.gradcheck(setup.model, params, params["embed_table"], gidx,
                           b, compact=False)
    assert compact == full and compact[1] > 0


def test_packed_manifest_round_trips_between_the_packages(tmp_path):
    rng = np.random.default_rng(0)
    v, d = 300, 8
    table = (rng.standard_normal((v, d)) * 0.1).astype(np.float32)
    pri = (rng.pareto(1.2, v) * 10).astype(np.float32)
    cfg = tqs.FQuantConfig(tiers=tqs.TierConfig(t8=5.0, t16=30.0),
                           stochastic=False)
    store = tqs.QATStore(torch.from_numpy(table), torch.from_numpy(pri))
    store = store._replace(table=tqs.snap(store.table,
                                          tqs.current_tiers(store, cfg), cfg))
    packed = tps.pack(store, cfg)
    # packing in blocks of 7 rows gives the leaves of one block
    chunked = tps._fill_chunked(lambda r0, r1: store.table[r0:r1],
                                tqs.current_tiers(store, cfg), d, cfg, 7,
                                snap_rows=False)
    assert tpipe._bits_equal(chunked, packed)
    manifest = {"kind": "packed_store/v1", "packed": packed,
                "priority": store.priority}
    TManager(str(tmp_path / "port"), keep=1).save(3, manifest)
    # the reference's manager restores it into its own pytree
    def zeros_like(x: torch.Tensor):
        dt = (jnp.bfloat16 if x.dtype == torch.bfloat16
              else str(x.dtype).removeprefix("torch."))
        return np.asarray(jnp.zeros(tuple(x.shape), dt))

    jtemplate = {"kind": "packed_store/v1",
                 "packed": jps.PackedStore(*map(zeros_like, packed)),
                 "priority": np.zeros(v, np.float32)}
    jtree, _ = JManager(str(tmp_path / "port")).restore(jtemplate)
    assert jtree["kind"] == "packed_store/v1"
    for name, x in zip(tps.PackedStore._fields, packed):
        want = x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
        got = np.asarray(getattr(jtree["packed"], name))
        got = got.view(np.int16) if got.dtype.kind == "V" else got
        np.testing.assert_array_equal(got, want, err_msg=name)
    # and back: the reference's save restores in the port, and the kind
    # tag picks the packed backend
    JManager(str(tmp_path / "jax"), keep=1).save(3, jtree)
    ttree, _ = TManager(str(tmp_path / "jax")).restore(manifest)
    backend = from_manifest(ttree, store=store, cfg=cfg)
    assert backend.kind == "packed" and ttree["kind"] == "packed_store/v1"
    assert tpipe._bits_equal(backend.host_packed, packed)
    assert tpipe._bits_equal(backend.snapshot_manifest(), manifest)
    np.testing.assert_array_equal(backend.gather_fp32_host([0, 5, 299]),
                                  tps.lookup(packed, torch.tensor(
                                      [0, 5, 299])).numpy())
    # without the training store, the table is the unpacked pack
    alone = from_manifest(ttree)
    assert tpipe._bits_equal(alone.store.table, tps.unpack(packed))


def test_pipeline_cli_on_cpu_and_the_gpu_rule(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rec = tpipe.main(["--model", "smoke", "--device", "cpu", "--fast",
                          "--steps", "4", "--serve-requests", "8",
                          "--ckpt-dir", str(tmp_path)])
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    assert last == json.loads(json.dumps(rec))
    assert last["device"] == "cpu" and last["train_steps"] == 4
    assert last["model"] == "smoke" and last["reduced"] == []
    assert check_schema(last) == []
    cfg = tpipe.config_from_args(tpipe.parse_args(["--batch", "65536"]))
    assert (cfg.model, cfg.max_ind_range, cfg.batch) == ("full", 24_000_000,
                                                         65536)
    # --mesh runs now (tests/test_torch_mesh_serve.py); rows that do not
    # divide the mesh are refused, as the reference's setup refuses them
    with pytest.raises(SystemExit, match="not divisible"):
        tpipe.run_pipeline(tpipe.fast_config(mesh=7, device="cpu",
                                             model="smoke",
                                             ckpt_dir=str(tmp_path)))
    if torch.cuda.is_available():
        pytest.skip("the no-GPU rule is checked where there is no GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.main(["--model", "smoke", "--fast", "--ckpt-dir",
                    str(tmp_path)])
