"""The port's paper-table benchmarks against ``benchmarks/`` (the JAX
package's).

At 3-4 steps, on the reference's params carried across by ``convert.py``
and fed the reference's ``jax.random`` draws (each driver's key split
once a step, as the reference's jitted steps split it), the port's
training drivers give the reference's params within rtol 1e-4 / atol
1e-5 and its priorities and cache membership exactly; ``eval_auc``
agrees within 1e-6.  The LASSO and Gumbel rankers give the reference's
scores and order at 3 steps (up to fields whose scores tie).  The
runner refuses what is not ported, lets a job's exception propagate, and
needs a GPU unless the CPU is asked for.  Table 3's and the
frequency/error study's ``run()`` at tiny budgets are held to the
reference's rows here, the other four in ``test_torch_paper_runs.py``
(``torch_paper_tiny.py``).
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's CPU threads)

import torch_paper_tiny

from repro.core.baselines import alpt as jalpt
from repro.core.qat_store import FQuantConfig as JFQuantConfig
from repro.core.tiers import TierConfig as JTierConfig

from repro_torch.benchmarks import common as tcommon
from repro_torch.benchmarks import fig2_fperm as tfig2
from repro_torch.benchmarks import fig3_thresholds as tfig3
from repro_torch.benchmarks import freq_error as tfreq
from repro_torch.benchmarks import run as trun
from repro_torch.benchmarks import table2_time as ttable2
from repro_torch.benchmarks import table3_fquant as ttable3
from repro_torch.benchmarks import table4_combined as ttable4
from repro_torch.convert import alpt_state_from_jax, params_from_jax
from repro_torch.core.qat_store import FQuantConfig
from repro_torch.core.tiers import TierConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import common as jcommon  # noqa: E402
from benchmarks import fig2_fperm as jfig2  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "check_bench_schema", ROOT / "tools" / "check_bench_schema.py")
_check_schema = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_check_schema)

STEPS = 3


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(want, got, rtol=1e-4, atol=1e-5):
    if isinstance(want, dict):
        assert set(want) == set(got)
        for k in want:
            _assert_tree_close(want[k], got[k], rtol, atol)
        return
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _split_draws(seed: int, pieces: int = 1):
    """The reference drivers' draws as a port draw source: a step splits
    ``key``; with ``pieces`` 2 (ALPT) the step's key splits again into the
    two draws' keys; each call returns the next uniform (V, D)."""
    state = {"key": jax.random.PRNGKey(seed), "keys": []}

    def draw(shape):
        if not state["keys"]:
            state["key"], sub = jax.random.split(state["key"])
            state["keys"] = (list(jax.random.split(sub)) if pieces == 2
                             else [sub])
        k = state["keys"].pop(0)
        return torch.from_numpy(np.array(jax.random.uniform(
            k, shape, jnp.float32)))
    return draw


@pytest.fixture(scope="module")
def setups():
    """The bench DLRM in both packages; the reference's seed-1 params
    (every driver's default) carried across."""
    js = jcommon.make_setup(num_fields=10, important=5, train_steps=STEPS)
    ts = tcommon.make_setup(num_fields=10, important=5, train_steps=STEPS,
                            device="cpu",
                            params=params_from_jax(_host(js.params)))
    p1 = js.model.init(jax.random.PRNGKey(1))
    return js, ts, p1, params_from_jax(_host(p1))


def test_eval_auc_matches_reference(setups):
    js, ts, p1, tp1 = setups
    assert abs(tcommon.eval_auc(ts, ts.params)
               - jcommon.eval_auc(js, js.params)) <= 1e-6
    mask = np.array([1, 1, 0, 1, 1, 1, 0, 1, 1, 1], np.float32)
    assert abs(tcommon.eval_auc(ts, tp1, field_mask=torch.from_numpy(mask))
               - jcommon.eval_auc(js, p1, field_mask=jnp.asarray(mask))) \
        <= 1e-6


def test_train_fp32_matches_reference(setups):
    js, ts, p1, tp1 = setups
    mask = np.array([1, 0, 1, 1, 1, 1, 1, 0, 1, 1], np.float32)
    want = jcommon.train_fp32(js, field_mask=jnp.asarray(mask),
                              steps=STEPS)
    got = tcommon.train_fp32(ts, field_mask=torch.from_numpy(mask),
                             steps=STEPS, params=tp1)
    _assert_tree_close(_host(want), got)


@pytest.mark.parametrize("stochastic", [False, True], ids=["rtn", "sr"])
def test_train_fquant_matches_reference(setups, stochastic):
    """Untouched rows int8, touched rows half or fp32 (t8 0.5, t16 2)."""
    js, ts, p1, tp1 = setups
    jcfg = JFQuantConfig(tiers=JTierConfig(t8=0.5, t16=2.0),
                         stochastic=stochastic)
    tcfg = FQuantConfig(tiers=TierConfig(t8=0.5, t16=2.0),
                        stochastic=stochastic)
    wp, wpri = jcommon.train_fquant(js, jcfg, steps=STEPS)
    gp, gpri = tcommon.train_fquant(ts, tcfg, steps=STEPS, params=tp1,
                                    draw=_split_draws(1 + 99))
    np.testing.assert_array_equal(_np(gpri), np.asarray(wpri))
    _assert_tree_close(_host(wp), gp)


def test_train_mpe_matches_reference(setups):
    """Four steps: the cache refreshes on the fourth (refresh_every 4)."""
    js, ts, p1, tp1 = setups
    wp, wstate = jcommon.train_mpe(js, steps=4)
    gp, gstate = tcommon.train_mpe(ts, steps=4, params=tp1,
                                   draw=_split_draws(1 + 7))
    np.testing.assert_array_equal(_np(gstate.priority),
                                  np.asarray(wstate.priority))
    np.testing.assert_array_equal(_np(gstate.in_cache),
                                  np.asarray(wstate.in_cache))
    assert gstate.step == int(wstate.step) == 4
    _assert_tree_close(_host(wp), gp)


def test_train_alpt_matches_reference(setups):
    js, ts, p1, tp1 = setups
    spec = js.model.spec
    astate = jalpt.init(jax.random.PRNGKey(1 + 1), spec.total_rows,
                        spec.dim, jalpt.ALPTConfig(scale_lr=1e-4,
                                                   init_scale=1e-2))
    want = jcommon.train_alpt(js, steps=STEPS)
    got = tcommon.train_alpt(ts, steps=STEPS, params=tp1,
                             alpt_state=alpt_state_from_jax(_host(astate)),
                             draw=_split_draws(1 + 13, pieces=2))
    _assert_tree_close(_host(want), got)


def test_timed_warms_up_then_averages():
    calls = []

    def fn(x, y=0):
        calls.append(x)
        return x + y
    r, secs = tcommon.timed(fn, 2, repeats=4, y=1)
    assert r == 3 and len(calls) == 5 and secs >= 0.0


def _recording(monkeypatch, module, seen: list):
    """Record the scores each ranker's ``field_scores`` returns."""
    orig = module.field_scores

    def field_scores(x):
        out = orig(x)
        seen.append(_np(out))
        return out
    monkeypatch.setattr(module, "field_scores", field_scores)


def _assert_same_order(got, want, got_scores, want_scores):
    """Scores within rtol 1e-6, and the same order but for fields whose
    reference scores tie within that tolerance (at 3 steps the gates
    have moved by ~1e-3, so some norms agree to the last bit or two)."""
    np.testing.assert_allclose(got_scores, want_scores, rtol=1e-6)
    for a, b in zip(got, want):
        if a != b:
            assert abs(want_scores[a] - want_scores[b]) <= 1e-6 * abs(
                want_scores[b]), (got, want, want_scores)


def test_rank_lasso_and_gumbel_match_reference(setups, monkeypatch):
    js, ts, p1, tp1 = setups
    jseen, tseen = [], []
    _recording(monkeypatch, jfig2.lasso_lib, jseen)
    _recording(monkeypatch, tfig2.lasso_lib, tseen)
    _recording(monkeypatch, jfig2.gumbel_lib, jseen)
    _recording(monkeypatch, tfig2.gumbel_lib, tseen)
    want = jfig2.rank_lasso(js, p1, steps=STEPS)
    got = tfig2.rank_lasso(ts, tp1, steps=STEPS)
    _assert_same_order(got, want, tseen[-1], jseen[-1])

    key = {"k": jax.random.PRNGKey(0)}

    def masks(shape):
        key["k"], sub = jax.random.split(key["k"])
        return torch.from_numpy(np.array(jax.random.uniform(
            sub, shape, minval=1e-6, maxval=1 - 1e-6)))
    want = jfig2.rank_gumbel(js, p1, steps=STEPS)
    got = tfig2.rank_gumbel(ts, tp1, steps=STEPS, draw=masks)
    _assert_same_order(got, want, tseen[-1], jseen[-1])
    np.testing.assert_array_equal(tfig2.rank_random(ts, tp1),
                                  jfig2.rank_random(js, p1))


@pytest.mark.parametrize("name", ["table3_fquant", "freq_error"])
def test_run_at_tiny_budgets_gives_the_reference_rows(name, monkeypatch):
    """(``torch_paper_tiny.py`` says what is checked; Table 2, Fig. 2,
    Fig. 3 and Table 4 are in ``test_torch_paper_runs.py``.)"""
    torch_paper_tiny.check_run(name, monkeypatch)


# ------------------------------------------------------------------ runner

def test_runner_refuses_what_is_not_ported(tmp_path, capsys):
    """Nothing waits any more: ``--emit BENCH_kernel.json`` writes a valid
    record and ``--only roofline`` runs (no dry-run records: no rows).
    ``BENCH_fleet.json`` names its own command, as the reference's runner
    does, and an unknown record or job exits; a refused ``--emit`` writes
    nothing (the paths are under ``tmp_path``)."""
    assert trun.WAITING == {} and trun.EMIT_WAITING == {}
    path = tmp_path / "BENCH_kernel.json"
    out = trun.main(["--emit", str(path), "--fast", "--device", "cpu"])
    rec = json.loads(path.read_text())
    assert out["BENCH_kernel.json"]["record"]["schema"] == "bench_kernel/v1"
    assert _check_schema.validate(rec) == []
    assert rec["interpret"] is True
    path.unlink()
    capsys.readouterr()
    out = trun.main(["--only", "roofline", "--device", "cpu"])
    assert out["roofline"]["rows"] == []
    assert not capsys.readouterr().out.startswith("#")
    with pytest.raises(SystemExit,
                       match=r"python -m repro_torch\.launch\.fleet --emit"):
        trun.main(["--emit", str(tmp_path / "BENCH_fleet.json"),
                   "--device", "cpu"])
    with pytest.raises(SystemExit, match="manifest: BENCH_fleet.json"):
        trun.main(["--emit", str(tmp_path / "BENCH_other.json"),
                   "--device", "cpu"])
    with pytest.raises(SystemExit):
        trun.main(["--only", "nosuch", "--device", "cpu"])
    assert not any(tmp_path.iterdir())
    assert set(trun.jobs(True, torch.device("cpu"))) == {
        "table2_time", "table3_fquant", "fig3_thresholds",
        "table4_combined", "fig2_fperm", "freq_error", "qps", "qps_sharded",
        "hashed", "roofline"}


def test_runner_lets_a_job_exception_propagate(monkeypatch, capsys):
    def boom():
        raise ValueError("job failed")
    monkeypatch.setattr(trun, "jobs", lambda fast, device, audit=None: {
        "freq_error": lambda: [{"bucket": "x", "rows": 1}],
        "table2_time": boom})
    with pytest.raises(ValueError, match="job failed"):
        trun.main(["--fast", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    # nothing waits, so no "# not ported yet" line comes first
    assert not any(line.startswith("#") for line in out)
    assert out[0].startswith("freq_error,") and out[0].endswith(
        "bucket=x;rows=1")
    assert not any(line.startswith("table2_time") for line in out)


def test_runner_needs_a_gpu_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("the no-GPU rule is checked where there is no GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        trun.main(["--fast", "--only", "freq_error"])
    for run in (ttable2.run, ttable3.run, tfig3.run, ttable4.run, tfig2.run,
                tfreq.run):
        with pytest.raises(RuntimeError, match="CUDA"):
            run()
