"""Each port paper-table ``run()`` at tiny budgets on the CPU beside the
reference's (``benchmarks/``, the JAX package's), shared by
``test_torch_paper_tables.py`` (Table 3, the frequency/error study) and
``test_torch_paper_runs.py`` (Table 2, Fig. 2, Fig. 3, Table 4), which
split the reference's jit compiles between two workers.

Both packages get the same tiny budgets, and the fixed inner budgets of
both (100 warm-up steps, a 200-step finetune, 150-step rankers) are
capped at 2 steps: the port's rows then carry the reference's keys and
method names in the reference's order, every AUC is finite and in
[0, 1], and the closed-form memory columns equal the reference's
expressions (``mpe_lfu``, ``alpt_int8``, the two uniform rows, Table 2's
passes; Table 4's F-Permutation share is one of the fields' table-byte
shares).  The values are not compared: they come from each package's own
random params and draws (``test_torch_paper_tables.py`` holds the
drivers to the reference's on the same inputs).
"""

from __future__ import annotations

import functools
import itertools
import pathlib
import sys

import numpy as np

from repro.core.baselines import mpe as jmpe
from repro.core.tiers import fp32_bytes as j_fp32_bytes

from repro_torch.benchmarks import common as tcommon
from repro_torch.benchmarks import fig2_fperm as tfig2
from repro_torch.benchmarks import fig3_thresholds as tfig3
from repro_torch.benchmarks import freq_error as tfreq
from repro_torch.benchmarks import table2_time as ttable2
from repro_torch.benchmarks import table3_fquant as ttable3
from repro_torch.benchmarks import table4_combined as ttable4

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import common as jcommon  # noqa: E402
from benchmarks import fig2_fperm as jfig2  # noqa: E402
from benchmarks import fig3_thresholds as jfig3  # noqa: E402
from benchmarks import freq_error as jfreq  # noqa: E402
from benchmarks import table2_time as jtable2  # noqa: E402
from benchmarks import table3_fquant as jtable3  # noqa: E402
from benchmarks import table4_combined as jtable4  # noqa: E402

CAP = 2
TINY = {
    "table2_time": (jtable2.run, ttable2.run,
                    dict(num_fields=6, eval_batches=1, shuffles=1)),
    "table3_fquant": (jtable3.run, ttable3.run, dict(train_steps=2)),
    "fig3_thresholds": (jfig3.run, tfig3.run,
                        dict(train_steps=2, t16_grid=(1e-1,),
                             t8_grid=(1e1,))),
    "table4_combined": (jtable4.run, ttable4.run,
                        dict(train_steps=2, keep=6)),
    "fig2_fperm": (jfig2.run, tfig2.run,
                   dict(train_steps=2, keep_counts=(6,), finetune_steps=2)),
    "freq_error": (jfreq.run, tfreq.run, dict(train_steps=2)),
}
NAME_KEY = {"table2_time": "method", "table3_fquant": "method",
            "fig3_thresholds": "sweep", "table4_combined": "method",
            "fig2_fperm": "method", "freq_error": "bucket"}


def _closed_form(name: str) -> dict:
    """The reference's memory expressions for the rows that have one."""
    spec = jcommon.make_setup(num_fields=10, important=5,
                              train_steps=0).model.spec
    v, d = spec.total_rows, spec.dim
    fp32 = j_fp32_bytes(v, d)
    if name == "table3_fquant":
        return {"fp32": 1.0,
                "mpe_lfu": round(float(jmpe.memory_bytes(
                    v, d, jmpe.MPEConfig(capacity=int(v * 0.18))) / fp32),
                    3),
                "alpt_int8": round(float((v * d + v * 4) / fp32), 3),
                "uniform_fp16_sr": 0.5, "uniform_int8_sr": 0.25}
    if name == "table2_time":
        return {"f_permutation": (3, 3), "permutation": (6 * 1 + 1, 1801)}
    return {}


def _capped(fn):
    def wrapped(setup, *args, steps=None, **kw):
        return fn(setup, *args, steps=min(steps or setup.train_steps, CAP),
                  **kw)
    return wrapped


def cap(monkeypatch) -> None:
    """Caps both packages' fixed inner budgets at ``CAP`` steps."""
    for mod in (jtable2, jtable3, jfig3, jtable4, jfig2, jfreq, ttable2,
                ttable3, tfig3, ttable4, tfig2, tfreq):
        for name in ("train_fp32", "train_fquant", "train_mpe",
                     "train_alpt"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, _capped(getattr(mod, name)))
    for mod in (jfig2, tfig2):
        for name in ("lasso", "gumbel"):
            monkeypatch.setitem(mod.METHODS, name, functools.partial(
                mod.METHODS[name], steps=CAP))


def check_run(name: str, monkeypatch) -> None:
    """The port's ``run()`` of job ``name`` against the reference's."""
    cap(monkeypatch)
    jrun, trun_, kw = TINY[name]
    want = jrun(**kw)
    got = trun_(**kw, device="cpu")
    assert [list(r) for r in got] == [list(r) for r in want]
    key = NAME_KEY[name]
    assert [r[key] for r in got] == [r[key] for r in want]
    for row in got:
        for k, v in row.items():
            if k in ("auc", "memory", "mean_int8_err"):
                assert np.isfinite(v), row
            if k == "auc":
                assert 0.0 <= v <= 1.0, row
    by = {r[key]: r for r in got}
    for method, val in _closed_form(name).items():
        if name == "table2_time":
            assert (by[method]["passes"],
                    by[method]["paper_scale_passes"]) == val
        else:
            assert by[method]["memory"] == val, (method, by[method])
    if name == "table2_time":
        assert by["speedup f_p vs permutation (measured)"][
            "paper_scale_passes"] == round(1801 / 3, 1)
    if name == "table4_combined":
        # F-P's memory is its surviving fields' share of the table bytes
        spec = tcommon.make_setup(num_fields=10, device="cpu").model.spec
        tb = np.asarray(spec.table_bytes(), float)
        shares = {round(float(tb[list(c)].sum() / tb.sum()), 3)
                  for c in itertools.combinations(range(10), 6)}
        assert by["f_permutation"]["memory"] in shares
