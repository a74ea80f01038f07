"""The port's SHARK pipeline with ``--store-backend hashed`` against the
JAX package, on the CPU.

The reference test's fast config with the hashed serving store (a
ROBE-style pool fitted to the trained table at ratio 100, round-tripped
as a ``hashed_store/v1`` manifest), started from the reference's initial
state: integer fields, ratios and flags equal, losses within 1e-4 and
AUCs within 1e-3 (see ``test_torch_pipeline.py``).  The fitted pool's
AUC is the hashing scheme's own loss: it is compared, not bounded.
"""

from __future__ import annotations

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro.launch.pipeline import fast_config as jfast
from repro.launch.pipeline import run_pipeline as jrun
from repro_torch.convert import train_state_from_jax
from repro_torch.launch import pipeline as tpipe
from test_torch_pipeline import FAST, compare_records, initial_state


def test_run_pipeline_hashed_matches_jax(tmp_path):
    jrec = jrun(jfast(ckpt_dir=str(tmp_path / "jax"),
                      store_backend="hashed", **FAST))
    trec = tpipe.run_pipeline(
        tpipe.fast_config(ckpt_dir=str(tmp_path / "port"), device="cpu",
                          store_backend="hashed", **FAST),
        state=train_state_from_jax(initial_state(FAST["batch"])))
    print({k: (jrec[k], trec[k]) for k in jrec if k != "stage_seconds"})
    compare_records(jrec, trec)
    assert trec["store_backend"] == "hashed" and trec["retiers"] == 2
    assert trec["compression_ratio"] == 0.01
    assert set(trec["kernel_launches"]["pack"].values()) == {0}
