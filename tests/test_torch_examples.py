"""The port's examples (``python -m repro_torch.examples.<name>``) run on
the CPU, each with its own arguments reduced to a few steps (at their
defaults they train 120-1,000 steps), and need a GPU unless the CPU is
asked for."""

from __future__ import annotations

import math

import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro_torch.examples import (compress_dlrm, quickstart,
                                  serve_quantized, train_lm)


def test_quickstart_runs_end_to_end(capsys):
    out = quickstart.main(["--steps", "12", "--finetune-steps", "3",
                           "--device", "cpu"])
    text = capsys.readouterr().out
    assert "planned thresholds" in text and "serving AUC" in text
    assert 0.0 < out["memory_ratio"] <= 1.0
    assert 0.0 <= out["serve_auc"] <= 1.0 and len(out["pruned"]) == 3
    assert out["packed_mib"] > 0


def test_compress_dlrm_runs_end_to_end(capsys):
    out = compress_dlrm.main(["--steps", "20", "--finetune-steps", "2",
                              "--fquant-steps", "6", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "Algorithm 1" in text and "combined (Table 4)" in text
    assert 0.0 < out["pruned_memory"] <= 1.0
    assert 0.0 < out["quant_ratio"] <= 1.0
    assert math.isclose(out["combined"],
                        out["quant_ratio"] * out["pruned_memory"])
    assert all(0.0 <= out[k] <= 1.0 for k in ("base_auc", "pruned_auc",
                                              "quant_auc"))


def test_serve_quantized_runs_end_to_end(capsys):
    out = serve_quantized.main(["--steps", "12", "--requests", "4",
                                "--device", "cpu"])
    text = capsys.readouterr().out
    assert "verified against serving path" in text
    assert 0.0 < out["packed_fp32_ratio"] < 1.0
    assert out["p50_us"] > 0 and 0.0 <= out["serve_auc"] <= 1.0


def test_train_lm_resumes_and_reports_tiers(capsys):
    out = train_lm.main(["--steps", "6", "--resume-demo", "--device",
                         "cpu"])
    text = capsys.readouterr().out
    assert "simulated preemption" in text and "token-embedding" in text
    assert out["resumed_from"] == 4 and out["steps_run"] == 2
    assert math.isfinite(out["loss_last"])
    assert 0.0 < out["memory_ratio"] <= 1.0


@pytest.mark.parametrize("mod", [quickstart, compress_dlrm, serve_quantized,
                                 train_lm],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_examples_need_a_gpu_unless_cpu_is_asked(mod):
    if torch.cuda.is_available():
        pytest.skip("the no-GPU rule is checked where there is no GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(["--steps", "2"])
