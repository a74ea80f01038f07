"""Rules of the port: what it imports and where it runs.

``repro_torch`` and ``chip_smoke.py`` import neither ``jax`` nor anything
of ``repro`` or of the top-level ``benchmarks`` package; entry points run on CUDA unless asked for the CPU, raise
when there is no GPU, and never carry on on the CPU by themselves.
"""

from __future__ import annotations

import ast
import os
from pathlib import Path

import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's CPU threads)

import repro_torch
from repro_torch.kernels import build
from repro_torch.launch import serve as tserve

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "scripts").glob("*.py"))


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    assert path.exists(), path
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "benchmarks"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


LOWER_LAYERS = ("core", "kernels", "dist", "optim", "models")


@pytest.mark.parametrize("layer", LOWER_LAYERS)
def test_lower_layers_import_no_entry_point(layer):
    """The kernels, ``dist``, ``optim``, ``core`` and the models reach the
    dry run's counter through ``core.op_counter``, never through
    ``repro_torch.launch``, the package of entry points."""
    for path in sorted((ROOT / "src" / "repro_torch" / layer).rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert not n.startswith("repro_torch.launch"), (
                    f"{path.relative_to(ROOT)} imports {n}")


def test_resolve_device_rule():
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("the no-GPU rule is checked where there is no GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.resolve_device("cuda")


def test_serve_raises_without_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("the no-GPU rule is checked where there is no GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.run(tserve.parse_args(["--model", "smoke", "--requests", "1"]))
    rec = tserve.run(tserve.parse_args(
        ["--model", "smoke", "--requests", "2", "--batch", "8",
         "--device", "cpu"])).record
    assert rec["kernel_launches"] == 0 and rec["device"] == "cpu"


def test_kernel_build_is_keyed_by_source_hash():
    for name in ("dequant_bag", "bag_grad", "bag_matmul", "cin",
                 "hashed_gather", "rowwise_quant", "dequant_bag_rowgrid",
                 "bag_grad_rowgrid"):
        path = build.library_path(name)
        assert path.parent == ROOT / "build" / "repro_torch"
        assert path.name.startswith(f"{name}-") and path.suffix == ".so"
        assert path == build.library_path(name)            # stable
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_training_modules_are_covered_by_the_import_rule():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("kernels/dequant_bag/autodiff.py", "core/metrics.py",
                "optim/optimizers.py", "train/steps.py", "train/loop.py",
                "train/setup.py", "train/accum.py", "ckpt/manager.py",
                "launch/train.py"):
        assert f"src/repro_torch/{mod}" in names, mod


def test_online_modules_are_covered_by_the_import_rule():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("kernels/bag_matmul/ref.py", "kernels/bag_matmul/kernel.py",
                "kernels/bag_matmul/ops.py", "kernels/cin/ref.py",
                "kernels/cin/kernel.py", "kernels/cin/ops.py",
                "serve/cache.py", "serve/online.py", "serve/loop.py",
                "store/api.py", "obs/registry.py", "configs/wide_deep.py",
                "configs/xdeepfm.py"):
        assert f"src/repro_torch/{mod}" in names, mod


def test_online_serve_raises_without_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("the no-GPU rule is checked where there is no GPU")
    for arch in ("wide-deep", "xdeepfm"):
        with pytest.raises(RuntimeError, match="CUDA"):
            tserve.run(tserve.parse_args(
                ["--arch", arch, "--online", "--fuse-matmul", "--model",
                 "smoke", "--requests", "1"]))


def test_hashed_modules_are_covered_by_the_import_rule():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("kernels/hashed_gather/ref.py",
                "kernels/hashed_gather/kernel.py",
                "kernels/hashed_gather/ops.py",
                "kernels/hashed_gather/autodiff.py",
                "kernels/rowwise_quant/ref.py",
                "kernels/rowwise_quant/kernel.py",
                "kernels/rowwise_quant/ops.py", "store/hashed.py",
                "store/api.py"):
        assert f"src/repro_torch/{mod}" in names, mod
    for src in ("hashed_gather.cu", "rowwise_quant.cu"):
        assert (ROOT / "src" / "repro_torch" / "csrc" / src).exists(), src


def test_pipeline_modules_are_covered_by_the_import_rule():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("core/taylor.py", "core/pruning.py", "obs/trace.py",
                "obs/__init__.py", "serve/loop.py", "store/api.py",
                "ckpt/manager.py", "launch/serve.py", "train/setup.py",
                "launch/pipeline.py", "kernels/dequant_bag/ref.py",
                "kernels/dequant_bag/kernel.py", "kernels/dequant_bag/ops.py",
                "models/embedding.py", "core/packed_store.py",
                "core/qat_store.py"):
        assert f"src/repro_torch/{mod}" in names, mod
    for src in ("dequant_bag_rowgrid.cu", "bag_grad_rowgrid.cu"):
        assert (ROOT / "src" / "repro_torch" / "csrc" / src).exists(), src


def test_obs_and_bench_modules_are_covered_by_the_import_rule():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("obs/__init__.py", "obs/registry.py", "obs/trace.py",
                "obs/export.py", "benchmarks/__init__.py",
                "benchmarks/common.py", "benchmarks/qps.py",
                "serve/online.py", "serve/loop.py", "train/loop.py",
                "launch/serve.py", "launch/pipeline.py", "store/api.py"):
        assert f"src/repro_torch/{mod}" in names, mod
    for test in ("test_torch_obs.py", "test_torch_qps.py"):
        assert ROOT / "tests" / test in PORT_TESTS, test


def test_shadow_modules_are_covered_by_the_import_rule():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("serve/shadow.py", "serve/online.py", "serve/loop.py",
                "core/packed_store.py", "store/api.py", "launch/serve.py",
                "benchmarks/qps.py"):
        assert f"src/repro_torch/{mod}" in names, mod
    assert ROOT / "tests" / "test_torch_shadow.py" in PORT_TESTS


def test_paper_table_modules_are_covered_by_the_import_rule():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("core/permutation.py", "core/baselines/__init__.py",
                "core/baselines/alpt.py", "core/baselines/gumbel.py",
                "core/baselines/lasso.py", "core/baselines/mpe.py",
                "core/baselines/uniform.py", "core/rowwise_quant.py",
                "core/qat_store.py", "optim/__init__.py",
                "optim/optimizers.py", "convert.py", "benchmarks/common.py",
                "benchmarks/table2_time.py", "benchmarks/fig2_fperm.py",
                "benchmarks/table3_fquant.py",
                "benchmarks/fig3_thresholds.py", "benchmarks/freq_error.py",
                "benchmarks/table4_combined.py", "benchmarks/run.py"):
        assert f"src/repro_torch/{mod}" in names, mod
    for test in ("test_torch_baselines.py", "test_torch_paper_tables.py",
                 "test_torch_paper_runs.py"):
        assert ROOT / "tests" / test in PORT_TESTS, test


def test_hashed_train_and_record_modules_are_covered_by_the_import_rule():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("benchmarks/hashed.py", "benchmarks/manifest.py",
                "benchmarks/qps.py", "benchmarks/run.py", "train/steps.py",
                "store/hashed.py", "launch/pipeline.py",
                "kernels/hashed_gather/autodiff.py"):
        assert f"src/repro_torch/{mod}" in names, mod
    for test in ("test_torch_hashed_train.py", "test_torch_bench_hash.py"):
        assert ROOT / "tests" / test in PORT_TESTS, test


def test_bench_qps_raises_without_cuda_unless_cpu_is_asked():
    from repro_torch.benchmarks import common
    if torch.cuda.is_available():
        pytest.skip("the no-GPU rule is checked where there is no GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        common.make_setup()
    assert common.make_setup(device="cpu").device == torch.device("cpu")
    from repro_torch.benchmarks import hashed, qps
    with pytest.raises(RuntimeError, match="CUDA"):
        hashed.run_hashed_sweep(ratios=(100.0,), train_steps=1, requests=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        qps.run(iters=1)


def test_pipeline_raises_without_cuda_unless_cpu_is_asked(tmp_path):
    from repro_torch.launch import pipeline
    if torch.cuda.is_available():
        pytest.skip("the no-GPU rule is checked where there is no GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.run_pipeline(pipeline.fast_config(ckpt_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.run(tserve.parse_args(
            ["--model", "smoke", "--online", "--serve-batch", "4",
             "--requests", "4"]))


PORT_TESTS = sorted((ROOT / "tests").glob("test_torch_*.py"))


@pytest.mark.parametrize("path", PORT_TESTS, ids=lambda p: p.name)
def test_port_tests_cap_torch_threads(path):
    """Every port test module imports ``torch_threads`` (torch's CPU
    threads capped to the cores an xdist worker gets), and one that starts
    a subprocess hands it ``torch_threads.subprocess_env()``."""
    roots = _imported_roots(path)
    assert "torch_threads" in roots, f"{path.name} does not import it"
    if "subprocess" in roots:
        assert "subprocess_env" in path.read_text(), path.name


def test_torch_threads_caps_to_the_workers_cores(monkeypatch):
    import importlib

    import torch_threads
    try:
        monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", "6")
        importlib.reload(torch_threads)
        want = max(1, (os.cpu_count() or 1) // 6)
        assert torch_threads.THREADS == want
        assert torch.get_num_threads() == want
        assert torch_threads.subprocess_env({})["OMP_NUM_THREADS"] == str(
            want)
    finally:
        monkeypatch.undo()
        importlib.reload(torch_threads)


def test_kernel_record_smoke_and_example_modules_are_covered():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("kernels/autotune.py", "kernels/bag_matmul/autodiff.py",
                "benchmarks/kernels.py", "benchmarks/roofline.py",
                "data/sequences.py", "configs/bert4rec.py",
                "configs/common.py", "models/layers.py", "models/recsys.py",
                "examples/__init__.py", "examples/common.py",
                "examples/quickstart.py", "examples/compress_dlrm.py",
                "examples/serve_quantized.py"):
        assert f"src/repro_torch/{mod}" in names, mod
    for test in ("test_torch_autotune.py", "test_torch_bench_kernel.py",
                 "test_torch_bag_matmul_train.py", "test_torch_bert4rec.py",
                 "test_torch_smoke.py", "test_torch_examples.py"):
        assert ROOT / "tests" / test in PORT_TESTS, test


def test_kernel_record_needs_a_gpu_unless_cpu_is_asked(tmp_path):
    from repro_torch.benchmarks import kernels
    if torch.cuda.is_available():
        pytest.skip("the no-GPU rule is checked where there is no GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        kernels.main(["--shapes", "8:2:8:4", "--emit",
                      str(tmp_path / "k.json")])
    assert not any(tmp_path.iterdir())


def test_serve_and_fleet_refuse_a_sequence_arch():
    from repro_torch.launch import fleet as tfleet
    with pytest.raises(SystemExit, match="field-based recsys"):
        tserve.run(tserve.parse_args(["--arch", "bert4rec", "--model",
                                      "smoke", "--device", "cpu"]))
    with pytest.raises(SystemExit, match="field-based recsys"):
        tfleet.run(tfleet.parse_args(["--arch", "bert4rec", "--model",
                                      "smoke", "--device", "cpu"]))


def test_gnn_and_lm_modules_are_covered_by_the_import_rule():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("models/layers.py", "models/gnn.py", "models/attention.py",
                "models/moe.py", "models/transformer.py", "data/graphs.py",
                "data/lm.py", "configs/common.py", "configs/pna.py",
                "configs/smollm_135m.py", "configs/qwen3_8b.py",
                "configs/deepseek_coder_33b.py", "configs/mixtral_8x22b.py",
                "configs/deepseek_v2_lite_16b.py", "launch/train.py",
                "examples/train_lm.py", "ckpt/manager.py"):
        assert f"src/repro_torch/{mod}" in names, mod
    for test in ("test_torch_gnn.py", "test_torch_attention.py",
                 "test_torch_transformer.py"):
        assert ROOT / "tests" / test in PORT_TESTS, test


@pytest.mark.parametrize("arch", ["pna", "smollm-135m",
                                  "deepseek-v2-lite-16b"])
def test_family_smoke_raises_without_cuda_unless_cpu_is_asked(arch):
    from repro_torch.launch import train as ttrain
    if torch.cuda.is_available():
        pytest.skip("the no-GPU rule is checked where there is no GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.run(ttrain.parse_args(["--arch", arch]))
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.run(ttrain.parse_args(["--arch", arch, "--smoke"]))
    rec = ttrain.run(ttrain.parse_args(["--arch", arch, "--device", "cpu"]))
    assert rec["finite"] is True and rec["arch"] == arch


def test_serve_and_fleet_refuse_the_gnn_and_lm_archs():
    from repro_torch.launch import fleet as tfleet
    for arch in ("pna", "qwen3-8b"):
        with pytest.raises(SystemExit, match="field-based recsys"):
            tserve.run(tserve.parse_args(["--arch", arch, "--model",
                                          "smoke", "--device", "cpu"]))
        with pytest.raises(SystemExit, match="field-based recsys"):
            tfleet.run(tfleet.parse_args(["--arch", arch, "--model",
                                          "smoke", "--device", "cpu"]))


def test_spmd_and_dryrun_modules_are_covered_by_the_import_rule():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("dist/ctx.py", "dist/sharding.py", "dist/collectives.py",
                "optim/grad_compress.py", "launch/mesh.py",
                "launch/dryrun.py", "launch/op_analysis.py",
                "core/op_counter.py"):
        assert f"src/repro_torch/{mod}" in names, mod
    for test in ("test_torch_sharding.py", "test_torch_collectives.py",
                 "test_torch_dryrun.py"):
        assert ROOT / "tests" / test in PORT_TESTS, test


def test_dryrun_allocates_no_device_memory_and_needs_no_gpu(tmp_path):
    """dlrm-rm2's train cell holds a 52.3 GB table and its 52.3 GB
    gradient at full width: traced on ``meta``, the process grows by far
    less, CUDA is never initialised, and every argument and output stays
    on ``meta``."""
    import resource

    from repro_torch.dist import sharding as sh
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    arch = repro_torch.configs.get("dlrm-rm2")
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    rec = dryrun.run_cell(arch, "train_batch", make_production_mesh(),
                          "single", str(tmp_path))
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    assert grown * 1024 < 1 << 30          # ru_maxrss is in KiB
    assert rec["memory"]["argument_bytes"] * 256 > 100e9
    assert not torch.cuda.is_initialized()
    cell = arch.lowerable("serve_p99")
    for _, leaf in sh.tree_leaves_with_path(cell.args):
        assert leaf.device.type == "meta"
    assert cell.fn(*cell.args).device.type == "meta"


def _dispatch_cases():
    """(module, op name, plain name, CUDA wrapper name, CPU arguments)."""
    from repro_torch.core.packed_store import PackedStore
    from repro_torch.kernels.bag_matmul import ops as bm
    from repro_torch.kernels.cin import ops as cin
    from repro_torch.kernels.dequant_bag import ops as db
    from repro_torch.kernels.hashed_gather import ops as hg
    from repro_torch.kernels.rowwise_quant import ops as rq
    ids = torch.zeros((4, 3), dtype=torch.int32)
    w = torch.ones((4, 3))
    store = PackedStore(torch.zeros((2, 8), dtype=torch.int8), torch.ones(2),
                        torch.zeros((2, 8), dtype=torch.bfloat16),
                        torch.ones(2), torch.zeros((2, 8)),
                        torch.zeros((6,), dtype=torch.int32))
    return [
        (db, "dequant_bag", "dequant_bag_ref", "dequant_bag_cuda",
         (torch.zeros((6, 8)), None, ids, w)),
        (db, "bag_grad", "bag_grad_ref", "bag_grad_cuda",
         (torch.zeros((4, 8)), None, ids, w, 6)),
        (db, "packed_bag_lookup", "packed_bag_lookup_tiers",
         "dequant_bag_tiered_cuda", (store, ids)),
        (bm, "bag_matmul", "bag_matmul_ref", "bag_matmul_cuda",
         (torch.zeros((6, 8)), None, ids, w, torch.zeros((3, 8, 5)))),
        (cin, "cin_layer", "cin_layer_ref", "cin_layer_cuda",
         (torch.zeros((5, 3, 3)), torch.zeros((4, 3, 8)),
          torch.zeros((4, 3, 8)))),
        (hg, "hashed_gather_ids", "hashed_gather_ids_ref",
         "hashed_gather_ids_cuda", (torch.zeros((16, 4)), None, ids)),
        (rq, "quantize_rowwise", "quantize_rowwise_ref",
         "quantize_rowwise_cuda", (torch.zeros((6, 256)),)),
    ]


def test_kernel_ops_dispatch_cpu_to_the_plain_version(monkeypatch):
    """A CPU tensor still takes the plain version, once, and never the
    CUDA wrapper (the CUDA side, the kernel or a raise, is held on the
    card by ``tests/test_torch_cuda.py``); the ``meta`` branch the dry run
    added sits beside these, not in their way."""
    for mod, op, plain, wrapper, args in _dispatch_cases():
        calls = []
        real = getattr(mod, plain)

        def spy(*a, _real=real, _calls=calls, **k):
            _calls.append(1)
            return _real(*a, **k)

        def never(*a, **k):
            raise AssertionError(f"{op} launched on the CPU")

        monkeypatch.setattr(mod, plain, spy)
        monkeypatch.setattr(mod, wrapper, never)
        kw = ({"num_chunks": 2, "num_hashes": 2}
              if op == "hashed_gather_ids" else {})
        getattr(mod, op)(*args, **kw)
        assert calls == [1], op
