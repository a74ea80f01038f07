"""The dry run (``repro_torch.launch.{dryrun,op_analysis}``,
``configs.common.lowerable``) against the reference's
``repro.launch.{dryrun,hlo_analysis}`` and ``repro.configs``.

  * every (arch x shape) cell: the arguments' leaves (shape, dtype) and
    their specs equal the reference cell's, path by path; the leaves
    without a counterpart are listed (a train cell's ``rng`` key: the
    port's generic step draws from a generator, or on ``meta`` from
    ``core.rowwise_quant.meta_uniform``);
  * the op counter on the reference analyzer's cases (a plain dot, loops
    of matmuls): FLOPs exact, no collective bytes;
  * two cheap cells' records beside the reference dry run's records (one
    subprocess, 512 host devices): argument and output bytes equal;
    ``flops`` is 1/16 of the reference's, exactly: the port counts the
    global step and divides it by the 256 devices, the reference reads
    one device's partitioned program, in which the dense head runs on a
    batch sharded only over "data" (16) and replicated over "model" (16);
  * ``benchmarks/roofline.py`` reads the port's records into rows;
  * a kernel op on ``meta`` returns its output's shape and dtype and runs
    nothing (neither its plain version nor a launch).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import torch_threads

from repro import configs as rconfigs
from repro_torch import configs
from repro_torch.benchmarks import roofline
from repro_torch.dist import sharding as sh
from repro_torch.launch import dryrun, op_analysis
from repro_torch.launch.mesh import make_production_mesh

ROOT = Path(__file__).resolve().parents[1]
AXES = ("data", "model")
META = torch.device("meta")


def _cells() -> list[tuple[str, str]]:
    return [(n, s) for n in configs.names() for s in configs.get(n).cells()]


def _jax_key(k) -> str:
    for attr in ("key", "idx", "name"):
        v = getattr(k, attr, None)
        if v is not None:
            return str(v)
    raise TypeError(k)


def _jax_leaves(tree, is_leaf=None) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(_jax_key(k) for k in p): x for p, x in flat}


def _port_leaves(tree) -> dict:
    return {sh.pathstr(p): x for p, x in sh.tree_leaves_with_path(tree)
            if isinstance(x, (torch.Tensor, tuple))}


def test_every_arch_has_the_reference_cells():
    assert configs.names() == rconfigs.names()
    for name in configs.names():
        assert configs.get(name).cells() == rconfigs.get(name).cells()
        assert configs.get(name).ruleset == rconfigs.get(name).ruleset
    assert len(_cells()) == 37     # 17 LM + 16 recsys + 4 GNN


@pytest.mark.parametrize("name,shape", _cells())
def test_cell_args_and_specs_equal_the_reference(name, shape):
    cell = configs.get(name).lowerable(shape, AXES)
    ref = rconfigs.get(name).lowerable(shape, AXES)
    assert cell.kind == ref.kind and cell.donate == ref.donate
    p_args, r_args = _port_leaves(cell.args), _jax_leaves(ref.args)
    unmapped = {"0/rng"} if cell.kind == "train" else set()
    assert set(r_args) - set(p_args) == unmapped
    assert set(p_args) <= set(r_args)
    for path, leaf in p_args.items():
        assert leaf.device == META, path
        r = r_args[path]
        assert tuple(leaf.shape) == tuple(r.shape), path
        assert str(leaf.dtype).removeprefix("torch.") == \
            str(np.dtype(r.dtype)), path
    p_specs = _port_leaves(cell.in_specs)
    r_specs = _jax_leaves(ref.in_specs, is_leaf=lambda x: isinstance(x, JP))
    assert set(r_specs) - set(p_specs) == unmapped
    for path, spec in p_specs.items():
        assert tuple(spec) == tuple(r_specs[path]), path


# --------------------------------------------------------- the analyzer

def _meta(*shape):
    return torch.empty(shape, device=META)


def test_analyzer_plain_dot():
    stats, out = op_analysis.analyze(lambda a, b: a @ b, _meta(128, 256),
                                     _meta(256, 64))
    assert stats.flops == 2 * 128 * 256 * 64
    assert stats.collective_total() == 0
    assert stats.hbm_bytes == 128 * 64 * 4 and out.shape == (128, 64)


def test_analyzer_counts_loop_iterations():
    n, L = 64, 7

    def f(x):
        for _ in range(L):
            x = x @ torch.eye(n, device=x.device)
        return x

    stats, _ = op_analysis.analyze(f, _meta(n, n))
    assert stats.flops == L * 2 * n ** 3
    assert stats.unknown_trip_whiles == 0


def test_analyzer_nested_loops_multiply():
    n, L1, L2 = 32, 3, 5

    def f(x):
        for _ in range(L1):
            for _ in range(L2):
                x = torch.matmul(x, torch.eye(n, device=x.device))
        return x

    stats, _ = op_analysis.analyze(f, _meta(n, n))
    assert stats.flops == L1 * L2 * 2 * n ** 3


def test_analyzer_counts_backward_and_batched_products():
    a = _meta(4, 8, 16).requires_grad_()
    b = _meta(4, 16, 32)

    def f(a, b):
        return torch.autograd.grad(torch.bmm(a, b).sum(), a)[0]

    stats, g = op_analysis.analyze(f, a, b)
    # forward (4, 8, 32) x 16, backward d/da (4, 8, 16) x 32
    assert stats.flops == 2 * 4 * 8 * 32 * 16 + 2 * 4 * 8 * 16 * 32
    assert g.shape == a.shape


def test_analyzer_frees_temporaries():
    def f(x):
        for _ in range(4):
            y = x * 2.0 + 1.0       # each iteration's temporaries die
            x = torch.sort(y).values
        return x

    stats, _ = op_analysis.analyze(f, _meta(1024))
    # at most one iteration's x, y, sorted values and int64 indices live
    assert stats.peak_live_bytes == 1024 * (4 + 4 + 4 + 8)


# -------------------------------------------- records beside the reference

_REF_CELLS = (("dlrm-rm2", "serve_p99"), ("wide-deep", "serve_p99"))

_REF = """
import sys
import repro.launch.dryrun as d
from repro import configs
from repro.launch.mesh import make_production_mesh
mesh = make_production_mesh()
for name, shape in ((n.split(":")[0], n.split(":")[1]) for n in sys.argv[2:]):
    d.run_cell(configs.get(name), shape, mesh, "single", sys.argv[1])
print("REF_OK")
"""


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = torch_threads.subprocess_env()
    env["PYTHONPATH"] = "src"
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", _REF, str(tmp / "ref")]
                       + [f"{n}:{s}" for n, s in _REF_CELLS],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=600)
    assert "REF_OK" in r.stdout, r.stderr[-3000:]
    mesh = make_production_mesh()
    port = {}
    for name, shape in _REF_CELLS:
        port[name] = dryrun.run_cell(configs.get(name), shape, mesh,
                                     "single", str(tmp / "port"))
    return tmp, port


@pytest.mark.parametrize("name,shape", _REF_CELLS)
def test_record_beside_the_reference_dry_run(records, name, shape):
    tmp, port = records
    rec = port[name]
    path = tmp / "port" / f"{name}__{shape}__single.json"
    assert json.loads(path.read_text()) == json.loads(json.dumps(rec))
    ref = json.loads((tmp / "ref" / f"{name}__{shape}__single.json")
                     .read_text())
    for key in ("arch", "shape", "mesh", "variant", "kind", "num_devices"):
        assert rec[key] == ref[key], key
    assert rec["memory"]["argument_bytes"] == ref["memory"]["argument_bytes"]
    assert rec["memory"]["output_bytes"] == ref["memory"]["output_bytes"]
    assert ref["flops"] == 16 * rec["flops"]
    assert rec["collective_total"] == 0 and rec["unknown_trip_whiles"] == 0
    assert rec["kernel_calls"] == {"dequant_bag_tiered": 1}
    assert rec["memory"]["peak_bytes"] == (rec["memory"]["argument_bytes"]
                                           + rec["memory"]["temp_bytes"])


def test_roofline_reads_the_port_records(records, monkeypatch):
    tmp, port = records
    rows = roofline.table("single", results=str(tmp / "port"))
    assert {(r["arch"], r["shape"]) for r in rows} == set(_REF_CELLS)
    for r in rows:
        assert r["dominant"] in ("compute", "memory", "collective")
        assert r["collective_s"] == 0 and r["compute_s"] > 0
    assert "| dlrm-rm2 | serve_p99 |" in roofline.markdown(
        "single", results=str(tmp / "port"))
    monkeypatch.setattr(roofline, "RESULTS", str(tmp / "port"))
    assert [(r["arch"], r["shape"]) for r in roofline.run()] == sorted(
        _REF_CELLS)


def test_dryrun_cli_writes_records_and_counts_failures(tmp_path, capsys):
    assert dryrun.main(["--arch", "pna", "--shape", "molecule",
                        "--results", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "pna__molecule__single.json").read_text())
    assert rec["kind"] == "train" and rec["num_devices"] == 256
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "peak_bytes"}
    assert "[ok]   pna x molecule x single" in capsys.readouterr().out
    assert dryrun.main(["--arch", "dlrm-rm2", "--shape", "serve_p99",
                        "--mesh", "multi", "--variant", "optimized",
                        "--results", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "dlrm-rm2__serve_p99__multi__optimized"
                      ".json").read_text())
    assert rec["num_devices"] == 512 and rec["variant"] == "optimized"


@pytest.mark.parametrize("name", ["dlrm-rm2", "smollm-135m", "pna"])
def test_optimized_train_cells_trace(name, tmp_path):
    """The "optimized" variant: recsys' sparse-table step, the LMs' and
    PNA's sparse snap (PNA's full graph has no table: the plain step)."""
    shape = configs.get(name).cells()[0]
    if name == "pna":
        shape = "minibatch_lg"
    rec = dryrun.run_cell(configs.get(name), shape, make_production_mesh(),
                          "single", str(tmp_path), "optimized")
    assert rec["flops"] > 0 and rec["memory"]["argument_bytes"] > 0


# ------------------------------------------------------ kernel ops on meta

def _spy_plain_and_launch(monkeypatch):
    """Every kernel op's plain version and CUDA wrapper replaced by a
    function that fails the test if called."""
    from repro_torch.kernels.cin import ops as cin
    from repro_torch.kernels.dequant_bag import ops as db
    from repro_torch.kernels.rowwise_quant import ops as rq

    def boom(*a, **k):
        raise AssertionError("ran on meta")

    for mod, names in ((db, ("dequant_bag_ref", "bag_grad_ref",
                             "dequant_bag_cuda", "bag_grad_cuda",
                             "dequant_bag_tiered_cuda",
                             "packed_bag_lookup_tiers")),
                       (cin, ("cin_layer_ref", "cin_layer_cuda")),
                       (rq, ("quantize_rowwise_ref",
                             "quantize_rowwise_cuda"))):
        for n in names:
            monkeypatch.setattr(mod, n, boom)
    return db, cin, rq


def test_kernel_ops_on_meta_return_shapes_and_run_nothing(monkeypatch):
    from repro_torch import kernels
    from repro_torch.core.packed_store import PackedStore
    db, cin, rq = _spy_plain_and_launch(monkeypatch)
    before = kernels.launch_counts()
    ids = torch.empty((512, 26), dtype=torch.int32, device=META)
    w = _meta(512, 26)
    with op_analysis.OpCounter() as c:
        outs = {
            "dequant_bag": db.dequant_bag(
                torch.empty((1000, 64), dtype=torch.int8, device=META),
                _meta(1000), ids, w),
            "bag_grad": db.bag_grad(_meta(512, 64), None, ids, w, 1000),
            "dequant_bag_tiered": db.packed_bag_lookup(PackedStore(
                torch.empty((512, 64), dtype=torch.int8, device=META),
                _meta(512), torch.empty((512, 64), dtype=torch.bfloat16,
                                        device=META), _meta(512),
                _meta(512, 64), torch.empty((1536,), dtype=torch.int32,
                                            device=META)), ids),
            "cin": cin.cin_layer(_meta(200, 39, 39), _meta(512, 39, 10),
                                 _meta(512, 39, 10)),
        }
        q, s = rq.quantize_rowwise(_meta(1000, 256), reciprocal=True)
    want = {"dequant_bag": (512, 64), "bag_grad": (1000, 64),
            "dequant_bag_tiered": (512, 64), "cin": (512, 200, 10)}
    for name, out in outs.items():
        assert out.device == META and out.dtype == torch.float32, name
        assert tuple(out.shape) == want[name], name
        assert c.stats.kernel_calls[name] == 1, name
    assert q.dtype == torch.int8 and q.shape == (1000, 256)
    assert s.dtype == torch.float32 and s.shape == (1000, 1)
    assert c.stats.kernel_calls["rowwise_quant"] == 1
    # rowwise_quant's bound: 4 B read + 1 B written an element, 4 B a row;
    # cin's: 2 B O H M D operations
    assert c.stats.flops >= 2 * 512 * 200 * 39 * 39 * 10
    assert kernels.launch_counts() == before


def test_recsys_serve_cells_reach_the_tiered_kernel_on_meta(monkeypatch):
    _spy_plain_and_launch(monkeypatch)
    for name, calls in (("dlrm-rm2", {"dequant_bag_tiered": 1}),
                        ("xdeepfm", {"dequant_bag_tiered": 1, "cin": 3})):
        cell = configs.get(name).lowerable("serve_p99", AXES)
        stats, out = op_analysis.analyze(cell.fn, *cell.args)
        assert out.shape == (512,) and out.device == META
        assert dict(stats.kernel_calls) == calls


# --------------------------- the optimized recsys cell's sparse-table step

def _sparse_batch(jarch, rng) -> dict:
    spec = jarch.smoke_model.spec
    b = {"indices": rng.integers(0, min(spec.cardinalities),
                                 (8, spec.num_fields)).astype(np.int32),
         "labels": np.asarray([0., 1., 0., 1., 1., 0., 0., 1.],
                              np.float32)}
    if jarch.has_dense:
        b["dense"] = rng.standard_normal(
            (8, jarch.smoke_num_dense)).astype(np.float32)
    return b


@pytest.mark.parametrize("name", ["dlrm-rm2"])
def test_sparse_table_step_matches_the_reference(name):
    """Three steps of ``train.steps.make_sparse_table_train_step`` (the
    ``"optimized"`` train cell's) beside the reference's jitted one from
    the same params and batches: loss and grad norm within 1e-5,
    priorities 1e-6, the dense params and the adagrad accumulator 1e-4 of
    their largest magnitude; each table element within one int8 step of
    the reference's (the sparse snap rounds the same hashed noise, so a
    last-bit difference upstream can move one code)."""
    import jax.numpy as jnp

    from repro.train import steps as jsteps
    from repro_torch.convert import params_from_jax
    from repro_torch.optim import optimizers as topt
    from repro_torch.train import steps as tsteps
    jarch, tarch = rconfigs.get(name), configs.get(name)
    jm, tm = jarch.smoke_model, tarch.smoke_model
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.device_get(jp))
    jhook, thook = jarch._fquant_hook(jm, True), tarch._fquant_hook(tm, True)
    jstep = jsteps.make_sparse_table_train_step(
        jm.embed, jm.loss_from_emb, jhook.indices_fn, jhook.labels_fn,
        "embed_table", 0.05, fq_cfg=jhook.cfg)
    tstep = tsteps.make_sparse_table_train_step(
        tm.embed, tm.loss_from_emb, thook.indices_fn, thook.labels_fn,
        "embed_table", 0.05, fq_cfg=thook.cfg)
    js, ts = jstep.init_state(jp), tstep.init_state(tp)
    jit = jax.jit(jstep)
    rng = np.random.default_rng(3)
    for _ in range(3):
        nb = _sparse_batch(jarch, rng)
        js, jmet = jit(js, {k: jnp.asarray(v) for k, v in nb.items()})
        ts, tmet = tstep(ts, {k: torch.from_numpy(v) for k, v in nb.items()})
        for k in ("loss", "grad_norm"):
            assert abs(float(tmet[k]) - float(jmet[k])) <= 1e-5 * max(
                abs(float(jmet[k])), 1e-30), k
    assert int(ts.step) == int(js.step) == 3
    np.testing.assert_allclose(ts.priority.numpy(), np.asarray(js.priority),
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(ts.opt[1].numpy(), np.asarray(js.opt[1]),
                               rtol=1e-4, atol=1e-12)
    jnew = params_from_jax(jax.device_get(js.params))
    for k in (k for k in jnew if k != "embed_table"):
        for g, w in zip(topt.tree_leaves(ts.params[k]),
                        topt.tree_leaves(jnew[k])):
            top = float(w.abs().max())
            assert float((g - w).abs().max()) <= 1e-4 * max(top, 1e-6), k
    jt = jnew["embed_table"].double()
    tt = ts.params["embed_table"].double()
    step = jt.abs().amax(dim=1, keepdim=True) / 127.0
    assert bool(((tt - jt).abs() <= 1.01 * step + 1e-7).all())
