"""The SPMD layer's rules (``repro_torch.dist.{ctx,sharding}``,
``launch.mesh``) against the reference's ``repro.dist``.

The reference's own cases (``tests/test_sharding_hlo.py``) on the port;
every arch's full-width param tree on ``meta`` against the reference's
``eval_shape`` tree, path by path, under each ruleset; ZeRO-1 specs and
the divisibility check on a logical 16 x 16 mesh; ``ctx.resolve`` /
``spec`` on a grid of logical entries.  Tolerance: none (specs, shapes
and dtypes are equal).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro import configs as rconfigs
from repro.dist import ctx as rctx
from repro.dist import sharding as rsh
from repro_torch import configs
from repro_torch.dist import ctx, sharding as sh
from repro_torch.dist.ctx import PartitionSpec as P
from repro_torch.launch import mesh as tmesh

RULESETS = ("lm", "lm_ep", "recsys", "gnn")
META = torch.device("meta")


def _m(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


@pytest.fixture(autouse=True)
def _unconfigured():
    yield
    ctx.unconfigure()
    rctx.unconfigure()


# ---------------------------------------------- the reference's own cases

def test_lm_param_rules():
    params = {"embed": _m(512, 64),
              "layers": {"attn": {"wq": {"w": _m(8, 64, 64)}}},
              "final_norm": {"g": _m(64)}}
    specs = sh.param_specs(params, "lm")
    assert specs["embed"] == P("model", "data")
    assert specs["layers"]["attn"]["wq"]["w"] == P(None, "data", "model")
    assert specs["final_norm"]["g"] == P()


def test_recsys_rules_row_shard_tables_only():
    params = {"embed_table": _m(1024, 16), "wide_table": _m(1024, 1),
              "net": {"deep": {"l0": {"w": _m(128, 64)}}}}
    specs = sh.param_specs(params, "recsys")
    assert specs["embed_table"] == P("model", None)
    assert specs["wide_table"] == P("model", None)
    assert specs["net"]["deep"]["l0"]["w"] == P()


def test_ep_rules_shard_experts():
    params = {"layers": {"moe": {"gate": _m(8, 64, 64, 32)}}}
    specs = sh.param_specs(params, "lm_ep")
    assert specs["layers"]["moe"]["gate"] == P(None, "model", "data", None)


def test_zero1_specs_add_data_axis():
    z = sh.zero1_specs({"w": P("model", None)}, {"w": _m(64, 32)},
                       data_size=16)
    assert z["w"] == P("model", "data")


def test_validate_divisibility_flags_bad_dims():
    mesh = tmesh.LogicalMesh((1, 1), ("data", "model"))
    assert sh.validate_divisibility({"w": _m(7, 3)}, {"w": P("data", None)},
                                    mesh) == []


def test_unknown_ruleset_raises():
    with pytest.raises(KeyError, match="unknown ruleset"):
        sh.param_specs({"w": _m(4, 4)}, "tp")


# ------------------------------------- every arch's tree, path by path

def _jax_key(k) -> str:
    for attr in ("key", "idx", "name"):
        v = getattr(k, attr, None)
        if v is not None:
            return str(v)
    raise TypeError(k)


def _jax_leaves(tree, is_leaf=None) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(_jax_key(k) for k in path): leaf for path, leaf in flat}


def _port_leaves(tree) -> dict:
    return {sh.pathstr(path): leaf
            for path, leaf in sh.tree_leaves_with_path(tree)}


def _dtype(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.dtype(x.dtype))


def _trees() -> list[tuple[str, str]]:
    out = []
    for name in configs.names():
        arch = configs.get(name)
        if arch.family == "gnn":
            out += [(name, shape) for shape in arch.cells()]
        else:
            out.append((name, ""))
    return out


@functools.cache
def _param_trees(name: str, shape: str):
    """(the port's full-width params on meta, the reference's
    eval_shape params) of one arch (a GNN cell's config)."""
    arch, ref = configs.get(name), rconfigs.get(name)
    key = jax.random.PRNGKey(0)
    if arch.family == "lm":
        from repro.models import transformer as RT
        from repro_torch.models import transformer as T
        return (T.init_params(None, arch.lm_cfg, META),
                jax.eval_shape(lambda k: RT.init_params(k, ref.lm_cfg), key))
    if arch.family == "gnn":
        from repro.models import gnn as RG
        from repro_torch.models import gnn as G
        rcfg = ref._cfg(shape)
        return (G.init_params(None, arch._cfg(shape), META),
                jax.eval_shape(lambda k: RG.init_params(k, rcfg), key))
    return arch.model.init(None, META), jax.eval_shape(ref.model.init, key)


@pytest.mark.parametrize("ruleset", RULESETS)
@pytest.mark.parametrize("name,shape", _trees())
def test_param_specs_equal_the_reference_on_every_arch(name, shape,
                                                       ruleset):
    """The port's full-width params (meta) and the reference's (eval_shape)
    have the same paths, shapes and dtypes, and ``param_specs`` gives each
    path the reference's spec."""
    port, ref = _param_trees(name, shape)
    p_leaves, r_leaves = _port_leaves(port), _jax_leaves(ref)
    assert sorted(p_leaves) == sorted(r_leaves)
    for path, leaf in p_leaves.items():
        assert tuple(leaf.shape) == tuple(r_leaves[path].shape), path
        assert _dtype(leaf) == _dtype(r_leaves[path]), path
    axes = ("data", "model")
    p_specs = _port_leaves(sh.param_specs(port, ruleset, axes))
    r_specs = _jax_leaves(rsh.param_specs(ref, ruleset, axes),
                          is_leaf=lambda x: isinstance(x, JP))
    assert sorted(p_specs) == sorted(r_specs)
    for path, spec in p_specs.items():
        assert tuple(spec) == tuple(r_specs[path]), path


@pytest.mark.parametrize("name", ["smollm-135m", "deepseek-v2-lite-16b",
                                  "dlrm-rm2"])
def test_zero1_and_divisibility_equal_the_reference_on_16x16(name):
    """ZeRO-1 specs and the divisibility report on a logical 16 x 16 mesh
    equal the reference's (each arch's ruleset divides on it: both
    reports are empty; the next test has the non-dividing case)."""
    port, ref = _param_trees(name, "")
    ruleset = configs.get(name).ruleset
    mesh = tmesh.make_production_mesh()
    p_spec = sh.param_specs(port, ruleset, mesh.axis_names)
    r_spec = rsh.param_specs(ref, ruleset, mesh.axis_names)
    p_z = _port_leaves(sh.zero1_specs(p_spec, port, 16))
    r_z = _jax_leaves(rsh.zero1_specs(r_spec, ref, 16),
                      is_leaf=lambda x: isinstance(x, JP))
    assert {k: tuple(v) for k, v in p_z.items()} == \
        {k: tuple(v) for k, v in r_z.items()}
    assert sh.validate_divisibility(port, p_spec, mesh) == \
        rsh.validate_divisibility(ref, r_spec, mesh)


def test_validate_divisibility_reports_a_non_dividing_dim():
    mesh = tmesh.make_production_mesh()
    params = {"ok": _m(32, 64), "bad": _m(24, 10)}
    specs = {"ok": P("model", "data"), "bad": P(None, ("data", "model"))}
    got = sh.validate_divisibility(params, specs, mesh)
    want = rsh.validate_divisibility(
        {"ok": jax.ShapeDtypeStruct((32, 64), jnp.float32),
         "bad": jax.ShapeDtypeStruct((24, 10), jnp.float32)},
        {"ok": JP("model", "data"), "bad": JP(None, ("data", "model"))},
        mesh)
    assert got == want and len(got) == 1
    assert "bad: dim 1 of shape (24, 10)" in got[0]


def test_shard_shape_divides_and_rounds_up():
    shape = {"data": 16, "model": 16}
    assert sh.shard_shape((512, 26), P("data", None), shape) == (32, 26)
    assert sh.shard_shape((24, 10), P(None, ("data", "model")),
                          shape) == (24, 1)
    assert sh.shard_shape((5,), P(), shape) == (5,)


# --------------------------------------------------------------- meshes

def test_production_meshes_are_the_reference_shapes():
    single = tmesh.make_production_mesh()
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.axis_names == ("pod", "data", "model")
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512


def test_elastic_and_host_meshes_count_the_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 512)
    m = tmesh.make_elastic_mesh()
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tmesh.make_elastic_mesh().shape == {"data": 1, "model": 4}
    assert tmesh.make_elastic_mesh(model_parallel=1).shape == {
        "data": 4, "model": 1}
    assert tmesh.make_host_mesh(2).shape == {"data": 2, "model": 2}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert tmesh.make_elastic_mesh(model_parallel=1).size == 1


# ------------------------------------------------------------------- ctx

def _ref_entry(e):
    return ctx.UNC if e is JP.UNCONSTRAINED else e


@pytest.mark.parametrize("multi", [False, True])
def test_resolve_and_spec_equal_the_reference(multi):
    mesh = tmesh.make_production_mesh(multi_pod=multi)
    batch = ("pod", "data") if multi else "data"
    ctx.configure(mesh, batch=batch, tp="model")
    rctx.configure(mesh, batch=batch, tp="model")
    entries = ["batch", "tp", "model", "data", "pod", None, ctx.UNC]
    ref_of = {id(ctx.UNC): rctx.UNC}
    for e in entries:
        r_e = ref_of.get(id(e), e)
        for dim in (None, 1, 7, 16, 32, 48, 256, 512):
            assert ctx.resolve(e, dim) == _ref_entry(rctx.resolve(r_e, dim)), \
                (e, dim)
    for shape in ((512, 64, 32), (48, 7, 16), (1, 1, 1)):
        got = ctx.spec("batch", None, "tp", shape=shape)
        want = rctx.spec("batch", None, "tp", shape=shape)
        assert tuple(got) == tuple(want)
    assert tuple(ctx.spec("batch", ctx.UNC)) == tuple(
        _ref_entry(e) for e in rctx.spec("batch", rctx.UNC))


def test_constrain_is_identity_unconfigured_and_checks_rank():
    x = torch.zeros((4, 3, 2))
    assert not ctx.configured()
    assert ctx.constrain(x, "batch") is x        # no check unconfigured
    ctx.configure(tmesh.make_production_mesh(), batch="data")
    assert ctx.configured() and ctx.mesh().size == 256
    assert ctx.constrain(x, "batch", None, ctx.UNC) is x
    with pytest.raises(ValueError, match="got 2 axes for rank-3"):
        ctx.constrain(x, "batch", None)
    ctx.unconfigure()
    assert ctx.constrain(x, "batch") is x
