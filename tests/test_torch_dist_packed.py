"""Parity of the port's row-sharded packed store (``repro_torch.dist``) with
the JAX package's ``repro.dist.packed``, on the CPU.

The same numpy pack, ids and weights go through the reference on a
4-device host mesh (one subprocess for this file, ``torch_mesh_jax``) and
through the port at meshes 1 and 4 in process (all shards on the CPU, the
shards row views of the pack).  Bit for bit: ``shard_nbytes``,
``unshard_packed``'s leaves, ``sharded_lookup`` (each row comes from one
shard; the reference's fused path and its oracle alike) and the sharded
train gather's forward.  Within the reference's own 2e-5: the bag paths,
whose shard sums the reference adds in its collective's order; the port
adds them in shard order and is held bit for bit to a shard-order
composition built here the reference's way (zero pad rows, clipped local
rows).  The sharded gradient equals the port's mesh-1 gradient bit for
bit (every row's slots lie in one shard, in (b, k) order) and the
reference's within 1e-6.  The reference's train step cannot run at mesh
> 1 under the installed JAX (``tests/test_pipeline.py::
test_compressed_step_mesh2_equivalent`` stops in ``post_step_sparse``),
so the port's sharded step is held to its mesh-1 step bit for bit and to
the reference's step at mesh 1 within ``test_torch_train.py``'s
tolerance.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_jax
import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro import configs as jconfigs
from repro.core import packed_store as jps
from repro.core import qat_store as jqs
from repro.train.setup import build_recsys_training as jbuild
from repro_torch import configs as tconfigs
from repro_torch.convert import packed_from_jax, train_state_from_jax
from repro_torch.core import packed_store as tps
from repro_torch.dist import make_mesh
from repro_torch.dist import packed as tdp
from repro_torch.kernels import cases
from repro_torch.kernels.bag_matmul import ops as bm_ops
from repro_torch.kernels.dequant_bag import autodiff as tad
from repro_torch.kernels.dequant_bag import kernel as tkernel
from repro_torch.kernels.dequant_bag import ops as tops
from repro_torch.kernels.dequant_bag.ref import dequant_bag_ref
from repro_torch.train.setup import build_recsys_training as tbuild

V, D, B, K, H = 192, 16, 24, 5, 8
COUNTS = (70, 51, 71)          # rows a tier: every shard window uneven
CPU = torch.device("cpu")


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.dtype.itemsize])


def _inputs() -> dict:
    rng = np.random.default_rng(25)
    cfg = jqs.FQuantConfig(stochastic=False)
    table = (rng.standard_normal((V, D)) * 0.05).astype(np.float32)
    pri = np.repeat(np.array([0.0, 1e4, 1e6], np.float32), COUNTS)
    rng.shuffle(pri)
    st = jqs.QATStore(jnp.asarray(table), jnp.asarray(pri))
    st = st._replace(table=jqs.snap(st.table, jqs.current_tiers(st, cfg),
                                    cfg))
    host = jps.PackedStore(*(np.asarray(x) for x in jps.pack(st, cfg)))
    host = host._replace(payload16=host.payload16.view(np.uint16))
    assert [int(x) for x in np.bincount(host.indirect >> 28)] == list(
        COUNTS)
    ids = rng.integers(0, V, (B, K)).astype(np.int32)
    w = rng.standard_normal((B, K)).astype(np.float32)
    w[rng.random((B, K)) < 0.3] = 0.0
    return dict(host._asdict(), table=np.asarray(st.table), ids=ids, w=w,
                flat=ids.reshape(-1), seg=np.repeat(np.arange(B), K)
                .astype(np.int32), wflat=w.reshape(-1),
                W=(rng.standard_normal((K * D, H)) * 0.1).astype(np.float32),
                g=rng.standard_normal((B, K, D)).astype(np.float32))


JAX_MESH4 = """
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import packed_store as ps
from repro.dist import packed as dp

leaves = dict(inp)
leaves["payload16"] = jax.lax.bitcast_convert_type(
    jnp.asarray(inp["payload16"]), jnp.bfloat16)
packed = ps.PackedStore(*(jnp.asarray(leaves[f])
                          for f in ps.PackedStore._fields))
mesh = jax.make_mesh((4,), ("model",))
sp = dp.shard_packed(packed, mesh)
un = dp.unshard_packed(sp)
ids, w, W = jnp.asarray(inp["ids"]), jnp.asarray(inp["w"]), jnp.asarray(inp["W"])
flat, seg, wflat = (jnp.asarray(inp[k]) for k in ("flat", "seg", "wflat"))
jit = lambda f: jax.jit(f)(sp)    # one compile a call, not one an op
save(nbytes=dp.shard_nbytes(packed, 4), nbytes_sharded=dp.shard_nbytes(sp, 4),
     **{f"un_{f}": getattr(un, f) for f in ps.PackedStore._fields
        if f != "payload16"},
     un_payload16=jax.lax.bitcast_convert_type(un.payload16, jnp.uint16),
     lookup=jit(lambda s: dp.sharded_lookup(s, ids, mesh=mesh,
                                            use_pallas=True)),
     lookup_oracle=jit(lambda s: dp.sharded_lookup(s, ids, mesh=mesh)),
     rect=jit(lambda s: dp.sharded_bag_lookup_rect(s, ids, mesh=mesh,
                                                   weights=w)),
     rect_unweighted=jit(lambda s: dp.sharded_bag_lookup_rect(s, ids,
                                                              mesh=mesh)),
     bag=jit(lambda s: dp.sharded_bag_lookup(s, flat, seg, ids.shape[0],
                                             mesh=mesh, weights=wflat)),
     matmul=jit(lambda s: dp.sharded_bag_matmul(s, ids, W, mesh=mesh)),
     matmul_weighted=jit(lambda s: dp.sharded_bag_matmul(
         s, ids, W, mesh=mesh, weights=w)))
tbl = jax.device_put(jnp.asarray(inp["table"]),
                     NamedSharding(mesh, P("model", None)))
fwd, grad = jax.jit(lambda t: (lambda o, f: (o, f(jnp.asarray(inp["g"]))[0]))(
    *jax.vjp(lambda u: dp.sharded_lookup_train(u, ids, mesh=mesh), t)))(tbl)
save(train_fwd=fwd, train_grad=grad)
"""


@pytest.fixture(scope="module")
def io(tmp_path_factory):
    inp = _inputs()
    out = torch_mesh_jax.run(JAX_MESH4, inp,
                             str(tmp_path_factory.mktemp("mesh4")))
    packed = packed_from_jax(jps.PackedStore(
        *(inp[f] for f in jps.PackedStore._fields)))
    return inp, out, packed


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _sharded(packed, n: int):
    return tdp.shard_packed(packed, make_mesh(n, device="cpu"))


def test_shard_nbytes_and_unshard_match_jax(io):
    inp, out, packed = io
    sp = _sharded(packed, 4)
    assert tdp.shard_nbytes(packed, 4) == int(out["nbytes"])
    assert tdp.shard_nbytes(sp, 4) == int(out["nbytes_sharded"])
    # one device: the shards are views of the pack, unshard is the pack
    assert tdp.unshard_packed(sp) is packed
    assert [s.payload8.data_ptr() for s in sp.shards] == [
        packed.payload8[f[0]:].data_ptr() for f in sp.firsts]
    for f in tps.PackedStore._fields:
        np.testing.assert_array_equal(bits(getattr(packed, f)),
                                      bits(out[f"un_{f}"]))
    assert [tuple(s.payload8.shape[0] for s in sp.shards)] == [
        (18, 18, 18, 16)]
    assert sp.nbytes() == packed.nbytes()


@pytest.mark.parametrize("n", [1, 4])
def test_sharded_lookup_bit_equal_to_jax_mesh4(io, n):
    inp, out, packed = io
    tkernel.reset_launches()
    got = tdp.sharded_lookup(_sharded(packed, n), _t(inp["ids"]))
    assert tkernel.total_launches() == 0      # CPU tensors: plain versions
    np.testing.assert_array_equal(bits(got), bits(out["lookup"]))
    np.testing.assert_array_equal(bits(got), bits(out["lookup_oracle"]))
    np.testing.assert_array_equal(
        bits(got), bits(tps.lookup(packed, _t(inp["ids"]))))


def _composed_shard(packed, n: int, i: int, ids, w) -> torch.Tensor:
    """Shard ``i`` of the reference's per-shard composition
    (``_local_bags_fused``): each tier padded with zero rows to n *
    ceil(V_t / n), shard i's slice, local rows clipped into it, mine * w
    as weights, one bag a tier summed zeros + int8 + half + fp32."""
    code = packed.indirect[ids]
    tier, loc = code >> 28, (code & ((1 << 28) - 1)).to(torch.int64)
    part = torch.zeros((ids.shape[0], packed.dim))
    for t, pay, sc in ((0, packed.payload8, packed.scale8),
                       (1, packed.payload16, packed.scale16),
                       (2, packed.payload32, None)):
        s = -(-pay.shape[0] // n)
        pad = torch.zeros((n * s, pay.shape[1]), dtype=pay.dtype)
        pad[:pay.shape[0]] = pay
        scale = torch.ones(n * s) if sc is None else torch.zeros(n * s)
        if sc is not None:
            scale[:sc.shape[0]] = sc
        li = loc - i * s
        mine = (tier == t) & (li >= 0) & (li < s)
        wt = mine.to(torch.float32) * (1.0 if w is None else w)
        part = part + dequant_bag_ref(
            pad[i * s:(i + 1) * s], scale[i * s:(i + 1) * s],
            li.clamp(0, s - 1).to(torch.int32), wt)
    return part


def _composed_rect(packed, n: int, ids, w) -> torch.Tensor:
    """The reference's shard sum, in shard order, of
    ``_composed_shard``."""
    out = None
    for i in range(n):
        part = _composed_shard(packed, n, i, ids.to(torch.int64), w)
        out = part if out is None else out + part
    return out


@pytest.mark.parametrize("path", ["rect", "rect_unweighted", "bag", "matmul",
                                  "matmul_weighted"])
def test_sharded_bag_paths_within_2e5_of_jax_mesh4(io, path):
    inp, out, packed = io
    ids, w = _t(inp["ids"]), _t(inp["w"])
    sp = _sharded(packed, 4)
    if path == "rect":
        got = tdp.sharded_bag_lookup_rect(sp, ids, weights=w)
        plain = _composed_rect(packed, 4, ids, w)
    elif path == "rect_unweighted":
        got = tdp.sharded_bag_lookup_rect(sp, ids)
        plain = _composed_rect(packed, 4, ids, None)
    elif path == "bag":
        got = tdp.sharded_bag_lookup(sp, _t(inp["flat"]), _t(inp["seg"]), B,
                                     weights=_t(inp["wflat"]))
        rows = sum(tdp._local_rows(s, f, _t(inp["flat"]))
                   for s, f in zip(sp.shards, sp.firsts))
        np.testing.assert_array_equal(
            bits(rows), bits(tps.lookup(packed, _t(inp["flat"]))))
        plain = None
    else:
        weights = w if path == "matmul_weighted" else None
        got = tdp.sharded_bag_matmul(sp, ids, _t(inp["W"]), weights=weights)
        one = tdp.sharded_bag_matmul(_sharded(packed, 1), ids, _t(inp["W"]),
                                     weights=weights)
        if weights is None:
            np.testing.assert_array_equal(
                bits(one), bits(bm_ops.packed_bag_matmul(packed, ids,
                                                         _t(inp["W"]))))
        np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=2e-5,
                                   atol=2e-5)
        plain = None
    np.testing.assert_allclose(got.numpy(), out[path], rtol=2e-5, atol=2e-5)
    if plain is not None:
        np.testing.assert_array_equal(bits(got), bits(plain))


def test_sharded_lookup_train_matches_jax_mesh4_and_mesh1(io):
    inp, out, _ = io
    ids, g = _t(inp["ids"]), _t(inp["g"])
    grads, fwds = [], []
    for mesh in (None, make_mesh(4, device="cpu")):
        table = _t(inp["table"]).requires_grad_()
        if mesh is None:
            fwd = tad.lookup_train(table, ids)
        else:
            fwd = tdp.sharded_lookup_train(table, ids, mesh=mesh)
        (grad,) = torch.autograd.grad(fwd, table, g)
        fwds.append(fwd.detach())
        grads.append(grad)
    np.testing.assert_array_equal(bits(fwds[1]), bits(fwds[0]))
    np.testing.assert_array_equal(bits(fwds[1]), bits(out["train_fwd"]))
    np.testing.assert_array_equal(bits(grads[1]), bits(grads[0]))
    np.testing.assert_allclose(grads[1].numpy(), out["train_grad"],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", cases.WINDOW_CASE_NAMES)
def test_windowed_tiered_plain_bit_equal_to_per_shard_composition(name):
    """The window cases (``kernels/cases.py``): each shard's windowed
    tiered plain version against the reference's per-shard composition
    (zero pad rows, clipped local rows, mine * w) bit for bit, NaN bags
    where a weight is not finite; their sum in shard order against
    ``sharded_bag_lookup_rect``; the whole store (the default window
    ``(0, 0, 0)``) against the reference's unsharded composition."""
    c = {c.name: c for c in cases.window_cases("cpu")}[name]
    packed = tps.PackedStore(*c.leaves)
    sp = _sharded(packed, c.shards)
    ids = c.ids.to(torch.int64)
    w = c.weights
    total = None
    for i, (shard, firsts) in enumerate(zip(sp.shards, sp.firsts)):
        got = tops.packed_bag_lookup(shard, c.ids, w, firsts=firsts)
        want = _composed_shard(packed, c.shards, i, ids, w)
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        np.testing.assert_array_equal(bits(got[~nan]), bits(want[~nan]))
        total = got if total is None else total + got
    summed = tdp.sharded_bag_lookup_rect(sp, c.ids, weights=w)
    assert torch.equal(torch.isnan(summed), torch.isnan(total))
    live = ~torch.isnan(total)
    np.testing.assert_array_equal(bits(summed[live]), bits(total[live]))
    if w is not None:
        bad = ~torch.isfinite(w).all(1)
        assert bool(torch.isnan(summed[bad]).all())
        assert bool(torch.isfinite(summed[~bad]).all())
    elif c.ids.shape[1] == 1:
        np.testing.assert_array_equal(
            bits(summed), bits(tps.lookup(packed, c.ids[:, 0])))
    whole = tops.packed_bag_lookup(packed, c.ids, w)
    want = _composed_shard(packed, 1, 0, ids, w)
    assert torch.equal(torch.isnan(whole), torch.isnan(want))
    live = ~torch.isnan(whole)
    np.testing.assert_array_equal(bits(whole[live]), bits(want[live]))


def test_sharded_train_step_bit_equal_to_mesh1_and_near_jax():
    """Two compressed train steps at mesh 4 and at mesh 1 from the
    reference's initial state: table, adagrad accumulator, priority,
    access EMA and loss bit-equal; against the reference's jitted step
    (mesh 1) the loss within 1e-5 and the priority bit for bit, as
    ``test_torch_train.py`` holds the unsharded step."""
    jsetup = jbuild(jconfigs.get("dlrm-rm2"), batch=32, use_pallas=True)
    mesh = make_mesh(4, device="cpu")
    arch = tconfigs.get("dlrm-rm2")
    states = {}
    for n, m in ((1, None), (4, mesh)):
        # mesh 4 places the reference's state (``place_train_state``)
        setup = tbuild(arch, batch=32, device=CPU, model="smoke", mesh=m,
                       state=train_state_from_jax(jax.device_get(
                           jsetup.state)))
        states[n] = (setup, setup.state)
    jstate, jstep = jsetup.state, jax.jit(jsetup.step)
    for s in range(2):
        nb = jsetup.ds.batch(32, s)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in nb.items()})
        got = {}
        for n, (setup, state) in states.items():
            state, m = setup.step(state, {k: _t(v) for k, v in nb.items()})
            states[n] = (setup, state)
            got[n] = (state, float(m["loss"]))
        (s1, l1), (s4, l4) = got[1], got[4]
        assert l1 == l4
        # the mesh-4 state's placed leaves read gathered whole
        for a, b in ((s1.params["embed_table"], s4.params["embed_table"]),
                     (s1.opt[1], s4.opt[1]), (s1.priority, s4.priority),
                     (s1.accum.access, s4.accum.access)):
            np.testing.assert_array_equal(bits(a), bits(tdp.whole(b)))
        want = float(jm["loss"])
        assert abs(l4 - want) <= 1e-5 * max(1.0, abs(want))
        np.testing.assert_array_equal(bits(tdp.whole(s4.priority)),
                                      bits(jstate.priority))


def test_sharded_paths_refuse_what_they_cannot_take():
    packed = tps.PackedStore(*cases.window_cases("cpu")[0].leaves)
    with pytest.raises(TypeError, match="ShardedPack"):
        tdp.sharded_lookup(packed, torch.zeros(3, dtype=torch.int64))
    sp = _sharded(packed, 4)
    with pytest.raises(ValueError, match="sharded 4 ways"):
        tdp.sharded_lookup(sp, torch.zeros(3, dtype=torch.int64),
                           mesh=make_mesh(2, device="cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        tdp.sharded_lookup_train(torch.zeros((10, 4)),
                                 torch.zeros(3, dtype=torch.int64),
                                 mesh=make_mesh(4, device="cpu"))
    with pytest.raises(ValueError, match="firsts"):
        tkernel.dequant_bag_tiered_cuda(
            packed.indirect, *packed[:5], torch.zeros((2, 1)),
            firsts=(0, -1, 0))
