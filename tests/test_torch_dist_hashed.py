"""Parity of the port's row-sharded hashed pool (``repro_torch.dist.hashed``)
with the JAX package's ``repro.dist.hashed``, on the CPU.

The same numpy pool (fp32, and int8 with per-slot scales) and ids go
through the reference on a 4-device host mesh (one subprocess for this
file, ``torch_mesh_jax``) and through the port at meshes 1 and 4 in
process.  A materialised row sums each chunk's draws, which may lie in
different shards: the port adds one partial a shard in shard order, the
reference in its collective's order, so in general the sharded rows
equal the unsharded ones, the reference's and the dense oracle's within
1e-6 (values ~0.05: a few ulps).  With two draws a chunk (one id, two
hashes, the serving default) and sign coefficients each chunk is one
rounding of the two draws' sum in either order, so there the sharded
rows keep the unsharded bits (checked).  At mesh 1 the sharded lookup is
the unsharded one bit for bit.  The pool gradient of the
sharded training gather equals the unsharded one bit for bit on the same
cotangent (each pool row's slots lie in one shard, in (b, c, t) order).
The reference's hashed train step cannot take gradients at mesh > 1
under the installed JAX (``tests/test_store_api.py::
test_hashed_gradcheck_mesh4_subprocess``), so the port's sharded hashed
step is held to its mesh-1 step within 1e-5 and to the reference's step
at mesh 1 within ``test_torch_hashed_train.py``'s tolerances.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_jax
import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro.models import embedding as JE
from repro.models import recsys as JR
from repro.optim import optimizers as jopt
from repro.store import hashed as JH
from repro.train.steps import make_compressed_train_step as jmake
from repro_torch.convert import train_state_from_jax
from repro_torch.data.criteo import CriteoConfig, CriteoSynth
from repro_torch.dist import make_mesh
from repro_torch.dist import hashed as tdh
from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.kernels.hashed_gather.autodiff import hashed_lookup_train
from repro_torch.models import embedding as TE
from repro_torch.models import recsys as TR
from repro_torch.optim import optimizers as topt
from repro_torch.serve import cache as C
from repro_torch.store import api as tapi
from repro_torch.store import hashed as H
from repro_torch.train.steps import make_compressed_train_step as tmake

CFG = H.HashedConfig(vocab=480, dim=16, chunk_dim=8, num_slots=301,
                     num_hashes=2, seed=3)
TOL = 1e-6


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).view(np.uint32)


def _stores():
    """The fp32 pool and its int8 quantization (reference leaves)."""
    jcfg = JH.HashedConfig(**CFG._asdict())
    hs = JH.init_hashed(jcfg, seed=5)
    hs = hs._replace(priority=jnp.asarray(
        np.random.default_rng(6).random(CFG.vocab).astype(np.float32)))
    return {"fp32": hs, "int8": JH.quantize_pool(hs)}


def _inputs() -> dict:
    rng = np.random.default_rng(7)
    out = {"ids": rng.integers(0, CFG.vocab, (40, 3)).astype(np.int32),
           "g": rng.standard_normal((40, 3, CFG.dim)).astype(np.float32)}
    for name, hs in _stores().items():
        for f in ("pool", "pool_scale", "priority"):
            out[f"{name}_{f}"] = np.asarray(getattr(hs, f))
    return out


JAX_MESH4 = """
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.dist import hashed as dh
from repro.store import api, hashed as hh

cfg = hh.HashedConfig(vocab=480, dim=16, chunk_dim=8, num_slots=301,
                      num_hashes=2, seed=3)
mesh = jax.make_mesh((4,), ("model",))
ids = jnp.asarray(inp["ids"])
for name in ("fp32", "int8"):
    hs = hh.HashedStore(*(jnp.asarray(inp[f"{name}_{f}"])
                          for f in ("pool", "pool_scale", "priority")))
    sh = dh.shard_hashed(hs, mesh)
    backend = api.build("hashed", hs, cfg, mesh=mesh)
    save(**{f"{name}_lookup": jax.jit(lambda s: dh.sharded_hashed_lookup(
                s, cfg, ids, mesh=mesh))(sh),
            f"{name}_backend": jax.jit(lambda s: backend.lookup_fn()(
                s, ids))(backend.device_store)})
pool = jax.device_put(dh._pad_rows(jnp.asarray(inp["fp32_pool"]), 4),
                      NamedSharding(mesh, P("model", None)))
fwd, grad = jax.jit(lambda p: (lambda o, f: (o, f(jnp.asarray(inp["g"]))[0]))(
    *jax.vjp(lambda u: dh.sharded_hashed_lookup_train(
        u, ids, num_chunks=cfg.num_chunks, num_hashes=cfg.num_hashes,
        num_slots=cfg.num_slots, seed=cfg.seed, mesh=mesh), p)))(pool)
save(train_fwd=fwd, train_grad=np.asarray(grad)[:cfg.num_slots])
"""


@pytest.fixture(scope="module")
def io(tmp_path_factory):
    inp = _inputs()
    return inp, torch_mesh_jax.run(JAX_MESH4, inp,
                                   str(tmp_path_factory.mktemp("hmesh4")))


def _hs(inp, name: str) -> H.HashedStore:
    return H.HashedStore(*(torch.from_numpy(np.array(inp[f"{name}_{f}"]))
                           for f in ("pool", "pool_scale", "priority")))


def _dense_rows(hs: H.HashedStore, ids: np.ndarray) -> np.ndarray:
    """The oracle: each chunk's draws, coefficient x scaled pool row, summed
    in float64."""
    from repro_torch.kernels.hashed_gather.ops import slot_plan
    slots, coeff = slot_plan(torch.from_numpy(ids.reshape(-1, 1)), None,
                             num_chunks=CFG.num_chunks,
                             num_hashes=CFG.num_hashes,
                             num_slots=CFG.num_slots, seed=CFG.seed)
    pool = (hs.pool.double() * hs.pool_scale.double()[:, None]).numpy()
    s = slots.numpy().reshape(-1, CFG.num_chunks, CFG.num_hashes)
    c = coeff.numpy().reshape(-1, CFG.num_chunks, CFG.num_hashes)
    rows = (pool[s] * c[..., None]).sum(axis=2)
    return rows.reshape(*ids.shape, CFG.dim)


@pytest.mark.parametrize("name", ["fp32", "int8"])
def test_sharded_hashed_lookup_matches_jax_mesh4(io, name):
    inp, out = io
    hs = _hs(inp, name)
    ids = torch.from_numpy(inp["ids"])
    unsharded = H.hashed_lookup(hs, CFG, ids)
    one = tdh.sharded_hashed_lookup(
        tdh.shard_hashed(hs, make_mesh(1, device="cpu")), CFG, ids)
    np.testing.assert_array_equal(bits(one), bits(unsharded))
    sh = tdh.shard_hashed(hs, make_mesh(4, device="cpu"))
    assert [p.shape[0] for p in sh.pools] == [76, 76, 76, 73]
    assert sh.pools[1].data_ptr() == hs.pool[76:].data_ptr()   # views
    reset_launches()
    got = tdh.sharded_hashed_lookup(sh, CFG, ids)
    assert sum(launch_counts().values()) == 0     # CPU: plain versions
    for want in (out[f"{name}_lookup"], unsharded.numpy(),
                 _dense_rows(hs, inp["ids"])):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # two draws a chunk with +-1 coefficients: each chunk is one rounding
    # of a + b in either order, so here the shard sum keeps the bits
    np.testing.assert_array_equal(bits(got), bits(unsharded))


@pytest.mark.parametrize("name", ["fp32", "int8"])
def test_hashed_backend_mesh_serves_through_the_shards(io, name):
    inp, out = io
    hs = _hs(inp, name)
    ids = torch.from_numpy(inp["ids"])
    flat = H.HashedConfig(**CFG._asdict())
    b1 = tapi.build("hashed", hs, flat)
    b4 = tapi.build("hashed", hs, flat, mesh=make_mesh(4, device="cpu"))
    assert isinstance(b4.packed, tdh.ShardedHashed) and b1.packed is hs
    assert b4.nbytes() == b1.nbytes() == b4.packed.nbytes()
    served = b4.lookup_fn()(b4.packed, ids)
    np.testing.assert_allclose(served.numpy(), out[f"{name}_backend"],
                               rtol=0, atol=TOL)
    np.testing.assert_array_equal(
        bits(served), bits(tdh.sharded_hashed_lookup(b4.packed, CFG, ids)))
    # the eager lookups and the cache rows stay unsharded, as the
    # reference's; the cached request path is the sharded gather
    np.testing.assert_array_equal(bits(b4.lookup(ids)), bits(b1.lookup(ids)))
    cache = b4.build_cache(64)
    rows, hits = b4.cached_lookup(cache, None, ids)
    hit = cache.slot_of[ids.to(torch.int64)] >= 0
    assert int(hits) == int(hit.sum()) > 0
    np.testing.assert_array_equal(bits(rows[~hit]), bits(served[~hit]))
    np.testing.assert_array_equal(bits(rows[hit]),
                                  bits(b1.lookup(ids)[hit]))
    with pytest.raises(ValueError, match="sharded 4 ways"):
        tdh.sharded_hashed_lookup(b4.packed, CFG, ids,
                                  mesh=make_mesh(2, device="cpu"))
    assert C.top_rows(b4.hs.priority, 3).numel() == 3


def test_sharded_hashed_train_gather_matches_jax_and_mesh1(io):
    inp, out = io
    ids, g = torch.from_numpy(inp["ids"]), torch.from_numpy(inp["g"])
    kw = dict(num_chunks=CFG.num_chunks, num_hashes=CFG.num_hashes,
              seed=CFG.seed)
    fwds, grads = [], []
    for mesh in (None, make_mesh(4, device="cpu")):
        pool = torch.from_numpy(np.array(inp["fp32_pool"])).requires_grad_()
        if mesh is None:
            fwd = hashed_lookup_train(pool, ids, **kw)
        else:
            fwd = tdh.sharded_hashed_lookup_train(
                pool, ids, num_slots=CFG.num_slots, mesh=mesh, **kw)
        (grad,) = torch.autograd.grad(fwd, pool, g)
        fwds.append(fwd.detach())
        grads.append(grad)
    np.testing.assert_array_equal(bits(grads[1]), bits(grads[0]))
    np.testing.assert_allclose(fwds[1].numpy(), fwds[0].numpy(), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(fwds[1].numpy(), out["train_fwd"], rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(grads[1].numpy(), out["train_grad"],
                               rtol=1e-6, atol=1e-6)


CARDS = (50, 80, 30, 120)


def test_sharded_hashed_step_near_mesh1_and_jax():
    """Three hashed train steps (``make_compressed_train_step(hashed_cfg=,
    mesh=)``) at mesh 4 and at mesh 1 from the reference's initial state:
    the Eq. 7 priority and access EMA bit-equal (they fold ids and labels
    only), the loss within 1e-5 and the pool within 1e-5 of mesh 1's (the
    forward's shard partials round on their own); against the
    reference's jitted step at mesh 1, its test's tolerances."""
    dim = 16
    vocab = sum(CARDS)
    hcfg = H.HashedConfig(vocab=vocab, dim=dim, chunk_dim=8, num_hashes=4,
                          num_slots=H.plan_pool_slots(vocab, dim, 8, 4.0))
    jhcfg = JH.HashedConfig(**hcfg._asdict())

    def dlrm(R):
        return R.make_dlrm(R.DLRMConfig(cardinalities=CARDS, embed_dim=dim,
                                        num_dense=4, bot_mlp=(32, dim),
                                        top_mlp=(64, 1)))
    jm, tm = dlrm(JR), dlrm(TR)
    ds = CriteoSynth(CriteoConfig(num_fields=len(CARDS), cardinalities=CARDS,
                                  num_dense=4, important_fields=2, seed=0))
    common = ("embed_table", 0.2, len(CARDS))
    jmaker = jmake(jm.loss_from_emb,
                   lambda b: JE.globalize(b["indices"], jm.spec),
                   lambda b: b["labels"], *common, hashed_cfg=jhcfg,
                   dense_optimizer=jopt.adam(0.05), use_pallas=False)
    params = dict(jm.init(jax.random.PRNGKey(0)))
    params["embed_table"] = JH.init_hashed(jhcfg).pool
    jstate = jmaker.init_state(params)
    steps, states = {}, {}
    for n in (1, 4):
        steps[n] = tmake(tm.loss_from_emb,
                         lambda b: TE.globalize(b["indices"], tm.spec),
                         lambda b: b["labels"], *common, hashed_cfg=hcfg,
                         dense_optimizer=topt.adam(0.05),
                         mesh=None if n == 1 else make_mesh(4, device="cpu"))
        states[n] = train_state_from_jax(jax.device_get(jstate))
    jstep = jax.jit(jmaker)
    for s in range(3):
        nb = ds.batch(64, s)
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in nb.items()})
        loss = {}
        for n in (1, 4):
            states[n], m = steps[n](states[n], {k: torch.from_numpy(v)
                                                for k, v in nb.items()})
            loss[n] = float(m["loss"])
        s1, s4 = states[1], states[4]
        assert abs(loss[4] - loss[1]) <= 1e-5 * max(1.0, abs(loss[1]))
        np.testing.assert_allclose(s4.params["embed_table"].numpy(),
                                   s1.params["embed_table"].numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(bits(s4.priority), bits(s1.priority))
        np.testing.assert_array_equal(bits(s4.accum.access),
                                      bits(s1.accum.access))
        want = float(jm_["loss"])
        assert abs(loss[4] - want) <= 1e-5 * max(1.0, abs(want))
        np.testing.assert_allclose(
            s4.params["embed_table"].numpy(),
            np.asarray(jstate.params["embed_table"]), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(bits(s4.priority),
                                      bits(jstate.priority))
