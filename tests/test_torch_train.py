"""Parity of the port's training slice with the JAX package, on the CPU.

The same numpy inputs go through each reference function and its port:
the Eq. 7 priorities, the stochastic write path, the accumulators, the
optimizers, one whole compressed train step from the same state (carried
by ``convert.train_state_from_jax``), the checkpoint format and the
loop.  Bit-equal where the reference is: the uint32 hash, the snap, the
counts, and the Eq. 7 EMA, whose multiply-add XLA contracts into one
FMA under ``jit`` (the port computes that FMA exactly with ``fma_f32``).
Elsewhere (reductions and products that XLA and torch sum in different
orders) within the tolerance each test states.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro import configs as jconfigs
from repro.ckpt.manager import CheckpointManager as JManager
from repro.core import metrics as jmetrics
from repro.core import priority as jpri
from repro.core import qat_store as jqs
from repro.optim import optimizers as jopt
from repro.train import accum as jacc
from repro.train.setup import build_recsys_training as jbuild
from repro_torch import configs as tconfigs
from repro_torch.ckpt.manager import CheckpointManager as TManager
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.core import metrics as tmetrics
from repro_torch.core import priority as tpri
from repro_torch.core import qat_store as tqs
from repro_torch.core.tiers import TierConfig
from repro_torch.kernels.dequant_bag import kernel as tkernel
from repro_torch.launch import train as tlaunch
from repro_torch.models import recsys as TR
from repro_torch.optim import optimizers as topt
from repro_torch.train import accum as tacc
from repro_torch.train import loop as tloop
from repro_torch.train.setup import build_recsys_training as tbuild

CPU = torch.device("cpu")


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).view(np.uint32)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# --------------------------------------------------------------- Eq. 7


def _batch_rows(seed, vocab=300, b=40, f=5):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, vocab, (b, f)).astype(np.int32)
    idx[:, 0] = rng.integers(0, 4, b)                  # hot duplicate rows
    labels = (rng.random(b) < 0.3).astype(np.float32)
    w = (rng.pareto(1.2, vocab) * 10).astype(np.float32)
    return idx, labels, w


@pytest.mark.parametrize("seed", [0, 1])
def test_priority_update_from_batch_bit_equal(seed):
    idx, labels, w = _batch_rows(seed)
    cfg = jpri.PriorityConfig()
    want = jax.jit(lambda a, i, y: jpri.priority_update_from_batch(
        a, i, y, cfg))(jnp.asarray(w), jnp.asarray(idx), jnp.asarray(labels))
    got = tpri.priority_update_from_batch(t(w), t(idx), t(labels))
    np.testing.assert_array_equal(bits(got), bits(want))
    cp, cn = tpri.batch_counts(t(idx), t(labels), w.shape[0])
    jp, jn = jpri.batch_counts(jnp.asarray(idx), jnp.asarray(labels),
                               w.shape[0])
    np.testing.assert_array_equal(cp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(cn.numpy(), np.asarray(jn))


def test_serve_update_bit_equal():
    idx, _, w = _batch_rows(2)
    valid = np.random.default_rng(3).random(idx.shape) < 0.8
    want = jax.jit(lambda a, i, v: jpri.serve_update(a, i, valid=v))(
        jnp.asarray(w), jnp.asarray(idx), jnp.asarray(valid))
    got = tpri.serve_update(t(w), t(idx), valid=t(valid))
    np.testing.assert_array_equal(bits(got), bits(want))


# ------------------------------------------------------- the write path


def test_hash_uniform_bit_equal():
    idx = np.array([0, 1, 7, 123_456, 124_185_087, 2**31 - 1], np.int32)
    for seed in (0, 1, 37, 2**31 - 1):
        want = jqs._hash_uniform(jnp.asarray(idx), jnp.uint32(seed), 64)
        got = tqs._hash_uniform(t(idx), seed, 64)
        np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("stochastic", [True, False])
def test_post_step_sparse_bit_equal(stochastic):
    idx, labels, w = _batch_rows(4, vocab=300)
    rng = np.random.default_rng(5)
    table = (rng.standard_normal((300, 16)) * 0.05).astype(np.float32)
    w[:40] *= 1e4                                   # some rows in each tier
    cfg_kw = dict(tiers=TierConfig(t8=3.0, t16=300.0), stochastic=stochastic)
    jcfg = jqs.FQuantConfig(tiers=jqs.TierConfig(3.0, 300.0),
                            stochastic=stochastic)
    want = jax.jit(lambda tb, p, i, y, s: jqs.post_step_sparse(
        jqs.QATStore(tb, p), i, y, jcfg, seed=s))(
        jnp.asarray(table), jnp.asarray(w), jnp.asarray(idx),
        jnp.asarray(labels), jnp.uint32(9))
    got = tqs.post_step_sparse(tqs.QATStore(t(table), t(w)), t(idx),
                               t(labels), tqs.FQuantConfig(**cfg_kw),
                               seed=9)
    np.testing.assert_array_equal(bits(got.priority), bits(want.priority))
    np.testing.assert_array_equal(bits(got.table), bits(want.table))
    tiers = np.asarray(jqs.current_tiers(want, jcfg))[idx.reshape(-1)]
    assert len(set(tiers.tolist())) == 3


def test_post_step_bit_equal():
    idx, labels, w = _batch_rows(6, vocab=300)
    table = (np.random.default_rng(7).standard_normal((300, 16)) * 0.05
             ).astype(np.float32)
    w[:40] *= 1e4
    jcfg = jqs.FQuantConfig(tiers=jqs.TierConfig(3.0, 300.0))
    want = jax.jit(lambda tb, p, i, y: jqs.post_step(
        jqs.QATStore(tb, p), i, y, jcfg))(
        jnp.asarray(table), jnp.asarray(w), jnp.asarray(idx),
        jnp.asarray(labels))
    got = tqs.post_step(tqs.QATStore(t(table), t(w)), t(idx), t(labels),
                        tqs.FQuantConfig(tiers=TierConfig(3.0, 300.0)))
    np.testing.assert_array_equal(bits(got.priority), bits(want.priority))
    np.testing.assert_array_equal(bits(got.table), bits(want.table))


# ------------------------------------------------ accumulators, optimizers


def test_update_accum_matches_jax():
    rng = np.random.default_rng(6)
    b, f, d, v = 32, 5, 8, 200
    gidx = rng.integers(0, v, (b, f)).astype(np.int32)
    emb = rng.standard_normal((b, f, d)).astype(np.float32)
    g = rng.standard_normal((b, f, d)).astype(np.float32) * 1e-2
    jstate = jacc.init_accum(v, f, d)
    tstate = tacc.init_accum(v, f, d, CPU)
    jup = jax.jit(jacc.update_accum)
    for step in range(2):
        jstate = jup(jstate, jnp.asarray(gidx), jnp.asarray(emb + step),
                     jnp.asarray(g))
        tstate = tacc.update_accum(tstate, t(gidx), t(emb + step), t(g))
    np.testing.assert_array_equal(bits(tstate.access), bits(jstate.access))
    assert float(tstate.count) == float(jstate.count) == 2 * b
    for name in ("field_score", "emb_mean"):
        np.testing.assert_allclose(getattr(tstate, name).numpy(),
                                   np.asarray(getattr(jstate, name)),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tacc.field_scores(tstate).numpy(),
                               np.asarray(jacc.field_scores(jstate)),
                               rtol=1e-5, atol=1e-6)


def test_rowwise_adagrad_chunked_matches_jax():
    rng = np.random.default_rng(7)
    table = rng.standard_normal((50, 16)).astype(np.float32)
    accum = np.full(50, 0.1, np.float32)
    grad = rng.standard_normal((50, 16)).astype(np.float32)
    grad[rng.random(50) < 0.5] = 0.0                 # untouched rows
    jt, ja = jax.jit(lambda a, b, c: jopt.rowwise_adagrad_table_update(
        a, b, c, 0.05))(jnp.asarray(table), jnp.asarray(accum),
                        jnp.asarray(grad))
    tt, ta = t(table), t(accum)
    out_t, out_a = topt.rowwise_adagrad_table_update(tt, ta, t(grad), 0.05,
                                                     chunk_rows=7)
    assert out_t is tt and out_a is ta               # in place
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6,
                               atol=1e-7)
    untouched = ~grad.any(axis=1)
    np.testing.assert_array_equal(bits(tt)[untouched], bits(table)[untouched])


def test_adam_matches_jax():
    rng = np.random.default_rng(8)
    params = {"a": {"w": rng.standard_normal((4, 3)).astype(np.float32)},
              "b": rng.standard_normal(3).astype(np.float32)}
    jo, to = jopt.adam(0.01), topt.adam(0.01)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = params_from_jax(params)
    js, ts = jo.init(jp), to.init(tp)
    for i in range(3):
        g = jax.tree_util.tree_map(
            lambda x: (np.random.default_rng(i).standard_normal(x.shape)
                       ).astype(np.float32), params)
        ju, js = jax.jit(jo.update)(jax.tree_util.tree_map(jnp.asarray, g),
                                    js, jp)
        jp = jopt.apply_updates(jp, ju)
        tu, ts = to.update(params_from_jax(g), ts, tp)
        tp = topt.apply_updates(tp, tu)
    for path, want in jax.tree_util.tree_flatten_with_path(jp)[0]:
        got = tp
        for k in path:
            got = got[k.key]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    assert int(ts.step) == int(js.step) == 3


def test_metrics_match_jax():
    rng = np.random.default_rng(9)
    logits = rng.standard_normal(500).astype(np.float32) * 3
    logits[:50] = np.round(logits[:50])              # ties
    labels = (rng.random(500) < 0.4).astype(np.float32)
    valid = rng.random(500) < 0.9
    np.testing.assert_allclose(
        tmetrics.bce_with_logits(t(logits), t(labels)).numpy(),
        np.asarray(jmetrics.bce_with_logits(jnp.asarray(logits),
                                            jnp.asarray(labels))),
        rtol=1e-6, atol=1e-7)
    for v in (None, valid):
        want = float(jmetrics.auc(jnp.asarray(logits), jnp.asarray(labels),
                                  None if v is None else jnp.asarray(v)))
        got = float(tmetrics.auc(t(logits), t(labels),
                                 None if v is None else t(v)))
        assert abs(got - want) <= 1e-6, (got, want)


# ------------------------------------------------------- the train step


def _setups(batch=64):
    jsetup = jbuild(jconfigs.get("dlrm-rm2"), batch=batch, use_pallas=True)
    tsetup = tbuild(tconfigs.get("dlrm-rm2"), batch=batch, device=CPU,
                    model="smoke")
    return jsetup, tsetup


def test_compressed_step_matches_jax():
    jsetup, tsetup = _setups()
    jstate = jsetup.state
    tstate = train_state_from_jax(jax.device_get(jstate))
    jstep = jax.jit(jsetup.step)
    cfg = jqs.FQuantConfig()
    snap_rows = 0
    for s in range(2):
        nb = jsetup.ds.batch(64, s)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in nb.items()})
        tkernel.reset_launches()
        tstate, tm = tsetup.step(tstate, {k: t(v) for k, v in nb.items()})
        assert tkernel.total_launches() == 0         # CPU: plain versions
        want_loss = float(jm["loss"])
        assert abs(float(tm["loss"]) - want_loss) <= 1e-5 * max(
            1.0, abs(want_loss))
        np.testing.assert_array_equal(bits(tstate.priority),
                                      bits(jstate.priority))
        np.testing.assert_allclose(tstate.opt[1].numpy(),
                                   np.asarray(jstate.opt[1]), rtol=1e-5)
        jt = np.asarray(jstate.params["embed_table"])
        tt = tstate.params["embed_table"].numpy()
        # one quantisation step of a row's int8 / half grid
        tiers = np.asarray(jqs.current_tiers(
            jqs.QATStore(jnp.asarray(jt), jstate.priority), cfg))
        step = np.where(tiers == 0, np.abs(jt).max(axis=1) / 127,
                        np.abs(jt).max(axis=1) / 128)[:, None]
        diff = np.abs(tt - jt)
        off = diff > 1e-5
        snap_rows += int(off.any(axis=1).sum())
        print(f"step {s}: loss jax {want_loss} port {float(tm['loss'])}, "
              f"table max abs diff {float(diff.max())}, "
              f"{int((bits(tt) != bits(jt)).sum())} elements not bit-equal")
        assert np.all(diff[off] <= step.repeat(16, 1)[off] * 1.001 + 1e-7)
        for name in ("field_score", "emb_mean", "access", "count"):
            np.testing.assert_allclose(
                getattr(tstate.accum, name).numpy(),
                np.asarray(getattr(jstate.accum, name)), rtol=1e-5,
                atol=1e-5)
        for path, want in jax.tree_util.tree_flatten_with_path(
                jstate.params["net"])[0]:
            got = tstate.params["net"]
            for k in path:
                got = got[k.key]
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)
    assert int(tstate.step) == int(jstate.step) == 2
    print(f"rows one quantisation step apart over 2 steps: {snap_rows}")


def test_field_mask_step_matches_jax():
    from repro.train.steps import make_compressed_train_step as jmake
    from repro_torch.train.steps import make_compressed_train_step as tmake
    jsetup, tsetup = _setups(batch=16)
    mask = np.array([1, 0, 1, 1, 0, 1, 1, 1], np.float32)
    common = dict(fq_cfg=None, field_mask=mask)
    jstep = jax.jit(jmake(jsetup.model.loss_from_emb, jsetup.indices_fn,
                          lambda b: b["labels"], "embed_table", 0.05, 8,
                          use_pallas=True, **common))
    tstep = tmake(tsetup.model.loss_from_emb, tsetup.indices_fn,
                  lambda b: b["labels"], "embed_table", 0.05, 8, **common)
    jstate = jsetup.state._replace(priority=None)
    tstate = train_state_from_jax(jax.device_get(jstate))
    table0 = tstate.params["embed_table"].clone()
    nb = jsetup.ds.batch(16, 0)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in nb.items()})
    tstate, tm = tstep(tstate, {k: t(v) for k, v in nb.items()})
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5
    got = tstate.params["embed_table"]
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jstate.params["embed_table"]),
                               rtol=0, atol=1e-6)
    # pruned fields get no gradient: their rows keep their values
    pruned = tsetup.indices_fn({"indices": t(nb["indices"])})[:, mask == 0]
    rows = pruned.reshape(-1).to(torch.int64)
    assert torch.equal(got[rows], table0[rows])


def test_step_refuses_unported_branches():
    """The mesh branch runs on one device or several
    (tests/test_torch_dist_packed.py, tests/test_torch_train_mesh.py): a
    mesh whose shards span several devices gets its row windows; a mesh
    that is not a repro_torch.dist.Mesh is refused, and so is a state
    that was not placed (``place_train_state``) given to the sharded
    step."""
    from repro_torch.dist import Mesh, make_mesh
    from repro_torch.dist.packed import train_windows
    from repro_torch.train.steps import (TrainState,
                                         make_compressed_train_step)
    with pytest.raises(TypeError, match="Mesh"):
        make_compressed_train_step(None, None, None, "embed_table", 0.1, 4,
                                   mesh=object())
    spread = Mesh(["cpu", "meta"])
    assert train_windows(8, spread) == ((0, 4), (4, 4))
    step = make_compressed_train_step(None, None, None, "embed_table", 0.1,
                                      4, mesh=make_mesh(2, device="cpu"))
    whole = TrainState(params={"embed_table": torch.zeros((8, 4))},
                       opt=None, step=torch.zeros((), dtype=torch.int32))
    with pytest.raises(TypeError, match="placed state"):
        step(whole, {})


def test_step_skips_nonfinite_loss():
    _, tsetup = _setups(batch=16)
    state = tsetup.state
    table = state.params["embed_table"].clone()
    batch = tsetup.batch_fn(0)
    batch["dense"][0, 0] = float("nan")
    new_state, m = tsetup.step(state, batch)
    assert not np.isfinite(float(m["loss"]))
    assert new_state is state
    assert torch.equal(state.params["embed_table"], table)


# -------------------------------------------------- checkpoints and loop


def test_jax_checkpoint_restores_in_port(tmp_path):
    jsetup, _ = _setups(batch=16)
    jstate, _ = jax.jit(jsetup.step)(
        jsetup.state, {k: jnp.asarray(v)
                       for k, v in jsetup.ds.batch(16, 0).items()})
    JManager(str(tmp_path)).save(1, jstate)
    template = train_state_from_jax(jax.device_get(jsetup.state))
    got, step = TManager(str(tmp_path)).restore(template)
    assert step == 1
    want = jax.tree_util.tree_flatten_with_path(jax.device_get(jstate))[0]
    from repro_torch.ckpt.manager import tree_paths
    got_leaves = dict(tree_paths(got))
    assert set(got_leaves) == {jax.tree_util.keystr(p) for p, _ in want}
    for p, w in want:
        g = got_leaves[jax.tree_util.keystr(p)]
        assert g.dtype == torch.from_numpy(np.asarray(w)).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_port_checkpoint_roundtrips_bf16_and_restores_in_jax(tmp_path):
    bf = torch.randn((3, 4)).to(torch.bfloat16)
    tree = {"a": bf, "b": {"c": torch.arange(5, dtype=torch.int32)}}
    mgr = TManager(str(tmp_path))
    mgr.save(3, tree, blocking=False)
    mgr.wait()
    back, step = mgr.restore({"a": torch.zeros((3, 4), dtype=torch.bfloat16),
                              "b": {"c": torch.zeros(5, dtype=torch.int32)}})
    assert step == 3 and torch.equal(back["a"].view(torch.int16),
                                     bf.view(torch.int16))
    jback, _ = JManager(str(tmp_path)).restore(
        {"a": jnp.zeros((3, 4), jnp.bfloat16),
         "b": {"c": jnp.zeros(5, jnp.int32)}})
    np.testing.assert_array_equal(np.asarray(jback["a"]).view(np.uint16),
                                  bf.view(torch.int16).numpy().view(
                                      np.uint16))
    with pytest.raises(FileNotFoundError):
        mgr.restore({"a": torch.zeros((2, 4), dtype=torch.bfloat16),
                     "b": {"c": torch.zeros(5, dtype=torch.int32)}})


def test_loop_resume_replays_exactly(tmp_path):
    def run(total, ckpt_dir):
        _, tsetup = _setups(batch=16)
        cfg = tloop.LoopConfig(total_steps=total, ckpt_every=2,
                               ckpt_dir=str(ckpt_dir))
        return tloop.run(tsetup.state, tsetup.step, tsetup.batch_fn, cfg)

    straight = run(5, tmp_path / "a")
    first = run(3, tmp_path / "b")
    assert first.resumed_from is None and first.steps_run == 3
    resumed = run(5, tmp_path / "b")
    assert resumed.resumed_from == 3 and resumed.steps_run == 2
    assert resumed.losses == straight.losses[3:]
    for a, b in zip(
            [resumed.state.params["embed_table"], resumed.state.priority,
             resumed.state.opt[1], resumed.state.accum.access],
            [straight.state.params["embed_table"], straight.state.priority,
             straight.state.opt[1], straight.state.accum.access]):
        assert torch.equal(a, b)


def test_launch_train_cpu_smoke_and_gpu_rule(tmp_path):
    rec = tlaunch.run(tlaunch.parse_args(
        ["--model", "smoke", "--device", "cpu", "--steps", "3",
         "--batch", "16", "--ckpt-dir", str(tmp_path)]))
    assert rec["device"] == "cpu" and rec["steps_run"] == 3
    assert rec["kernel_launches"] == {"dequant_bag": 0, "bag_grad": 0}
    assert np.isfinite(rec["loss_first"]) and np.isfinite(rec["loss_last"])
    assert rec["rows"] == 179_712 and rec["reduced"] == []
    if torch.cuda.is_available():
        pytest.skip("the no-GPU rule is checked where there is no GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        tlaunch.run(tlaunch.parse_args(["--model", "smoke", "--steps", "1"]))


def test_full_setup_caps_rows_without_building():
    arch = tconfigs.get("dlrm-rm2")
    capped = dataclasses.replace(arch.cfg, cardinalities=tuple(
        min(c, tlaunch.FULL_MAX_IND_RANGE) for c in arch.cfg.cardinalities))
    spec = TR.make_dlrm(capped).spec
    assert spec.total_rows == 124_185_088 and spec.dim == 64
    assert arch.model.spec.total_rows == 204_185_088


def test_full_width_step_matches_jax():
    # the published head widths (26 fields x 64, 13-512-256-64,
    # 415-512-512-256-1) over a small table: at lr 0.05 the first Adam
    # step overshoots and the loss spikes, in both packages alike
    from repro.configs import dlrm_rm2 as jd
    from repro.data.criteo import CriteoConfig, CriteoSynth
    from repro.models import embedding as JE
    from repro.models import recsys as JR
    from repro.train.steps import make_compressed_train_step as jmake
    from repro_torch.configs import dlrm_rm2 as td
    from repro_torch.models import embedding as TE
    from repro_torch.models import recsys as TR
    from repro_torch.train.steps import make_compressed_train_step as tmake

    cards = tuple(min(c, 500) for c in jd.CARDS)
    jm = JR.make_dlrm(dataclasses.replace(jd.FULL_CFG, cardinalities=cards))
    tm = TR.make_dlrm(dataclasses.replace(td.FULL_CFG, cardinalities=cards))
    ds = CriteoSynth(CriteoConfig(num_fields=26, cardinalities=cards,
                                  num_dense=13, important_fields=13))
    jstep = jmake(jm.loss_from_emb, lambda b: JE.globalize(b["indices"],
                                                           jm.spec),
                  lambda b: b["labels"], "embed_table", 0.05, 26,
                  fq_cfg=jqs.FQuantConfig(), use_pallas=True)
    tstep = tmake(tm.loss_from_emb, lambda b: TE.globalize(b["indices"],
                                                           tm.spec),
                  lambda b: b["labels"], "embed_table", 0.05, 26,
                  fq_cfg=tqs.FQuantConfig())
    jstate = jstep.init_state(jm.init(jax.random.PRNGKey(0)))
    tstate = train_state_from_jax(jax.device_get(jstate))
    jj = jax.jit(jstep)
    for s in range(2):
        nb = ds.batch(64, s)
        jstate, jmet = jj(jstate, {k: jnp.asarray(v) for k, v in nb.items()})
        tstate, tmet = tstep(tstate, {k: t(v) for k, v in nb.items()})
        want = float(jmet["loss"])
        assert abs(float(tmet["loss"]) - want) <= 1e-5 * max(1.0, abs(want))
        print(f"full-width step {s}: loss jax {want} port "
              f"{float(tmet['loss'])}")
    np.testing.assert_array_equal(bits(tstate.priority),
                                  bits(jstate.priority))
