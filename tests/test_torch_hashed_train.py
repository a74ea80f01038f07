"""Parity of the port's hashed training path with the JAX package, on the
CPU: the compressed train step's ``hashed_cfg=`` branch, the chunked
least-squares fit of a pool to a table and ``gather_rows_host``.

The step runs three steps from the reference's initial state (carried
across by ``convert.train_state_from_jax``) on the same numpy batches,
against the jitted reference with ``use_pallas=False``.  Bit-equal where
the reference is: the (V,) Eq. 7 priority (the jitted FMA form) and the
Taylor access EMA.  Elsewhere within the tolerances stated: the forward
sums each chunk's draws in another order than XLA's reduce, the pool's
scatter and the optimizers round their own way.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro.models import embedding as JE
from repro.models import recsys as JR
from repro.optim import optimizers as jopt
from repro.store import hashed as JH
from repro.train.steps import make_compressed_train_step as jmake
from repro_torch.convert import train_state_from_jax
from repro_torch.data.criteo import CriteoConfig, CriteoSynth
from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.kernels.dequant_bag.ops import bag_grad
from repro_torch.models import embedding as TE
from repro_torch.models import recsys as TR
from repro_torch.optim import optimizers as topt
from repro_torch.store import hashed as H
from repro_torch.train.steps import make_compressed_train_step as tmake

CARDS = (50, 80, 30, 120)
DIM = 16


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).view(np.uint32)


def _dlrm(R):
    return R.make_dlrm(R.DLRMConfig(cardinalities=CARDS, embed_dim=DIM,
                                    num_dense=4, bot_mlp=(32, DIM),
                                    top_mlp=(64, 1)))


def _hcfg(ratio: float, num_hashes: int = 4) -> H.HashedConfig:
    vocab = sum(CARDS)
    return H.HashedConfig(
        vocab=vocab, dim=DIM, chunk_dim=8, num_hashes=num_hashes,
        num_slots=H.plan_pool_slots(vocab, DIM, 8, ratio))


@pytest.mark.parametrize("ratio", [4.0, 20.0])
def test_hashed_step_matches_jax(ratio):
    hcfg = _hcfg(ratio)
    jhcfg = JH.HashedConfig(**hcfg._asdict())
    jm, tm = _dlrm(JR), _dlrm(TR)
    ds = CriteoSynth(CriteoConfig(num_fields=len(CARDS), cardinalities=CARDS,
                                  num_dense=4, important_fields=2, seed=0))
    common = ("embed_table", 0.2, len(CARDS))
    jmaker = jmake(jm.loss_from_emb,
                   lambda b: JE.globalize(b["indices"], jm.spec),
                   lambda b: b["labels"], *common, hashed_cfg=jhcfg,
                   dense_optimizer=jopt.adam(0.05), use_pallas=False)
    tstep = tmake(tm.loss_from_emb,
                  lambda b: TE.globalize(b["indices"], tm.spec),
                  lambda b: b["labels"], *common, hashed_cfg=hcfg,
                  dense_optimizer=topt.adam(0.05))
    params = dict(jm.init(jax.random.PRNGKey(0)))
    params["embed_table"] = JH.init_hashed(jhcfg).pool
    jstate = jmaker.init_state(params)
    tstate = train_state_from_jax(jax.device_get(jstate))
    # the port's own initial state has the reference's shapes and values
    own = tstep.init_state(dict(tstate.params))
    assert own.opt[1].shape == (hcfg.num_slots,)
    assert float(own.opt[1][0]) == pytest.approx(0.1)
    assert own.priority.shape == (hcfg.vocab,)
    assert own.accum.access.shape == (hcfg.vocab,)
    assert own.accum.emb_mean.shape == (len(CARDS), DIM)
    jstep = jax.jit(jmaker)
    for s in range(3):
        nb = ds.batch(64, s)
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in nb.items()})
        reset_launches()
        tstate, tm_ = tstep(tstate, {k: torch.from_numpy(v)
                                     for k, v in nb.items()})
        assert sum(launch_counts().values()) == 0      # CPU: plain versions
        want = float(jm_["loss"])
        assert abs(float(tm_["loss"]) - want) <= 1e-5 * max(1.0, abs(want))
        # the pool: its scatter sums collisions in another order
        np.testing.assert_allclose(
            tstate.params["embed_table"].numpy(),
            np.asarray(jstate.params["embed_table"]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tstate.opt[1].numpy(),
                                   np.asarray(jstate.opt[1]), rtol=1e-5)
        np.testing.assert_array_equal(bits(tstate.priority),
                                      bits(jstate.priority))
        np.testing.assert_array_equal(bits(tstate.accum.access),
                                      bits(jstate.accum.access))
        for name in ("field_score", "emb_mean", "count"):
            np.testing.assert_allclose(
                getattr(tstate.accum, name).numpy(),
                np.asarray(getattr(jstate.accum, name)), rtol=1e-5,
                atol=1e-6)
    assert int(tstate.step) == 3
    assert float(tstate.priority.abs().sum()) > 0


# ------------------------------------------------------------------- the fit


def _table(v=1003, d=16, seed=0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((v, d))
            * 0.05).astype(np.float32)


def _chunked(monkeypatch, rows: int) -> None:
    """Fits from here on chunk every table, ``rows`` rows a chunk."""
    monkeypatch.setattr(H, "FIT_PLAN_SLOTS", 0)
    monkeypatch.setattr(H, "FIT_CHUNK_ROWS", rows)


@pytest.mark.parametrize("num_hashes", [1, 2])
def test_chunked_fit_is_bit_equal_to_one_call(num_hashes, monkeypatch):
    """97 rows a chunk split 1,003 rows unevenly (10 x 97 + 33)."""
    tab = torch.from_numpy(_table())
    cfg = H.HashedConfig(vocab=1003, dim=16, chunk_dim=8, num_slots=300,
                         num_hashes=num_hashes)
    assert H.fit_chunk_rows(cfg) == 1003           # small: one chunk
    one = H.fit_pool_from_table(tab, cfg)
    _chunked(monkeypatch, 97)
    seen = []

    def audit(r0, r1, g, bags, signs, before, after):
        seen.append((r0, r1))
        want = bag_grad(g, None, bags, signs, cfg.num_slots, out=before)
        np.testing.assert_array_equal(bits(after), bits(want))
    chunked = H.fit_pool_from_table(tab, cfg, audit=audit)
    np.testing.assert_array_equal(bits(chunked.pool), bits(one.pool))
    assert seen == [(r0, min(1003, r0 + 97)) for r0 in range(0, 1003, 97)]
    assert 0.0 < H.fit_residual(one, cfg, tab) < 1.0


def test_fit_chunk_rows_follows_the_plan_size():
    def cfg(vocab):
        return H.HashedConfig(vocab=vocab, dim=64, chunk_dim=8,
                              num_slots=1000)
    at_most = H.FIT_PLAN_SLOTS // 16           # 8 chunks x 2 hashes a row
    assert H.fit_chunk_rows(cfg(at_most)) == at_most
    assert H.fit_chunk_rows(cfg(at_most + 1)) == H.FIT_CHUNK_ROWS
    # wide&deep's 22,216,192 rows x 4 chunks: one; dlrm-rm2's 124M: 30
    assert H.fit_chunk_rows(H.HashedConfig(vocab=22_216_192, dim=32)) == (
        22_216_192)
    assert -(-124_185_088 // H.fit_chunk_rows(cfg(124_185_088))) == 30


def test_chunked_fit_matches_jax(monkeypatch):
    tab = _table(seed=1)
    cfg = H.HashedConfig(vocab=1003, dim=16, chunk_dim=8, num_slots=300)
    _chunked(monkeypatch, 97)
    got = H.fit_pool_from_table(torch.from_numpy(tab), cfg)
    want = JH.fit_pool_from_table(jnp.asarray(tab),
                                  JH.HashedConfig(**cfg._asdict()))
    # the CG dot products reduce in another order than XLA's
    scale = float(np.abs(np.asarray(want.pool)).max())
    np.testing.assert_allclose(got.pool.numpy(), np.asarray(want.pool),
                               rtol=0, atol=1e-5 * scale)
    np.testing.assert_array_equal(got.pool_scale.numpy(),
                                  np.asarray(want.pool_scale))


@pytest.mark.parametrize("bits_", [32, 8])
def test_gather_rows_host_matches_jax(bits_):
    cfg = H.HashedConfig(vocab=1003, dim=16, chunk_dim=8, num_slots=300)
    jcfg = JH.HashedConfig(**cfg._asdict())
    jhs = JH.fit_pool_from_table(jnp.asarray(_table(seed=2)), jcfg)
    if bits_ == 8:
        jhs = JH.quantize_pool(jhs)
    ths = H.HashedStore(*(torch.from_numpy(np.array(getattr(jhs, f)))
                          for f in H.HashedStore._fields))
    ids = np.array([0, 5, 1002, 7, 5, 512], np.int64)
    got = H.gather_rows_host(ths, cfg, ids)
    want = JH.gather_rows_host(jhs, jcfg, ids)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    # one chunk's draws: the port's FMA chain against the oracle's sum
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    assert got.shape == (6, 16)


def test_pipeline_hands_each_fit_chunk_to_its_audit(tmp_path, monkeypatch):
    """``run_pipeline(fit_audit=)`` sees every chunk of the hashed fit's
    first adj, each equal to the plain scatter onto the same running
    result; the record counts the chunks."""
    from repro_torch.launch import pipeline as tpipe
    _chunked(monkeypatch, 50_000)
    seen = []

    def fit_audit(hcfg, r0, r1, g, bags, signs, before, after):
        want = bag_grad(g, None, bags, signs, hcfg.num_slots, out=before)
        np.testing.assert_array_equal(bits(after), bits(want))
        seen.append(r1 - r0)
    cfg = tpipe.fast_config(ckpt_dir=str(tmp_path), device="cpu",
                            store_backend="hashed", steps=2,
                            finetune_steps=1, serve_requests=8,
                            eval_batches=1)
    rec = tpipe.run_pipeline(cfg, fit_audit=fit_audit)
    assert tpipe.verify_failures(rec) == []
    assert rec["fit_chunks"] == len(seen) == -(-rec["rows"] // 50_000) > 1
    assert sum(seen) == rec["rows"]
    assert 0.0 < rec["fit_relative_residual"] < 1.0 and rec["fit_s"] > 0
