"""BERT4Rec (``make_bert4rec``), its sequence data and its config, beside
the reference's, on the CPU at ``SMOKE_CFG`` (502 items x 32, 2 blocks, 2
heads, sequence 32) with the reference's parameters carried across
(``convert.params_from_jax``).

``encode``, ``item_logits``, ``embed``, ``seq_loss`` and ``forward`` are
within 1e-5 of the reference's; the gradients of ``seq_loss`` within
1e-4 relative; ``SeqSynth`` batches are bit-equal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro.configs import bert4rec as jcfg
from repro.data.sequences import SeqConfig as JSeqConfig
from repro.data.sequences import SeqSynth as JSeqSynth
from repro.models import recsys as JR
from repro_torch import configs
from repro_torch.configs import bert4rec as tcfg
from repro_torch.convert import params_from_jax
from repro_torch.data.sequences import SeqConfig, SeqSynth
from repro_torch.models import recsys as TR
from repro_torch.optim.optimizers import tree_leaves

SEQ = dict(num_items=500, seq_len=32, seed=3)


@pytest.fixture(scope="module")
def models():
    jm = JR.make_bert4rec(jcfg.SMOKE_CFG)
    tm = TR.make_bert4rec(tcfg.SMOKE_CFG)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.device_get(jp))
    jb = JSeqSynth(JSeqConfig(**SEQ)).batch(4, 0)
    tb = {k: torch.from_numpy(v) for k, v in
          SeqSynth(SeqConfig(**SEQ)).batch(4, 0).items()}
    return jm, tm, jp, tp, {k: jnp.asarray(v) for k, v in jb.items()}, tb


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def test_config_and_layout_match_the_reference():
    assert tcfg.FULL_CFG.num_items == jcfg.FULL_CFG.num_items == 5_000_002
    for f in ("embed_dim", "n_blocks", "n_heads", "seq_len", "d_ff_mult"):
        assert getattr(tcfg.FULL_CFG, f) == getattr(jcfg.FULL_CFG, f)
        assert getattr(tcfg.SMOKE_CFG, f) == getattr(jcfg.SMOKE_CFG, f)
    arch = configs.get("bert4rec")
    assert arch.seq_model and arch.seq_len == 200 and not arch.has_dense
    jspec = JR.make_bert4rec(jcfg.FULL_CFG).spec
    assert tuple(arch.model.spec.cardinalities) == tuple(jspec.cardinalities)
    assert arch.model.spec.total_rows == jspec.total_rows == 5_000_704


def test_seq_synth_batches_are_bit_equal():
    for cfg in (SEQ, dict(num_items=5000, seq_len=50, mask_prob=0.3,
                          seed=9)):
        j, t = JSeqSynth(JSeqConfig(**cfg)), SeqSynth(SeqConfig(**cfg))
        assert j.vocab == t.vocab and j.mask_token == t.mask_token
        for step in (0, 5):
            jb, tb = j.batch(6, step), t.batch(6, step)
            assert set(jb) == set(tb)
            for k in jb:
                assert jb[k].dtype == tb[k].dtype
                np.testing.assert_array_equal(jb[k], tb[k])


def test_init_layout_and_shapes(models):
    jm, tm, jp, tp, _, _ = models
    gen = torch.Generator().manual_seed(0)
    own = tm.init(gen, torch.device("cpu"))
    jl = jax.tree_util.tree_leaves(jp)
    assert [tuple(x.shape) for x in tree_leaves(own)] == \
        [tuple(x.shape) for x in tree_leaves(tp)]
    assert len(jl) == len(tree_leaves(tp))
    # [items | positions | pad]: the pad rows are zero
    rows = tcfg.SMOKE_CFG.num_items + tcfg.SMOKE_CFG.seq_len
    assert not own["embed_table"][rows:].any()


def test_forward_functions_match_the_reference(models):
    jm, tm, jp, tp, jb, tb = models
    _close(tm.extras["encode"](tp, tb["inputs"]),
           jm.extras["encode"](jp, jb["inputs"]))
    _close(tm.extras["item_logits"](tp, tb["inputs"]),
           jm.extras["item_logits"](jp, jb["inputs"]))
    _close(tm.embed(tp, tb), jm.embed(jp, jb))
    mask = torch.tensor([1.0, 0.0])
    _close(tm.embed(tp, tb, mask), jm.embed(jp, jb, jnp.asarray(mask)))
    _close(tm.extras["seq_loss"](tp, tb), jm.extras["seq_loss"](jp, jb))
    _close(tm.forward(tp, tb), jm.forward(jp, jb))
    _close(tm.loss_from_emb(tp, None, tb),
           jm.loss_from_emb(jp, None, jb))
    with pytest.raises(NotImplementedError):
        tm.head(tp, None, tb)


def test_seq_loss_gradients_match_the_reference(models):
    jm, tm, jp, tp, jb, tb = models
    jg = jax.grad(lambda p: jm.extras["seq_loss"](p, jb))(jp)
    leaves = [x.detach().clone().requires_grad_() for x in tree_leaves(tp)]
    it = iter(leaves)

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(tree[k]) for k in sorted(tree)}
        if isinstance(tree, list):
            return [rebuild(v) for v in tree]
        return next(it)

    p = rebuild(tp)
    grads = torch.autograd.grad(tm.extras["seq_loss"](p, tb), leaves)
    jleaves = [x.numpy().astype(np.float64) for x in
               tree_leaves(params_from_jax(jax.device_get(jg)))]
    assert len(jleaves) == len(grads)
    scale = max(np.abs(w).max() for w in jleaves)
    for i, (got, want) in enumerate(zip(grads, jleaves)):
        err = np.abs(got.numpy() - want).max()
        top = np.abs(want).max()
        if top < 1e-6 * scale:
            # the key projections' biases: softmax over keys is blind to
            # them, so their gradient is 0 up to rounding on both sides
            assert err <= 1e-6 * scale, (i, err)
        else:
            assert err <= 1e-4 * top, (i, err, top)
