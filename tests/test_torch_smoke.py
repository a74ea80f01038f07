"""The family smokes (``configs.common``, ``launch.train --smoke``) and
the generic train step beside the reference's, on the CPU.

The train CLI's ``--smoke --device cpu`` prints finite metrics for all
ten archs (bert4rec, pna and the five LMs always take the smoke).  On a shared numpy
batch with the reference's parameters carried across, the first step of
``train.steps.make_train_step`` (row-wise adagrad 0.05, the arch's
F-Quantization hook) gives the reference's loss and gradient norm within
1e-5, its gradients within 1e-4 relative, its priorities within 1e-6,
and its adagrad accumulators and updated dense parameters (which carry
the gradients' rounding) within 1e-4.  The hook's ``post_step``
rounds the int8 tier stochastically, and the two packages draw with
different generators: every row is in the int8 tier after one step, so
the table is held to the reference's only within one int8 step of its
row.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro import configs as jconfigs
from repro.data.sequences import SeqConfig as JSeqConfig
from repro.data.sequences import SeqSynth as JSeqSynth
from repro.optim import optimizers as jopt
from repro.train import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.launch import train as ttrain
from repro_torch.optim import optimizers as topt
from repro_torch.train import steps as tsteps

ARCHS = ("dlrm-rm2", "wide-deep", "xdeepfm", "bert4rec")
# the archs whose only train-CLI path is the family smoke
SMOKE_ONLY = ("bert4rec", "pna", "smollm-135m", "qwen3-8b",
              "deepseek-coder-33b", "mixtral-8x22b", "deepseek-v2-lite-16b")


@pytest.mark.parametrize("arch", ARCHS + SMOKE_ONLY[1:])
def test_train_cli_smoke_is_finite(arch, capsys):
    argv = ["--arch", arch, "--device", "cpu"]
    if arch not in SMOKE_ONLY:  # these take the smoke anyway
        argv.append("--smoke")
    ttrain.main(argv)
    out = capsys.readouterr().out.splitlines()
    assert out[-2].startswith("smoke-train metrics:")
    import json
    rec = json.loads(out[-1])
    assert rec["finite"] is True and rec["arch"] == arch
    assert np.isfinite(rec["loss_first"]) and np.isfinite(rec["loss_last"])
    if arch == "pna":           # the 16-seed block's 88 nodes x 16 classes
        assert rec["serve_shape"] == [88, 16]
    elif arch in SMOKE_ONLY[2:]:
        assert rec["decode_logits_shape"] == [2, 1, 512]
    else:
        assert rec["serve_shape"] == [4 if arch == "bert4rec" else 8]


def test_smoke_needs_a_gpu_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("the no-GPU rule is checked where there is no GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        tconfigs.get("wide-deep").smoke()
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["--arch", "bert4rec"])


def _batch(arch: str, jarch, rng) -> dict:
    if arch == "bert4rec":
        return JSeqSynth(JSeqConfig(num_items=500, seq_len=32,
                                    seed=4)).batch(4, 0)
    spec = jarch.smoke_model.spec
    b = {"indices": rng.integers(0, min(spec.cardinalities),
                                 (8, spec.num_fields)).astype(np.int32),
         "labels": np.asarray([0., 1., 0., 1., 1., 0., 0., 1.],
                              np.float32)}
    if jarch.has_dense:
        b["dense"] = rng.standard_normal(
            (8, jarch.smoke_num_dense)).astype(np.float32)
    return b


def _loss_fn(model, seq: bool):
    if seq:
        return model.extras["seq_loss"]
    return lambda p, b: model.loss_from_emb(p, model.embed(p, b), b).mean()


def _close(got, want, tol):
    got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def _close_leaves(got, want, tol):
    """Each leaf within ``tol`` of its own largest magnitude; a leaf that
    is 0 but for rounding (bert4rec's key biases, which the softmax over
    keys is blind to, and what adagrad makes of their gradient) within
    1e-6 of the largest magnitude of all the leaves."""
    got = [np.asarray(x.detach().numpy(), np.float64) for x in got]
    want = [np.asarray(x.numpy(), np.float64) for x in want]
    assert len(got) == len(want)
    scale = max(np.abs(w).max() for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        top = np.abs(w).max()
        err = np.abs(g - w).max()
        assert err <= (tol * top if top >= 1e-6 * scale
                       else 1e-6 * scale), (i, err, top)


@pytest.mark.parametrize("arch", ARCHS)
def test_first_generic_step_matches_the_reference(arch):
    jarch, tarch = jconfigs.get(arch), tconfigs.get(arch)
    seq = tarch.seq_model
    assert seq == jarch.seq_model
    jm, tm = jarch.smoke_model, tarch.smoke_model
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.device_get(jp))
    nb = _batch(arch, jarch, np.random.default_rng(1))
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}

    # the loss and the gradients of every parameter
    jl, jg = jax.value_and_grad(_loss_fn(jm, seq))(jp, jb)
    leaves = topt.tree_leaves(tp)
    p = topt.tree_map(lambda x: x.detach().clone().requires_grad_(), tp)
    tl = _loss_fn(tm, seq)(p, tb)
    grads = torch.autograd.grad(tl, topt.tree_leaves(p), allow_unused=True)
    _close(tl, jl, 1e-5)
    jleaves = topt.tree_leaves(params_from_jax(jax.device_get(jg)))
    assert len(jleaves) == len(grads) == len(leaves)
    assert all(g is not None for g in grads)
    _close_leaves(grads, jleaves, 1e-4)

    # one step of each package's generic train step, with the hook
    jopt_, topt_ = jopt.rowwise_adagrad(0.05), topt.rowwise_adagrad(0.05)
    jhook = jarch._fquant_hook(jm)
    thook = tarch._fquant_hook(tm)
    jstate = jsteps.init_state(jp, jopt_, jhook)
    tstate = tsteps.init_state(tp, topt_, thook)
    jstate, jmet = jax.jit(jsteps.make_train_step(
        _loss_fn(jm, seq), jopt_, jhook))(jstate, jb)
    tstate, tmet = tsteps.make_train_step(
        tarch._loss_fn(tm), topt_, thook)(tstate, tb)
    _close(tmet["loss"], jmet["loss"], 1e-5)
    _close(tmet["grad_norm"], jmet["grad_norm"], 1e-5)
    _close(tstate.priority, jstate.priority, 1e-6)
    assert int(tstate.step) == int(jstate.step) == 1
    jacc = topt.tree_leaves(params_from_jax(jax.device_get(
        jstate.opt.accum)))
    tacc = topt.tree_leaves(tstate.opt.accum)
    _close_leaves(tacc, jacc, 1e-4)
    jnew = params_from_jax(jax.device_get(jstate.params))
    dense = sorted(k for k in tstate.params if k != "embed_table")
    _close_leaves(topt.tree_leaves({k: tstate.params[k] for k in dense}),
                  topt.tree_leaves({k: jnew[k] for k in dense}), 1e-4)
    # the snapped table: every row int8, each element within one int8
    # step of the reference's (the draws differ)
    jt = jnew["embed_table"].double()
    tt = tstate.params["embed_table"].double()
    step = jt.abs().amax(dim=1, keepdim=True) / 127.0
    assert bool(((tt - jt).abs() <= 1.01 * step + 1e-7).all())
