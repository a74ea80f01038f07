"""Shared benchmark harness: a small DLRM on planted synthetic Criteo,
trainable under any embedding-quantization strategy, with exact AUC eval.

Port of ``benchmarks/common.py``: the same ``CriteoSynth`` stream (numpy,
the same seeds give the same arrays) and the same DLRM widths (embed dim
16, bottom MLP 4-32-16, top MLP 64-1).  Every paper table and figure
benchmark builds on it.

The reference draws its params and its ALPT table with ``jax.random``,
which torch cannot reproduce: here they come from explicit
``torch.Generator``s on the setup's device, seeded as the reference's
keys are (``seed`` for the params, ``seed + 1`` for ALPT's table), and
``params=`` (``alpt_state=``) takes given ones instead, e.g. the
reference's carried across with ``convert.py``.  The stochastic steps
take their uniforms from a draw source (``draw=``, see
``core.rowwise_quant``): by default a generator on the device seeded
with the reference's key offsets (``seed + 99`` F-Quantization, ``+ 7``
MPE, ``+ 13`` ALPT).

A training step is eager torch: autograd through ``model.embed`` and
``model.loss_from_emb`` (the table's gradient is dense, as the
reference's), then the tree ``rowwise_adagrad``.  Batches come from
``ds.batch`` as numpy and reach the card through pinned memory without
a sync; nothing on the step reads a device value back, so the host runs
ahead of the card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import qat_store as qs
from repro_torch.core import rowwise_quant as rq
from repro_torch.core.baselines import alpt as alpt_lib
from repro_torch.core.baselines import mpe as mpe_lib
from repro_torch.core.metrics import auc
from repro_torch.core.qat_store import FQuantConfig
from repro_torch.data.criteo import CriteoConfig, CriteoSynth
from repro_torch.models import embedding as E
from repro_torch.models import recsys as R
from repro_torch.optim import apply_updates, rowwise_adagrad
from repro_torch.optim.optimizers import tree_leaves, tree_map

LR = 0.05


@dataclasses.dataclass
class BenchSetup:
    ds: CriteoSynth
    model: R.Model
    params: dict
    device: torch.device
    train_steps: int = 800
    batch_size: int = 512
    eval_batches: int = 8
    eval_batch_size: int = 1024


def make_setup(num_fields=10, important=5, embed_dim=16, seed=0,
               train_steps=800, *, params: dict | None = None,
               device: str | torch.device | None = None) -> BenchSetup:
    """The bench DLRM over ``num_fields`` synthetic fields (``important``
    of them with a planted signal), on ``device`` (default the GPU)."""
    dev = resolve_device(device)
    ds = CriteoSynth(CriteoConfig(num_fields=num_fields,
                                  important_fields=important,
                                  num_dense=4, noise=0.3, seed=seed))
    model = R.make_dlrm(R.DLRMConfig(
        cardinalities=tuple(int(c) for c in ds.cards), embed_dim=embed_dim,
        num_dense=4, bot_mlp=(32, embed_dim), top_mlp=(64, 1)))
    if params is None:
        params = model.init(generator(dev, seed), dev)
    return BenchSetup(ds=ds, model=model, params=params, device=dev,
                      train_steps=train_steps)


def generator(device: torch.device, seed: int) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def device_batch(batch: dict, device: torch.device) -> dict:
    """A ``ds.batch`` dict of numpy arrays on ``device``: on the card
    through pinned memory, asynchronously."""
    if device.type == "cpu":
        return {k: torch.from_numpy(v) for k, v in batch.items()}
    return {k: torch.from_numpy(v).pin_memory().to(device, non_blocking=True)
            for k, v in batch.items()}


def field_mask_tensor(mask: np.ndarray, device: torch.device
                      ) -> torch.Tensor:
    """A boolean (F,) keep mask as the fp32 mask the models take."""
    return torch.from_numpy(mask.astype(np.float32)).to(device)


def _batch(setup: BenchSetup, step: int) -> dict:
    return device_batch(setup.ds.batch(setup.batch_size, step), setup.device)


@torch.no_grad()
def eval_auc(setup: BenchSetup, params, field_mask=None,
             start_step=10_000) -> float:
    scores, labels = [], []
    for i in range(setup.eval_batches):
        b = device_batch(setup.ds.batch(setup.eval_batch_size,
                                        start_step + i), setup.device)
        scores.append(setup.model.forward(params, b, field_mask))
        labels.append(b["labels"])
    return float(auc(torch.cat(scores), torch.cat(labels)))


# ------------------------------------------------------- training drivers

def grad(fn: Callable, params: dict) -> dict:
    """d fn(params) / d params, as a tree like ``params``."""
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = tree_leaves(p)
    with torch.enable_grad():
        gs = torch.autograd.grad(fn(p), leaves)
    by_id = {id(leaf): g for leaf, g in zip(leaves, gs)}
    return tree_map(lambda t: by_id[id(t)], p)


def _sgd_step(model: R.Model, opt, params: dict, state, batch: dict,
              field_mask=None) -> tuple[dict, object, dict]:
    """One row-wise adagrad step on the mean BCE; returns the new params,
    the optimizer state and the gradients."""
    def loss(p):
        emb = model.embed(p, batch, field_mask)
        return model.loss_from_emb(p, emb, batch).mean()
    g = grad(loss, params)
    upd, state = opt.update(g, state, params)
    return apply_updates(params, upd), state, g


def _init_params(setup: BenchSetup, params, seed: int) -> dict:
    return params if params is not None else setup.model.init(
        generator(setup.device, seed), setup.device)


def train_fp32(setup: BenchSetup, field_mask=None, steps=None,
               params=None, seed=1) -> dict:
    model = setup.model
    params = _init_params(setup, params, seed)
    opt = rowwise_adagrad(LR)
    state = opt.init(params)
    for i in range(steps or setup.train_steps):
        params, state, _ = _sgd_step(model, opt, params, state,
                                     _batch(setup, i), field_mask)
    return params


def train_fquant(setup: BenchSetup, fq_cfg: FQuantConfig, steps=None,
                 seed=1, *, params=None, draw: rq.Draw | None = None
                 ) -> tuple[dict, torch.Tensor]:
    """F-Quantization QAT: per-step Eq. 7 priority + Eq. 8 snap."""
    return train_fquant_core(setup, fq_cfg, None, steps,
                             _init_params(setup, params, seed),
                             draw if draw is not None
                             else generator(setup.device, seed + 99))


def train_fquant_core(setup: BenchSetup, fq_cfg: FQuantConfig, field_mask,
                      steps, params: dict, draw: rq.Draw
                      ) -> tuple[dict, torch.Tensor]:
    """``train_fquant``'s loop (Table 4 adds a field mask): the snap draws
    its stochastic-rounding uniforms over the whole table from ``draw``,
    one (V, D) draw a step when ``fq_cfg.stochastic``."""
    model = setup.model
    spec = model.spec
    opt = rowwise_adagrad(LR)
    state = opt.init(params)
    priority = torch.zeros((spec.total_rows,), dtype=torch.float32,
                           device=setup.device)
    for i in range(steps or setup.train_steps):
        b = _batch(setup, i)
        params, state, _ = _sgd_step(model, opt, params, state, b,
                                     field_mask)
        store = qs.post_step(qs.QATStore(params["embed_table"], priority),
                             E.globalize(b["indices"], spec), b["labels"],
                             fq_cfg, draw=draw)
        params["embed_table"] = store.table
        priority = store.priority
    return params, priority


def train_mpe(setup: BenchSetup, capacity_frac=0.18, policy="lfu",
              steps=None, seed=1, *, params=None,
              draw: rq.Draw | None = None
              ) -> tuple[dict, mpe_lib.MPEState]:
    """MPE baseline: fp32 cache (LFU/LRU) + int8 backing store."""
    model = setup.model
    spec = model.spec
    params = _init_params(setup, params, seed)
    if draw is None:
        draw = generator(setup.device, seed + 7)
    cfg = mpe_lib.MPEConfig(capacity=int(spec.total_rows * capacity_frac),
                            policy=policy, refresh_every=4)
    in_cache = torch.zeros((spec.total_rows,), dtype=torch.bool,
                           device=setup.device)
    in_cache[:cfg.capacity] = True
    mstate = mpe_lib.MPEState(
        table=params["embed_table"],
        priority=torch.zeros((spec.total_rows,), dtype=torch.float32,
                             device=setup.device),
        in_cache=in_cache, step=0)
    opt = rowwise_adagrad(LR)
    state = opt.init(params)
    for i in range(steps or setup.train_steps):
        b = _batch(setup, i)
        params, state, _ = _sgd_step(model, opt, params, state, b)
        mstate = mpe_lib.post_step(
            mstate._replace(table=params["embed_table"]),
            E.globalize(b["indices"], spec), cfg, draw=draw)
        params["embed_table"] = mstate.table
    return params, mstate


def train_alpt(setup: BenchSetup, steps=None, seed=1, *, params=None,
               alpt_state: alpt_lib.ALPTState | None = None,
               draw: rq.Draw | None = None) -> dict:
    """ALPT baseline: int8 storage with learned per-row scales.

    The dense params train as usual; the table's adagrad update is
    computed and dropped, as in the reference, and the table itself
    moves by ``alpt.apply_grads`` on the batch's gradient rows.
    """
    model = setup.model
    spec = model.spec
    params = _init_params(setup, params, seed)
    acfg = alpt_lib.ALPTConfig(scale_lr=1e-4, init_scale=1e-2)
    astate = alpt_state if alpt_state is not None else alpt_lib.init(
        generator(setup.device, seed + 1), spec.total_rows, spec.dim, acfg)
    if draw is None:
        draw = generator(setup.device, seed + 13)
    opt = rowwise_adagrad(LR)
    state = opt.init(params)
    for i in range(steps or setup.train_steps):
        b = _batch(setup, i)
        p_full = dict(params)
        p_full["embed_table"] = alpt_lib.dequant(astate)
        params, state, g = _sgd_step(model, opt, p_full, state, b)
        params.pop("embed_table")
        gidx = E.globalize(b["indices"], spec).reshape(-1).to(torch.int64)
        astate = alpt_lib.apply_grads(astate, g["embed_table"][gidx][None],
                                      gidx[None], LR, acfg, draw)
    out = dict(params)
    out["embed_table"] = alpt_lib.dequant(astate)
    return out


def timed(fn: Callable, *args, repeats=3, **kw):
    """(result, mean seconds a call) over ``repeats`` calls after one
    warm-up call, the card (when there is one) synchronized before each
    clock read."""
    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    fn(*args, **kw)
    sync()
    t0 = time.perf_counter()
    for _ in range(repeats):
        r = fn(*args, **kw)
    sync()
    return r, (time.perf_counter() - t0) / repeats
