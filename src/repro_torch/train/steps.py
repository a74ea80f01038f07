"""Train steps: the generic step with F-Quantization hooks, and the
compressed step (serving kernels + Eq. 5-8 fold + in-training
Taylor/access accumulation, in one backward).

``make_train_step`` / ``init_state`` / ``FQuantHook`` port the
reference's generic factory (``repro/train/steps.py:39-97``), what the
recsys family smoke (``configs.common.RecsysArch.smoke``) runs: the loss
and its gradients over every parameter (eager autograd), the
optimizer's update, then the hook's ``qat_store.post_step`` (or
``post_step_sparse``) on the table.  Where the reference splits a
``jax.random`` key for the int8 tier's stochastic rounding, the state
carries a ``torch.Generator`` (``rng``), so the rounding's draws differ
from the reference's; everything else of a step is the same function.

``make_compressed_train_step`` ports
``repro/train/steps.py::make_compressed_train_step``: the fp32
table and the hashed pool, on one device or row-sharded over a mesh.  One
step computes, in the reference's order:

    emb      = lookup_train(table, gidx)        dequant_bag kernel
    g_emb    = d loss / d emb                   head backward (autograd)
    g_table  = BagTrain.backward(g_emb)         zero fill + bag_grad kernel
    table    = rowwise_adagrad(table, g_table)  in place, in row chunks
    dense    = adam(dense, g_dense)
    priority = Eq. 7(priority, gidx, labels)    + Eq. 5-6 snap of the
                                                touched rows, in place
    accum    = Taylor Eq. 4 fold + Eq. 7 access EMA

With ``hashed_cfg`` (a ``store.hashed.HashedConfig``) ``params[table]``
holds the (S, Z) chunk pool instead: the gather is ``HashedTrain`` (the
``hashed_gather`` kernel's plan entry forward, ``bag_grad`` into the pool
backward), row-wise adagrad runs per pool slot with an (S,) accumulator,
there is no Eq. 5-6 snap (pool slots are shared by rows), and Eq. 7 still
folds per virtual row into a (V,) priority (the jitted reference's FMA
form, ``priority.priority_update_from_batch``), which picks the serving
cache.  ``TaylorAccum`` is sized by ``hashed_cfg.vocab`` and ``.dim``.

With ``mesh`` (a ``dist.Mesh``) the step takes the state as the
reference's ``place_train_state`` places it (``train.setup``): the
table, its adagrad accumulator, the priority and the access EMA are
``dist.packed.RowShards``, shard ``i`` on ``mesh.devices[i]`` (row views
of one tensor on a one-device mesh), the rest on the mesh's first
device.  The gather runs a ``dequant_bag`` a shard on its device, summed
in shard order, and the backward a ``bag_grad`` a shard into that
shard's own gradient (``dist.packed.ShardedBagTrain``); adagrad, the
Eq. 7 decay, the snap of the shard's own slots (its noise keyed by the
global rows) and the access EMA then run a shard at a time, and the
head, Adam and the Taylor fold once.  The table's rows must divide the
mesh's axis.  Each row's arithmetic is the unsharded step's, so every
leaf is the mesh-1 step's bit for bit, on one device or several.  The
hashed pool stays whole on the mesh's first device (the reference
places only the table): ``dist.hashed.sharded_hashed_lookup_train`` runs
its plan entry and ``bag_grad`` a shard, and the rest of the step is the
unsharded one.  The hashed forward sums each chunk's draws a shard at a
time, so its rows, and the loss, are the unsharded ones up to that
rounding.

The table (or pool) is updated in place (the reference's update is
functional; at 124M x 64 a second table does not fit beside the
gradient).  So the NaN
guard moves into the step: a non-finite loss returns the state as it was,
before any update, and the loop counts the skip as the reference's loop
does.  ``step(state, batch, mark=fn)`` calls ``fn(stage)`` after each
stage (gather, head, scatter, adagrad, adam, post_step_sparse, accum),
for per-stage timing; without it the step records nothing.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import priority as priority_lib
from repro_torch.core import qat_store
from repro_torch.core import rowwise_quant as rq
from repro_torch.core.qat_store import FQuantConfig
from repro_torch.dist.hashed import sharded_hashed_lookup_train
from repro_torch.dist.mesh import check_mesh
from repro_torch.dist.packed import (RowShards, ShardedBagTrain,
                                     owned_slots, train_plan)
from repro_torch.kernels.dequant_bag.autodiff import lookup_train
from repro_torch.kernels.hashed_gather.autodiff import hashed_lookup_train
from repro_torch.optim import optimizers as opt_lib
from repro_torch.train import accum as accum_lib


class TrainState(NamedTuple):
    params: Any
    opt: Any
    step: torch.Tensor        # int32 ()
    priority: Any = None      # fquant row priorities (or None)
    rng: Any = None           # the compressed step: the reference's PRNG
                              # key leaf, uint32 (2,); the generic step: a
                              # torch.Generator
    accum: Any = None         # train.accum.TaylorAccum (or None)


class FQuantHook(NamedTuple):
    """How F-Quantization attaches to a model's params."""
    cfg: FQuantConfig
    table_path: str                       # params key holding the table
    indices_fn: Callable[[dict], torch.Tensor]   # batch -> row indices
    labels_fn: Callable[[dict], torch.Tensor]    # batch -> labels
    sparse_snap: bool = False             # touched-rows-only write path


def init_state(params, optimizer: opt_lib.Optimizer,
               fquant: FQuantHook | None = None, seed: int = 0
               ) -> TrainState:
    """The generic step's initial state: zero priorities over the hook's
    table and a ``torch.Generator`` seeded with ``seed`` on the params'
    device (on ``meta``, a dry run's, the draw source
    ``rowwise_quant.meta_uniform``)."""
    dev = opt_lib.tree_leaves(params)[0].device
    pri = None
    if fquant is not None:
        pri = torch.zeros((params[fquant.table_path].shape[0],),
                          dtype=torch.float32, device=dev)
    if dev.type == "meta":
        rng = rq.meta_uniform
    else:
        rng = torch.Generator(device=dev)
        rng.manual_seed(seed)
    return TrainState(params=params, opt=optimizer.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev),
                      priority=pri, rng=rng)


def make_train_step(loss_fn: Callable, optimizer: opt_lib.Optimizer,
                    fquant: FQuantHook | None = None,
                    with_metrics: bool = True) -> Callable:
    """loss_fn(params, batch) -> scalar.  Returns step(state, batch) ->
    (state, {"loss", "grad_norm"})."""

    def step(state: TrainState, batch: dict):
        with torch.enable_grad():
            p = opt_lib.tree_map(lambda x: x.detach().requires_grad_(),
                                 state.params)
            leaves = opt_lib.tree_leaves(p)
            loss = loss_fn(p, batch)
            raw = torch.autograd.grad(loss, leaves, allow_unused=True)
        by_id = {id(x): torch.zeros_like(x) if gr is None else gr
                 for x, gr in zip(leaves, raw)}
        grads = opt_lib.tree_map(lambda x: by_id[id(x)], p)
        updates, opt = optimizer.update(grads, state.opt, state.params)
        params = opt_lib.apply_updates(state.params, updates)

        priority = state.priority
        if fquant is not None:
            store = qat_store.QATStore(table=params[fquant.table_path],
                                       priority=priority)
            if fquant.sparse_snap:
                store = qat_store.post_step_sparse(
                    store, fquant.indices_fn(batch), fquant.labels_fn(batch),
                    fquant.cfg, seed=state.step)
            else:
                store = qat_store.post_step(
                    store, fquant.indices_fn(batch), fquant.labels_fn(batch),
                    fquant.cfg, draw=state.rng)
            params = dict(params)
            params[fquant.table_path] = store.table
            priority = store.priority

        metrics = {"loss": loss.detach()}
        if with_metrics:
            metrics["grad_norm"] = opt_lib.global_norm(grads)
        return TrainState(params=params, opt=opt, step=state.step + 1,
                          priority=priority, rng=state.rng), metrics

    return step


def make_sparse_table_train_step(embed_fn: Callable, loss_from_emb: Callable,
                                 indices_fn: Callable, labels_fn: Callable,
                                 table_path: str, lr: float,
                                 fq_cfg: FQuantConfig | None = None,
                                 dense_optimizer: opt_lib.Optimizer | None
                                 = None, eps: float = 1e-10) -> Callable:
    """A recsys step whose table update touches only the batch's rows.

    Port of ``repro/train/steps.py::make_sparse_table_train_step`` (the
    dry run's ``"optimized"`` recsys train cell).  The gradient is taken
    w.r.t. the gathered rows, not the (V, D) table:

        emb = table[idx]                             (B, F, D)
        accum[idx] += mean(g_emb^2, -1)              touched rows only
        table[idx] += -lr g_emb / (sqrt(accum[idx]) + eps)
        the dense params by ``dense_optimizer`` (Adam by default)
        Eq. 7 priorities + the sparse snap

    The accumulator and the table are updated in place (``index_add_``:
    a repeated row's terms add in the batch's order).  State:
    ``TrainState`` with opt = (dense_opt_state, accum (V,)).
    """
    del embed_fn   # the rows are gathered here, as the reference does
    dense_optimizer = dense_optimizer or opt_lib.adam(lr)

    def init_state(params) -> TrainState:
        table = params[table_path]
        dense = {k: v for k, v in params.items() if k != table_path}
        dev = table.device
        vocab = table.shape[0]
        opt = (dense_optimizer.init(dense),
               torch.full((vocab,), 0.1, dtype=torch.float32, device=dev))
        pri = (torch.zeros((vocab,), dtype=torch.float32, device=dev)
               if fq_cfg else None)
        return TrainState(params=params, opt=opt,
                          step=torch.zeros((), dtype=torch.int32,
                                           device=dev), priority=pri)

    def step(state: TrainState, batch: dict):
        params = state.params
        table = params[table_path]
        dense = {k: v for k, v in params.items() if k != table_path}
        gidx = indices_fn(batch)
        flat = gidx.reshape(-1).to(torch.int64)
        with torch.enable_grad():
            rows = table[flat].reshape(gidx.shape + (table.shape[1],)
                                       ).requires_grad_()
            dense_in = opt_lib.tree_map(
                lambda x: x.detach().requires_grad_(), dense)
            p = dict(dense_in)
            p[table_path] = table       # heads must not touch the table
            loss = loss_from_emb(p, rows, batch).mean()
            leaves = opt_lib.tree_leaves(dense_in)
            grads = torch.autograd.grad(loss, leaves + [rows])
        by_id = {id(x): gr for x, gr in zip(leaves, grads)}
        g_dense = opt_lib.tree_map(lambda x: by_id[id(x)], dense_in)

        dense_opt_state, accum = state.opt
        g_rows = grads[-1].reshape(-1, table.shape[1])
        accum.index_add_(0, flat, torch.mean(torch.square(g_rows), dim=-1))
        denom = torch.sqrt(accum[flat]) + eps
        table.index_add_(0, flat, -lr * g_rows / denom[:, None])

        upd, dense_opt_state = dense_optimizer.update(g_dense,
                                                      dense_opt_state, dense)
        dense = opt_lib.apply_updates(dense, upd)

        priority = state.priority
        if fq_cfg is not None:
            store = qat_store.post_step_sparse(
                qat_store.QATStore(table=table, priority=priority), gidx,
                labels_fn(batch), fq_cfg, seed=state.step)
            priority = store.priority

        params = dict(dense)
        params[table_path] = table
        return (TrainState(params=params, opt=(dense_opt_state, accum),
                           step=state.step + 1, priority=priority,
                           rng=state.rng),
                {"loss": loss.detach(),
                 "grad_norm": opt_lib.global_norm(g_dense)})

    step.init_state = init_state
    return step


def make_compressed_train_step(loss_from_emb: Callable,
                               indices_fn: Callable, labels_fn: Callable,
                               table_path: str, lr, num_fields: int,
                               fq_cfg: FQuantConfig | None = None,
                               dense_optimizer: opt_lib.Optimizer | None
                               = None,
                               mesh=None, axis: str = "model",
                               with_accum: bool = True,
                               field_mask=None, hashed_cfg=None,
                               eps: float = 1e-10) -> Callable:
    """``step(state, batch, mark=None) -> (state, metrics)``, with
    ``step.init_state(params)`` the initial state.

    State: ``TrainState`` with opt = (dense_opt_state, adagrad accum (V,),
    or (S,) for a pool) and ``accum`` a ``TaylorAccum``.  ``field_mask``
    (F,) zeroes pruned fields inside the loss.  ``mesh`` (a ``dist.Mesh``
    along ``axis``) runs the row-sharded step over a placed state
    (``train.setup.place_train_state``; ``init_state`` returns the whole
    state, to be placed).
    """
    dense_optimizer = dense_optimizer or opt_lib.adam(lr)
    pcfg = (fq_cfg or FQuantConfig()).priority
    if mesh is not None:
        check_mesh(mesh, axis)
    if hashed_cfg is not None and mesh is not None:
        def gather(tbl, gidx):      # plan entry + bag_grad, a shard each
            return sharded_hashed_lookup_train(
                tbl, gidx, num_chunks=hashed_cfg.num_chunks,
                num_hashes=hashed_cfg.num_hashes,
                num_slots=hashed_cfg.num_slots, seed=hashed_cfg.seed,
                mesh=mesh, axis=axis)
    elif hashed_cfg is not None:
        def gather(tbl, gidx):      # hashed_gather plan entry + bag_grad
            return hashed_lookup_train(
                tbl, gidx, num_chunks=hashed_cfg.num_chunks,
                num_hashes=hashed_cfg.num_hashes, seed=hashed_cfg.seed)
    else:
        gather = lookup_train       # dequant_bag + bag_grad
    placed = mesh is not None and hashed_cfg is None

    def init_state(params) -> TrainState:
        table = params[table_path]
        dev = table.device
        dense = {k: v for k, v in params.items() if k != table_path}
        if hashed_cfg is not None:
            vocab, dim = hashed_cfg.vocab, hashed_cfg.dim
        else:
            vocab, dim = table.shape
        # adagrad accumulator: one cell a trained row (pool slots for the
        # hashed form, vocab rows otherwise)
        opt = (dense_optimizer.init(dense),
               torch.full((table.shape[0],), 0.1, dtype=torch.float32,
                          device=dev))
        pri = (torch.zeros((vocab,), dtype=torch.float32, device=dev)
               if fq_cfg is not None or hashed_cfg is not None else None)
        acc = (accum_lib.init_accum(vocab, num_fields, dim, dev)
               if with_accum else None)
        return TrainState(params=params, opt=opt,
                          step=torch.zeros((), dtype=torch.int32,
                                           device=dev),
                          priority=pri,
                          rng=torch.zeros((2,), dtype=torch.uint32,
                                          device=dev),
                          accum=acc)

    def head(emb_out, dense, table, batch):
        """Loss, the gathered rows, the dense gradients and the rows'
        cotangent."""
        emb = emb_out.detach().requires_grad_()
        dense_in = opt_lib.tree_map(
            lambda x: x.detach().requires_grad_(), dense)
        e = emb
        if field_mask is not None:
            e = e * torch.as_tensor(field_mask, dtype=torch.float32,
                                    device=e.device)[None, :, None]
        p = dict(dense_in)
        p[table_path] = table       # heads must not touch the table
        loss = loss_from_emb(p, e, batch).mean()
        leaves = opt_lib.tree_leaves(dense_in)
        grads = torch.autograd.grad(loss, leaves + [emb])
        by_id = {id(x): gr for x, gr in zip(leaves, grads)}
        g_dense = opt_lib.tree_map(lambda x: by_id[id(x)], dense_in)
        return loss.detach(), emb.detach(), g_dense, grads[-1]

    def skipped(state, loss):
        """A non-finite loss: the state as it was, before any update."""
        return state, {"loss": loss,
                       "grad_norm": torch.full_like(loss, torch.nan)}

    def updated(state, dense, table, opt, priority, acc, loss, g_dense):
        params = dict(dense)
        params[table_path] = table
        return (TrainState(params=params, opt=opt, step=state.step + 1,
                           priority=priority, rng=state.rng, accum=acc),
                {"loss": loss, "grad_norm": opt_lib.global_norm(g_dense)})

    def step(state: TrainState, batch: dict,
             mark: Callable[[str], None] | None = None):
        if placed:
            return sharded_step(state, batch, mark or (lambda stage: None))
        mark = mark or (lambda stage: None)
        params = state.params
        table = params[table_path]
        dense = {k: v for k, v in params.items() if k != table_path}
        gidx = indices_fn(batch)                       # (B, F) global

        with torch.enable_grad():
            leaf = table.detach().requires_grad_()
            emb_out = gather(leaf, gidx)               # the gather kernel
            mark("gather")
            loss, emb, g_dense, g_emb = head(emb_out, dense, table, batch)
            if not bool(torch.isfinite(loss)):
                return skipped(state, loss)
            mark("head")
            (g_table,) = torch.autograd.grad(emb_out, leaf, g_emb)
        del emb_out, leaf
        mark("scatter")

        dense_opt_state, accum_sq = state.opt
        opt_lib.rowwise_adagrad_table_update(table, accum_sq, g_table, lr,
                                             step=state.step, eps=eps)
        del g_table
        mark("adagrad")

        upd, dense_opt_state = dense_optimizer.update(g_dense,
                                                      dense_opt_state, dense)
        dense = opt_lib.apply_updates(dense, upd)
        mark("adam")

        priority = state.priority
        if hashed_cfg is not None:
            # shared pool slots cannot snap per row; Eq. 7 still folds per
            # virtual row (the serving cache, field-prune ranking)
            priority = priority_lib.priority_update_from_batch(
                priority, gidx, labels_fn(batch), pcfg)
        elif fq_cfg is not None:
            store = qat_store.post_step_sparse(
                qat_store.QATStore(table=table, priority=priority), gidx,
                labels_fn(batch), fq_cfg, seed=state.step)
            priority = store.priority
        mark("post_step_sparse")

        acc = state.accum
        if acc is not None:
            acc = accum_lib.update_accum(acc, gidx, emb, g_emb, pcfg)
        mark("accum")

        return updated(state, dense, table, (dense_opt_state, accum_sq),
                       priority, acc, loss, g_dense)

    def sharded_step(state: TrainState, batch: dict,
                     mark: Callable[[str], None]):
        """The step over a placed state (``train.setup.place_train_state``):
        the table, its adagrad accumulator, the priority and the access
        EMA are ``RowShards``, each shard on its device; the rest lives on
        the mesh's first device.  The gather and scatter run a shard on
        its device (``ShardedBagTrain``), and so do adagrad, the Eq. 7
        decay, the snap of the shard's own slots and the access EMA; the
        head, Adam and the Taylor fold run once.  Each row's arithmetic
        is the unsharded step's, so every leaf is bit for bit the
        one-device mesh-1 step's.  The per-shard loops wait on no device:
        the step's one host read, after the head, takes the loss's
        finiteness and the slots each shard owns together."""
        params = state.params
        table = params[table_path]
        if not isinstance(table, RowShards):
            raise TypeError("the sharded step takes a placed state "
                            "(train.setup.place_train_state), got a "
                            f"{type(table).__name__} table")
        if table.mesh.size != mesh.size:
            raise ValueError(f"state placed over {table.mesh.size} shards, "
                             f"step built for {mesh.size}")
        smesh, windows = table.mesh, table.windows
        dense = {k: v for k, v in params.items() if k != table_path}
        gidx = indices_fn(batch)                       # (B, F) global
        flat = gidx.reshape(-1, 1).to(torch.int64)
        plan = train_plan(flat, windows, smesh)

        with torch.enable_grad():
            leaves = [s.detach().requires_grad_() for s in table.shards]
            emb_out = ShardedBagTrain.apply(plan, smesh, *leaves).reshape(
                *gidx.shape, table.shape[1])
            mark("gather")
            loss, emb, g_dense, g_emb = head(emb_out, dense, table, batch)
            # the step's one host read: the loss's finiteness and the
            # slots each shard owns, together
            finite, *sizes = torch.cat([
                torch.isfinite(loss).reshape(1).to(torch.int64),
                plan.counts]).tolist()
            if not finite:
                return skipped(state, loss)
            labels = labels_fn(batch)
            owned = owned_slots(plan, smesh, sizes, flat,
                                labels[:, None].expand(gidx.shape))
            mark("head")
            g_shards = list(torch.autograd.grad(emb_out, leaves, g_emb))
        del emb_out, leaves
        mark("scatter")

        steps = {d: state.step.to(d) for d in smesh.distinct_devices()}
        dense_opt_state, accum_sq = state.opt
        for i, dev in enumerate(smesh.devices):
            g, g_shards[i] = g_shards[i], None
            opt_lib.rowwise_adagrad_table_update(
                table.shards[i], accum_sq.shards[i], g, lr, step=steps[dev],
                eps=eps)
            del g
        mark("adagrad")

        upd, dense_opt_state = dense_optimizer.update(g_dense,
                                                      dense_opt_state, dense)
        dense = opt_lib.apply_updates(dense, upd)
        mark("adam")

        local = [glob - first for (glob, _), (first, _)
                 in zip(owned, windows)]
        priority = state.priority
        if fq_cfg is not None:
            priority = priority.like([
                qat_store.post_step_sparse(
                    qat_store.QATStore(table=tbl, priority=pri), loc, lab,
                    fq_cfg, seed=steps[dev], first=first).priority
                for tbl, pri, loc, (_, lab), (first, _), dev
                in zip(table.shards, priority.shards, local, owned,
                       windows, smesh.devices)])
        mark("post_step_sparse")

        acc = state.accum
        if acc is not None:
            acc = accum_lib.update_taylor(acc, emb, g_emb)._replace(
                access=acc.access.like([
                    priority_lib.serve_update(a, loc, pcfg)
                    for a, loc in zip(acc.access.shards, local)]))
        mark("accum")

        return updated(state, dense, table, (dense_opt_state, accum_sq),
                       priority, acc, loss, g_dense)

    step.init_state = init_state
    return step
