"""Optimizers as (init, update) pairs over nested dicts of tensors.

Port of the parts of ``repro/optim/optimizers.py`` that training runs:

    opt = adam(lr=1e-3)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

``adam`` updates the dense params functionally, as the reference does
(they are small).  ``rowwise_adagrad`` is the reference's tree form (one
accumulator a row for params of ndim >= 2, a dense one for 1-D params),
which the paper-table benchmarks train with; a constant learning rate
stays a Python float there, an fp32 scalar in the product as the
reference's, so a step copies nothing from the host.
``rowwise_adagrad_table_update`` is the compressed train step's
optimizer (one accumulator per row) and runs IN PLACE, in row chunks:
the reference's per-row arithmetic, without a (V, D) temporary (at 124M
x 64 one is 31.8 GB).  Scalars (the learning rate, bias corrections) are
fp32 0-d tensors, as the reference's weakly-typed jnp scalars are.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

Tree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Tree]
    update: Callable[..., tuple[Tree, Tree]]  # (grads, state, params)


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the tensor leaves of nested dicts and lists (same
    structure; a tuple is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list[torch.Tensor]:
    """The tensor leaves of nested dicts (in sorted-key order) and lists
    (in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def _resolve_lr(lr, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` as an fp32 0-d tensor on its device
    (``lr`` a float or a schedule ``step -> lr``).  A float is filled in
    on the device: no copy from the host, so no wait on the card."""
    if callable(lr):
        return torch.as_tensor(lr(step), dtype=torch.float32,
                               device=step.device)
    return torch.full((), lr, dtype=torch.float32, device=step.device)


class AdamState(NamedTuple):
    step: torch.Tensor   # int32 ()
    mu: Tree
    nu: Tree


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam; with weight_decay > 0 it is AdamW (decoupled decay)."""

    def init(params):
        some = tree_leaves(params)[0]
        return AdamState(
            step=torch.zeros((), dtype=torch.int32, device=some.device),
            mu=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params),
            nu=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params))

    def update(grads, state, params=None):
        step = state.step + 1
        eta = _resolve_lr(lr, state.step)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
                      state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2)
                      * torch.square(g.to(torch.float32)), state.nu, grads)
        stepf = step.to(torch.float32)
        bc1 = 1 - torch.pow(torch.full((), b1, device=stepf.device), stepf)
        bc2 = 1 - torch.pow(torch.full((), b2, device=stepf.device), stepf)

        def upd_fn(m, v, p):
            u = -eta * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                u = u - eta * weight_decay * p.to(torch.float32)
            return u

        if weight_decay:
            upd = tree_map(upd_fn, mu, nu, params)
        else:
            upd = tree_map(lambda m, v: upd_fn(m, v, None), mu, nu)
        return upd, AdamState(step=step, mu=mu, nu=nu)

    return Optimizer(init, update)


class AdagradState(NamedTuple):
    step: torch.Tensor   # int32 ()
    accum: Tree


def rowwise_adagrad(lr, eps: float = 1e-10, init_accum: float = 0.1,
                    min_ndim: int = 2) -> Optimizer:
    """Adagrad with one accumulator per *row* for >= ``min_ndim``-dim
    params (state V floats, not V x D); 1-D params (biases) fall back to
    dense adagrad.

        accum += mean(g^2 over the trailing axes);  u = -lr g / (sqrt(accum) + eps)
    """

    def _rowwise(p: torch.Tensor) -> bool:
        return p.ndim >= min_ndim

    def init(params):
        some = tree_leaves(params)[0]

        def acc(p):
            shape = p.shape[:1] if _rowwise(p) else p.shape
            return torch.full(shape, init_accum, dtype=torch.float32,
                              device=p.device)
        return AdagradState(
            step=torch.zeros((), dtype=torch.int32, device=some.device),
            accum=tree_map(acc, params))

    def update(grads, state, params):
        neg_eta = -(_resolve_lr(lr, state.step) if callable(lr)
                    else float(lr))
        def upd_acc(g, a, p):
            g = g.to(torch.float32)
            if _rowwise(p):
                a2 = a + torch.mean(torch.square(g),
                                    dim=tuple(range(1, g.ndim)))
                den = torch.sqrt(a2).reshape(a2.shape + (1,) * (g.ndim - 1))
            else:
                a2 = a + torch.square(g)
                den = torch.sqrt(a2)
            return neg_eta * g / (den + eps), a2

        pairs = tree_map(upd_acc, grads, state.accum, params)
        upd = tree_map(lambda t: t[0], pairs)        # a tuple is a leaf
        accum = tree_map(lambda t: t[1], pairs)
        return upd, AdagradState(step=state.step + 1, accum=accum)

    return Optimizer(init, update)


def rowwise_adagrad_table_update(table: torch.Tensor, accum: torch.Tensor,
                                 grad: torch.Tensor, lr,
                                 step: torch.Tensor | None = None,
                                 eps: float = 1e-10,
                                 chunk_rows: int = 1 << 22
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One row-wise adagrad step on a (V, D) table, in place.

        accum += mean(grad^2, axis=-1);  table += -lr * grad / (sqrt(accum) + eps)

    ``table`` and ``accum`` are updated in place, ``chunk_rows`` rows at a
    time, and returned.  Rows whose gradient is zero (every row the batch
    did not touch: the scatter emits exact zeros) keep their values and
    accumulators, as in the reference's dense pass.
    """
    if step is None:
        step = torch.zeros((), dtype=torch.int32, device=table.device)
    neg_eta = -_resolve_lr(lr, step)
    for r0 in range(0, table.shape[0], chunk_rows):
        sl = slice(r0, r0 + chunk_rows)
        g = grad[sl].to(torch.float32)
        a = accum[sl]
        a += torch.mean(torch.square(g), dim=-1)
        table[sl] += (neg_eta * g / (torch.sqrt(a)[:, None] + eps)
                      ).to(table.dtype)
    return table, accum
