"""Optimizers as (init, update) pairs over nested dicts of tensors.

Port of the parts of ``repro/optim/optimizers.py`` that training runs:

    opt = adam(lr=1e-3)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

``adam`` updates the dense params functionally, as the reference does
(they are small).  ``rowwise_adagrad_table_update`` is the table's
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
    """``fn`` over the tensor leaves of nested dicts (same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list[torch.Tensor]:
    """The tensor leaves of nested dicts, in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def _resolve_lr(lr, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` as an fp32 0-d tensor on its device
    (``lr`` a float or a schedule ``step -> lr``)."""
    if callable(lr):
        return torch.as_tensor(lr(step), dtype=torch.float32,
                               device=step.device)
    return torch.tensor(lr, dtype=torch.float32, device=step.device)


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
        bc1 = 1 - torch.pow(torch.tensor(b1, device=stepf.device), stepf)
        bc2 = 1 - torch.pow(torch.tensor(b2, device=stepf.device), stepf)

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
