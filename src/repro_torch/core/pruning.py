"""Iterative prune -> finetune -> evaluate (SHARK Algorithm 1).

Port of ``repro/core/pruning.py``.  Feature fields are removed by
masking: the model takes a ``field_mask`` (F,) and zeroes the masked
fields' embeddings, so every shape stays the same across iterations;
the memory account still credits the masked tables' full bytes, as the
paper reports its compression rate.  After the loop a caller can drop
the masked tables for serving (the pipeline zeroes their rows).

Termination (paper Sec. 3.1.3): stop when the remaining-memory fraction
falls to ``rate_c``, or when the eval quality falls below
``t_accuracy`` x the base quality; in the second case the last step's
victims are put back (the paper keeps the last model that met the
guard).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from repro_torch.core import taylor


@dataclasses.dataclass
class PruneConfig:
    rate_c: float = 0.5          # stop when remaining-memory fraction <= this
    t_accuracy: float = 0.9925   # stop when metric < t_accuracy * base
    fields_per_iter: int = 1     # f in Algorithm 1 (default 1, as in paper)
    finetune_steps: int = 50     # support-set finetune per iteration
    score_order: int = 1         # 1st- or 2nd-order Taylor
    protected: Sequence[int] = ()  # fields that may never be pruned


@dataclasses.dataclass
class PruneLogEntry:
    iteration: int
    pruned_field: int
    scores: np.ndarray
    metric: float
    remaining_memory: float
    seconds: float


@dataclasses.dataclass
class PruneResult:
    field_mask: np.ndarray        # bool (F,): True = kept
    params: object                # finetuned params
    base_metric: float
    final_metric: float
    remaining_memory: float
    log: list[PruneLogEntry]

    def ranking(self) -> np.ndarray:
        """Fields in pruning order (least important first)."""
        return np.array([e.pruned_field for e in self.log])


def memory_fraction(field_mask, table_bytes: Sequence[int]) -> float:
    """Remaining embedding-memory fraction under the mask."""
    total = float(sum(table_bytes))
    kept = float(sum(b for b, m in zip(table_bytes, field_mask) if m))
    return kept / max(total, 1.0)


def prune_loop(params,
               embed_fn: Callable,
               loss_fn: Callable,
               eval_metric_fn: Callable,
               finetune_fn: Callable,
               eval_batches_factory: Callable[[], Iterable],
               table_bytes: Sequence[int],
               cfg: PruneConfig = PruneConfig(),
               mask: np.ndarray | None = None) -> PruneResult:
    """Algorithm 1.

    embed_fn(params, batch, field_mask)   -> (B, F, D)
    loss_fn(params, emb, batch)           -> (B,)
    eval_metric_fn(params, field_mask)    -> float metric (higher = better)
    finetune_fn(params, field_mask, steps)-> params  (support-set training)
    eval_batches_factory()                -> iterable of eval batches
    table_bytes[i]                        -> bytes of field i's table

    ``field_mask`` reaches the callables as a bool tensor (F,).
    """
    num_fields = len(table_bytes)
    mask = np.ones(num_fields, bool) if mask is None else mask.copy()

    base_metric = float(eval_metric_fn(params, torch.from_numpy(mask)))
    metric = base_metric
    rate_t = memory_fraction(mask, table_bytes)
    log: list[PruneLogEntry] = []
    it = 0

    while rate_t > cfg.rate_c and metric >= cfg.t_accuracy * base_metric:
        t0 = time.perf_counter()
        tmask = torch.from_numpy(mask.copy())
        scores, _, _ = taylor.fperm_scores(
            lambda p, b: embed_fn(p, b, tmask), loss_fn, params,
            eval_batches_factory(), order=cfg.score_order)
        scores_np = scores.detach().cpu().numpy().copy()
        # never re-prune dead fields / protected fields
        scores_np[~mask] = np.inf
        for p in cfg.protected:
            scores_np[p] = np.inf

        victims = np.argsort(scores_np)[:cfg.fields_per_iter]
        victims = [int(v) for v in victims if np.isfinite(scores_np[v])]
        if not victims:
            break
        for v in victims:
            mask[v] = False

        tmask = torch.from_numpy(mask.copy())
        params = finetune_fn(params, tmask, cfg.finetune_steps)
        metric = float(eval_metric_fn(params, tmask))
        rate_t = memory_fraction(mask, table_bytes)
        dt = time.perf_counter() - t0
        for v in victims:
            log.append(PruneLogEntry(
                iteration=it, pruned_field=v,
                scores=scores.detach().cpu().numpy(), metric=metric,
                remaining_memory=rate_t, seconds=dt))
        it += 1
        if metric < cfg.t_accuracy * base_metric:
            # keep the last model that met the guard: roll the mask back
            for v in victims:
                mask[v] = True
            rate_t = memory_fraction(mask, table_bytes)
            break

    return PruneResult(field_mask=mask, params=params,
                       base_metric=base_metric, final_metric=metric,
                       remaining_memory=rate_t, log=log)


def rank_correlation(order_a: Sequence[int], order_b: Sequence[int]
                     ) -> float:
    """Spearman rho between two field orderings (planted vs recovered)."""
    a = np.asarray(order_a, float)
    b = np.asarray(order_b, float)
    ra = np.empty_like(a)
    rb = np.empty_like(b)
    ra[np.argsort(a)] = np.arange(len(a))
    rb[np.argsort(b)] = np.arange(len(b))
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra ** 2).sum() * (rb ** 2).sum())
    return float((ra * rb).sum() / max(denom, 1e-12))
