"""In-training importance accumulators: Taylor field scores + row access.

Port of ``repro/train/accum.py``.  ``TaylorAccum`` folds SHARK's two
training-derived compression signals into the train step, from values
the step already holds:

  * ``field_score`` (F,) — running sum of the Eq. 4 estimate
    ``dLoss/de_i(x) . (E[e_i] - e_i(x))`` per field, scored against the
    streaming field mean of the batches before (prequential);
  * ``emb_mean`` (F, D) — that streaming mean E[e_i];
  * ``access`` (V,) — the Eq. 7 EMA folded as serving folds it
    (``priority.serve_update``: every access enters as c-);
  * ``count`` () — samples folded.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.priority import PriorityConfig, serve_update


class TaylorAccum(NamedTuple):
    field_score: torch.Tensor   # (F,)
    emb_mean: torch.Tensor      # (F, D)
    access: torch.Tensor        # (V,)
    count: torch.Tensor         # ()


def init_accum(vocab: int, num_fields: int, dim: int,
               device: torch.device) -> TaylorAccum:
    z = dict(dtype=torch.float32, device=device)
    return TaylorAccum(field_score=torch.zeros((num_fields,), **z),
                       emb_mean=torch.zeros((num_fields, dim), **z),
                       access=torch.zeros((vocab,), **z),
                       count=torch.zeros((), **z))


def update_accum(acc: TaylorAccum, gidx: torch.Tensor, emb: torch.Tensor,
                 g_emb: torch.Tensor, pcfg: PriorityConfig = PriorityConfig(),
                 valid: torch.Tensor | None = None) -> TaylorAccum:
    """Fold one batch: gidx (B, F) global rows, emb (B, F, D) gathered
    embeddings, g_emb (B, F, D) the loss cotangent w.r.t. ``emb``;
    ``valid`` (B,) masks padded samples out of every statistic.  The
    Taylor fold (``update_taylor``) and the access EMA; a placed state's
    step runs the two apart, the EMA a row shard at a time."""
    vmask = None if valid is None else valid[:, None].expand(gidx.shape)
    return update_taylor(acc, emb, g_emb, valid)._replace(
        access=serve_update(acc.access, gidx, pcfg, valid=vmask))


def update_taylor(acc: TaylorAccum, emb: torch.Tensor, g_emb: torch.Tensor,
                  valid: torch.Tensor | None = None) -> TaylorAccum:
    """``update_accum``'s field score, embedding mean and count (``access``
    as it is): from the batch's (B, F, D) ``emb`` and ``g_emb`` only."""
    b = emb.shape[0]
    if valid is not None:
        m = valid.to(torch.float32)
        emb_stat = emb * m[:, None, None]
        g_stat = g_emb * m[:, None, None]
        n = m.sum()
        batch_mean = emb_stat.sum(dim=0) / torch.clamp_min(n, 1.0)
    else:
        g_stat = g_emb
        n = torch.full((), float(b), dtype=torch.float32, device=emb.device)
        batch_mean = emb.mean(dim=0)
    delta = acc.emb_mean[None, :, :] - emb
    score = torch.einsum("bfd,bfd->f", g_stat, delta)
    new_count = acc.count + n
    denom = torch.clamp_min(new_count, 1.0)
    w_old = torch.where(new_count > 0, acc.count / denom, 0.0)
    w_new = torch.where(new_count > 0, n / denom, 0.0)
    return acc._replace(field_score=acc.field_score + score,
                        emb_mean=w_old * acc.emb_mean + w_new * batch_mean,
                        count=new_count)


def field_scores(acc: TaylorAccum) -> torch.Tensor:
    """Mean Eq. 4 score per field (lower = less important)."""
    return acc.field_score / torch.clamp_min(acc.count, 1.0)
