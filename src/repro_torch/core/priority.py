"""Frequency-based row priority scores (SHARK Eq. 7).

    w_r^(t+1) = (1 - beta) * w_r^(t) + beta * (alpha * c+ + c-)

Port of ``repro/core/priority.py``.  c+ / c- count the positive /
negative examples of the batch whose feature values hit row r; alpha
(=2) up-weights positives, beta (=0.99) is the time-decay rate.  Every
row decays each batch; untouched rows have c+ = c- = 0.

The reference's segment sums become ``index_add_``: the counts are
integers (exact in fp32 below 2^24), so the order of the adds does not
matter and the result is the same on every device.

The reference computes the EMA in two ways, and the port copies each
where its caller runs it:

* jitted (the train step, and its access accumulator): XLA contracts it
  into one FMA, ``fma(1 - beta, w, beta * target)``, which
  ``priority_update`` reproduces exactly with ``fma_f32`` (in float64,
  in chunks to bound the temporaries);
* eager (the online server's fold, ``OnlineServer.observe`` ->
  ``PackedBackend.fold_priority`` -> ``serve_update`` with no ``jit``):
  each op rounds on its own, ``(1 - beta) * w + beta * target``, which
  ``serve_fold`` computes (through ``fold_counts``, which the fleet's
  pooled merge of replica counts shares).  The two differ
  in the last bit for some rows, and tiers are cut from these scores.

Both flush subnormal results to zero, as XLA does: with 1 - beta = 0.01
a row unseen for ~20 steps decays into the subnormal range, where
PyTorch (on the CPU and the card) would keep what the reference zeroes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.dequant_bag.ref import fma_f32

_CHUNK = 1 << 24
# |x| at or below it is a subnormal fp32: hardshrink by it flushes to zero
_LARGEST_SUBNORMAL = 1.1754942106924411e-38


class PriorityConfig(NamedTuple):
    alpha: float = 2.0   # importance weight of positive examples
    beta: float = 0.99   # time-decay rate


def batch_counts(indices: torch.Tensor, labels: torch.Tensor, vocab: int,
                 valid: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row positive/negative hit counts for one batch.

    indices: int (B, F) with per-sample ``labels`` (B,) in {0, 1}, or
    flat (N,) with labels (N,).  ``valid`` (same shape as indices) masks
    padding out.  Returns (c_pos, c_neg), each fp32 (vocab,).
    """
    if indices.dim() == 2:
        lab = labels[:, None].expand(indices.shape).reshape(-1)
    else:
        lab = labels.reshape(-1)
    idx = indices.reshape(-1).to(torch.int64)
    pos = lab.to(torch.float32)
    neg = 1.0 - pos
    if valid is not None:
        m = valid.reshape(-1).to(torch.float32)
        pos, neg = pos * m, neg * m

    def count(x):
        return torch.zeros(vocab, dtype=torch.float32,
                           device=idx.device).index_add_(0, idx, x)
    return count(pos), count(neg)


def priority_update(w: torch.Tensor, c_pos: torch.Tensor,
                    c_neg: torch.Tensor,
                    cfg: PriorityConfig = PriorityConfig()) -> torch.Tensor:
    """One Eq. 7 step.  w, c_pos, c_neg: (vocab,) fp32 -> new (vocab,).

    Subnormal results are flushed to zero, as the reference's XLA
    flushes them (see ``serve_fold``)."""
    decay = torch.full((), 1.0 - cfg.beta, dtype=torch.float32,
                       device=w.device)
    out = torch.empty_like(w)
    for r0 in range(0, w.shape[0], _CHUNK):
        sl = slice(r0, r0 + _CHUNK)
        target = cfg.alpha * c_pos[sl] + c_neg[sl]
        out[sl] = torch.nn.functional.hardshrink(
            fma_f32(decay, w[sl], cfg.beta * target), _LARGEST_SUBNORMAL)
    return out


def priority_update_from_batch(w: torch.Tensor, indices: torch.Tensor,
                               labels: torch.Tensor,
                               cfg: PriorityConfig = PriorityConfig(),
                               valid: torch.Tensor | None = None
                               ) -> torch.Tensor:
    c_pos, c_neg = batch_counts(indices, labels, w.shape[0], valid)
    return priority_update(w, c_pos, c_neg, cfg)


def access_counts(indices: torch.Tensor, vocab: int,
                  valid: torch.Tensor | None = None) -> torch.Tensor:
    """Label-free per-row hit counts of a serving batch: every access
    counts as one unlabeled example.  indices any shape -> fp32 (vocab,).
    """
    idx = indices.reshape(-1).to(torch.int64)
    ones = torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
    if valid is not None:
        ones = ones * valid.reshape(-1).to(torch.float32)
    return torch.zeros(vocab, dtype=torch.float32,
                       device=idx.device).index_add_(0, idx, ones)


def serve_update(w: torch.Tensor, indices: torch.Tensor,
                 cfg: PriorityConfig = PriorityConfig(),
                 valid: torch.Tensor | None = None) -> torch.Tensor:
    """Serving-time Eq. 7 fold: accesses enter the EMA as c- (c+ = 0)."""
    c = access_counts(indices, w.shape[0], valid)
    return priority_update(w, torch.zeros_like(c), c, cfg)


def serve_fold(w: torch.Tensor, indices: torch.Tensor,
               cfg: PriorityConfig = PriorityConfig(),
               valid: torch.Tensor | None = None) -> torch.Tensor:
    """The online server's Eq. 7 fold, as the eager reference runs it
    (``serve_update`` outside ``jit``): accesses enter as c- (c+ = 0),
    and the EMA rounds each op on its own (``fold_counts``).
    ``serve_update`` keeps the jitted FMA form for the training
    accumulator."""
    return fold_counts(w, access_counts(indices, w.shape[0], valid), cfg)


def fold_counts(w: torch.Tensor, c: torch.Tensor,
                cfg: PriorityConfig = PriorityConfig()) -> torch.Tensor:
    """One eager Eq. 7 step with c+ = 0 and c- = ``c`` (fp32 (vocab,)
    counts): ``hardshrink(decay * w + beta * c)``, each op rounded on its
    own, as the reference's un-jitted ``priority_update(w, 0, c)``
    computes it.  The online fold (``serve_fold``) and the fleet's pooled
    merge (``serve.fleet.Fleet.merge_priorities``) share it.  Returns a
    new tensor: ``w`` is never written, so one result can be handed to
    many owners.

    With c+ = 0 the target ``alpha * 0 + c`` is the count ``c`` exactly,
    so it is not computed (two passes over (V,) fewer).

    The reference's XLA flushes subnormal results to zero, and with a
    decay of 1 - beta = 0.01 a row unseen for ~20 folds reaches them; the
    port's PyTorch keeps them, and the hot cache's top-k then breaks the
    reference's ties at 0 another way.  So the result is flushed as XLA
    flushes: where the count is non-zero the subnormal ``decay * w`` is
    absorbed by ``beta * c >= beta`` anyway, so flushing the sum flushes
    exactly what the reference flushes.
    """
    f32 = dict(dtype=torch.float32, device=w.device)
    decay = torch.tensor(1.0 - cfg.beta, **f32)
    return torch.nn.functional.hardshrink(
        decay * w + torch.tensor(cfg.beta, **f32) * c, _LARGEST_SUBNORMAL)
