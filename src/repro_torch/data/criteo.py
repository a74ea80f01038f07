"""Synthetic Criteo-like click logs with planted ground truth.

A numpy-only copy of ``repro/data/criteo.py``: the same seeds give the
same arrays in both packages.

Design goals (so that SHARK's claims become *checkable*):

1. **Planted field importance.** Each categorical field f has a latent
   per-value signal s_{f,v} ~ N(0,1) and a field weight w_f; the label is
   Bernoulli(sigmoid(sum_f w_f * s_{f, idx_f} + b)).  |w_f| is the planted
   importance ranking that F-Permutation must recover (Fig. 2 analogue).
   A configurable fraction of fields gets w_f = 0: pruning them is
   provably lossless — the paper's observation (3) in Sec. 4.2.

2. **Zipf row access.** Per-field indices are zipf-distributed, so a small
   set of rows is hot — the regime where the paper observes that frequent
   rows dominate quantization error and F-Quantization's tiers pay off.

Batches: {"indices": int32 (B, F), "labels": float32 (B,)} — the format
every recsys model in repro_torch.models consumes.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class CriteoConfig:
    num_fields: int = 27           # 26 categorical + 1 bucketized-dense (DLRM)
    num_dense: int = 13            # continuous features (DLRM bottom MLP)
    cardinalities: tuple = ()      # default: heterogeneous, see __post_init__
    zipf_a: float = 1.2            # zipf exponent for row access
    important_fields: int = 12     # fields with |w| > 0
    noise: float = 0.5             # logit noise std
    seed: int = 0

    def resolved_cardinalities(self) -> np.ndarray:
        if self.cardinalities:
            return np.asarray(self.cardinalities, np.int64)
        # heterogeneous vocabularies, criteo-like spread (1e2 .. 1e5 here;
        # production configs scale these up)
        rng = np.random.default_rng(self.seed + 1)
        logs = rng.uniform(2.0, 5.0, self.num_fields)
        return np.maximum(100, (10 ** logs)).astype(np.int64)


class CriteoSynth:
    """Deterministic synthetic click-log stream."""

    def __init__(self, cfg: CriteoConfig = CriteoConfig()):
        self.cfg = cfg
        self.cards = cfg.resolved_cardinalities()
        rng = np.random.default_rng(cfg.seed)
        # planted field weights: first `important_fields` have decaying
        # magnitude, rest are exactly zero (provably prunable)
        w = np.zeros(cfg.num_fields, np.float32)
        mags = 2.0 * 0.8 ** np.arange(cfg.important_fields)
        signs = rng.choice([-1.0, 1.0], cfg.important_fields)
        w[:cfg.important_fields] = mags * signs
        perm = rng.permutation(cfg.num_fields)
        self.field_weight = w[perm]          # shuffled so order isn't a tell
        self.planted_rank = np.argsort(-np.abs(self.field_weight))
        # per-value latent signals, stored per field (truncated at 2^14 to
        # bound memory; indices are folded into this signal range)
        self._sig_size = np.minimum(self.cards, 1 << 14).astype(np.int64)
        self.signals = [rng.standard_normal(s).astype(np.float32)
                        for s in self._sig_size]
        self.bias = -1.5  # skews labels negative (clicks are rare)

    # -- sampling helpers ---------------------------------------------------

    def _zipf_indices(self, rng: np.random.Generator, n: int,
                      card: int) -> np.ndarray:
        # bounded zipf via inverse-CDF on a truncated support
        u = np.maximum(rng.random(n), 1e-9)
        # P(k) ~ (k+1)^-a on [0, card); approximate inverse:
        a = self.cfg.zipf_a
        k = np.floor(u ** (-1.0 / (a - 1.0)) - 1.0) \
            if a > 1.0 else np.floor(u * card)
        return np.clip(k, 0, card - 1).astype(np.int64)

    def batch(self, batch_size: int, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step]))
        f = self.cfg.num_fields
        idx = np.empty((batch_size, f), np.int64)
        logit = np.full(batch_size, self.bias, np.float32)
        for j in range(f):
            idx[:, j] = self._zipf_indices(rng, batch_size, int(self.cards[j]))
            sig = self.signals[j][idx[:, j] % self._sig_size[j]]
            logit += self.field_weight[j] * sig
        dense = rng.standard_normal(
            (batch_size, self.cfg.num_dense)).astype(np.float32)
        # dense features carry a little signal too (weight 0.1 each)
        logit += 0.1 * dense.sum(axis=1)
        logit += rng.standard_normal(batch_size).astype(np.float32) \
            * self.cfg.noise
        prob = 1.0 / (1.0 + np.exp(-logit))
        labels = (rng.random(batch_size) < prob).astype(np.float32)
        return {"indices": idx.astype(np.int32), "dense": dense,
                "labels": labels}

    def batches(self, batch_size: int, num_batches: int,
                start_step: int = 0) -> Iterator[dict]:
        for s in range(start_step, start_step + num_batches):
            yield self.batch(batch_size, s)

    # -- ground truth -------------------------------------------------------

    def lossless_fields(self) -> np.ndarray:
        """Fields with planted weight exactly 0 (pruning them is free)."""
        return np.nonzero(self.field_weight == 0.0)[0]

    def row_hit_rates(self, field: int, batch_size: int) -> np.ndarray:
        """Analytic zipf hit rates — seeds steady-state priorities."""
        card = int(self.cards[field])
        k = np.arange(card, dtype=np.float64) + 1.0
        p = k ** (-self.cfg.zipf_a)
        p /= p.sum()
        return (p * batch_size).astype(np.float32)
