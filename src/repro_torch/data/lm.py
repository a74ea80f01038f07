"""Synthetic token streams for LM training and the smoke runs.

The port's own copy of ``repro/data/lm.py`` (numpy only): the same draws,
so its batches are bit-equal to the reference's.  Zipf-distributed
unigrams with a short-range bigram structure, so the loss falls under
training; token frequency follows the heavy-tailed regime that makes
F-Quantization's frequency tiers meaningful for the token table.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class LMConfig:
    vocab: int = 32000
    seq_len: int = 512
    zipf_a: float = 1.1
    seed: int = 0


class LMSynth:
    def __init__(self, cfg: LMConfig = LMConfig()):
        self.cfg = cfg

    def _zipf(self, rng, n):
        a = self.cfg.zipf_a
        u = np.maximum(rng.random(n), 1e-9)
        if a > 1.0:
            k = np.floor(u ** (-1.0 / (a - 1.0)) - 1.0)
        else:
            k = np.floor(u * self.cfg.vocab)
        return np.clip(k, 0, self.cfg.vocab - 1).astype(np.int64)

    def batch(self, batch_size: int, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
        base = self._zipf(rng, batch_size * cfg.seq_len) \
            .reshape(batch_size, cfg.seq_len)
        # bigram structure: with p = 0.5 the next token is prev + 1 (mod V)
        rep = rng.random((batch_size, cfg.seq_len)) < 0.5
        tokens = base.copy()
        tokens[:, 1:] = np.where(rep[:, 1:],
                                 (tokens[:, :-1] + 1) % cfg.vocab,
                                 base[:, 1:])
        return {"tokens": tokens.astype(np.int32)}
