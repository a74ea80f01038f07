"""Session-sequence generator for BERT4Rec (cloze-masked item prediction).

The port's own copy of ``repro/data/sequences.py`` (numpy only): the same
draws, so its batches are bit-equal to the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class SeqConfig:
    num_items: int = 50000
    seq_len: int = 200
    mask_prob: float = 0.2
    zipf_a: float = 1.3
    seed: int = 0
    # items co-occur within latent "genres": next item is drawn near the
    # previous one so the transformer has signal to learn
    genre_size: int = 100


class SeqSynth:
    def __init__(self, cfg: SeqConfig = SeqConfig()):
        self.cfg = cfg
        self.mask_token = cfg.num_items  # vocab row reserved for [MASK]
        self.pad_token = cfg.num_items + 1

    @property
    def vocab(self) -> int:
        return self.cfg.num_items + 2

    def _zipf(self, rng, n):
        a = self.cfg.zipf_a
        u = np.maximum(rng.random(n), 1e-9)
        k = np.floor(u ** (-1.0 / (a - 1.0)) - 1.0)
        return np.clip(k, 0, self.cfg.num_items - 1).astype(np.int64)

    def batch(self, batch_size: int, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
        # random-walk within genre neighbourhoods
        start = self._zipf(rng, batch_size)
        seq = np.empty((batch_size, cfg.seq_len), np.int64)
        seq[:, 0] = start
        jumps = rng.integers(-cfg.genre_size // 4, cfg.genre_size // 4 + 1,
                             (batch_size, cfg.seq_len - 1))
        restart = rng.random((batch_size, cfg.seq_len - 1)) < 0.05
        fresh = self._zipf(rng, batch_size * (cfg.seq_len - 1)
                           ).reshape(batch_size, -1)
        for t in range(1, cfg.seq_len):
            nxt = np.clip(seq[:, t - 1] + jumps[:, t - 1], 0,
                          cfg.num_items - 1)
            seq[:, t] = np.where(restart[:, t - 1], fresh[:, t - 1], nxt)
        # cloze masking
        mask = rng.random((batch_size, cfg.seq_len)) < cfg.mask_prob
        mask[:, -1] = True  # always predict the last item (eval convention)
        inputs = np.where(mask, self.mask_token, seq)
        return {"inputs": inputs.astype(np.int32),
                "targets": seq.astype(np.int32),
                "mask": mask.astype(np.float32)}

    def batches(self, batch_size: int, num_batches: int,
                start_step: int = 0) -> Iterator[dict]:
        for s in range(start_step, start_step + num_batches):
            yield self.batch(batch_size, s)
