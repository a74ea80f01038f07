"""Quantization-aware training store for F-Quantization.

Port of ``repro/core/qat_store.py``.  The table stays fp32[V, D]; after
every optimizer step each row is *snapped* onto the representable set of
its tier (int8 grid with stochastic rounding / half cast / identity), so
the values the model sees are bit-identical to what the packed serving
store produces.

    table    fp32[V, D]   tier-exact values
    priority fp32[V]      Eq. 7 EMA scores

``snap`` is the projection (round-to-nearest, as serving packs it, or
stochastic from a draw source; ``snap_`` its in-place, chunked
round-to-nearest form);
``post_step`` (whole table) and ``post_step_sparse`` (touched rows only,
the training path) fold a batch into the priorities, re-tier and snap,
with stochastic rounding on the int8 tier when ``cfg.stochastic``.  The
sparse path draws its noise from ``_hash_uniform``, a hash of (row,
column, step): duplicate rows of a batch get identical noise, hence
identical snapped values, so the order of the index writes does not
matter.  ``post_step_sparse`` writes the snapped rows into the table in
place (the port's one departure from the reference's functional update:
at 124M x 64 a second table does not fit).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import rowwise_quant as rq
from repro_torch.core.priority import (PriorityConfig,
                                       priority_update_from_batch)
from repro_torch.core.tiers import Tier, TierConfig, assign_tiers

_U32 = 0xFFFFFFFF
CHUNK_ROWS = 1 << 22      # rows a chunked step holds (1 GB of fp32 at D 64)


class FQuantConfig(NamedTuple):
    """Full F-Quantization hyper-parameter set (paper defaults)."""
    tiers: TierConfig = TierConfig(t8=1e3, t16=1e5)
    priority: PriorityConfig = PriorityConfig(alpha=2.0, beta=0.99)
    bits: int = 8
    mode: str = "narrow"        # idempotent; "full" = literal Eq. 6
    strict_fp16: bool = False   # True -> IEEE fp16 half tier (paper parity)
    scaled_half: bool = True    # row-normalised half tier
    stochastic: bool = True     # stochastic rounding on the write path


class QATStore(NamedTuple):
    """One embedding table under F-Quantization training."""
    table: torch.Tensor      # fp32[V, D], tier-exact values
    priority: torch.Tensor   # fp32[V]


def snap(table: torch.Tensor, tiers: torch.Tensor,
         cfg: FQuantConfig, reciprocal: bool = False,
         draw: rq.Draw | None = None) -> torch.Tensor:
    """Project each row onto its tier's representable value set.

    The int8 tier rounds stochastically with uniforms over the whole
    table from ``draw`` (a generator or a callable, see ``rowwise_quant``)
    when one is given and ``cfg.stochastic``, as the reference's ``snap``
    with a key; else to nearest, as without one.  Row-wise, so snapping
    any block of rows to nearest equals snapping them inside the whole
    table.  ``reciprocal``: the int8 scale of the reference's jitted
    train step (see ``rowwise_quant``).
    """
    sr = draw if cfg.stochastic else None
    q8 = rq.fake_quant_rowwise(table, cfg.bits, draw=sr, mode=cfg.mode,
                               reciprocal=reciprocal)
    qh = rq.fake_quant_half(table, strict_fp16=cfg.strict_fp16,
                            scaled=cfg.scaled_half)
    t = tiers[:, None]
    return torch.where(t == Tier.INT8.value, q8,
                       torch.where(t == Tier.HALF.value, qh, table))


def snap_(table: torch.Tensor, tiers: torch.Tensor, cfg: FQuantConfig
          ) -> torch.Tensor:
    """``snap`` in place, ``CHUNK_ROWS`` rows at a time (row-wise, so the
    same values); returns ``table``.  At 124M x 64 a second table does not
    fit beside the first."""
    for r0 in range(0, table.shape[0], CHUNK_ROWS):
        r1 = min(table.shape[0], r0 + CHUNK_ROWS)
        table[r0:r1] = snap(table[r0:r1], tiers[r0:r1], cfg)
    return table


def post_step(store: QATStore, indices: torch.Tensor,
              labels: torch.Tensor, cfg: FQuantConfig,
              valid: torch.Tensor | None = None,
              draw: rq.Draw | None = None) -> QATStore:
    """Priority EMA + tier re-assignment + snap of the whole table, as
    the reference's jitted ``post_step`` runs it (its int8 scale).

    With ``draw`` (and ``cfg.stochastic``) the int8 tier rounds
    stochastically, as the reference's with a ``jax.random`` key; without
    one, to nearest.  The compressed step uses ``post_step_sparse``.
    """
    pri = priority_update_from_batch(store.priority, indices, labels,
                                     cfg.priority, valid=valid)
    tiers = assign_tiers(pri, cfg.tiers)
    return QATStore(table=snap(store.table, tiers, cfg, reciprocal=True,
                               draw=draw),
                    priority=pri)


def _hash_uniform(idx: torch.Tensor, seed, dim: int) -> torch.Tensor:
    """Per-(row, column, seed) uniforms in [0, 1], the reference's uint32
    hash: idx (N,) -> (N, dim) fp32.

    The uint32 arithmetic runs in int64, masked to 32 bits after every
    multiply (a wrapped int64 product keeps its low 32 bits).
    """
    i = (idx.to(torch.int64) & _U32)[:, None]
    j = torch.arange(dim, dtype=torch.int64, device=idx.device)[None, :]
    s = torch.as_tensor(seed, device=idx.device).to(torch.int64) & _U32
    h = ((i * 2654435761) & _U32) ^ ((j * 40503) & _U32) ^ s
    h = ((h ^ (h >> 15)) * 0x2C1B3C6D) & _U32
    h = ((h ^ (h >> 12)) * 0x297A2D39) & _U32
    h = h ^ (h >> 15)
    return h.to(torch.float32) / 2.0 ** 32


def _sr_quant(rows: torch.Tensor, noise: torch.Tensor, cfg: FQuantConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stochastic row-wise int8 quantization: round down, then up where
    ``noise`` < the fraction.  Returns (q int8, scale (N, 1) fp32)."""
    imin, imax = rq.int_range(cfg.bits)
    scale = rq.rowwise_scale(rows, cfg.bits, cfg.mode,
                             reciprocal=True).to(torch.float32)
    y = rows.to(torch.float32) / scale
    r = torch.clamp(rq.stochastic_round(y, lambda shape: noise), imin, imax)
    return r.to(torch.int8), scale


def post_step_sparse(store: QATStore, indices: torch.Tensor,
                     labels: torch.Tensor, cfg: FQuantConfig, seed,
                     valid: torch.Tensor | None = None,
                     first: int = 0) -> QATStore:
    """Touched-rows-only write path (the training step's).

    Eq. 7 decays every row's priority (an O(V) vector op); the Eq. 5-6
    snap rewrites only the rows of ``indices``, in place in
    ``store.table``.  ``seed`` (the step) keys the stochastic rounding.
    The int8 scale is the jitted reference's (``reciprocal=True``, see
    ``rowwise_quant``): the reference runs this path inside its jitted
    train step.

    ``first`` is the global row of ``store``'s row 0: a row shard's step
    (``train.steps`` under a placed state) passes its own slots' local
    rows, and the rounding's noise is keyed by their global rows
    ``indices + first``, so each shard snaps its rows as the whole table
    does.  Every index is written, so a shard passes only the slots it
    owns.
    """
    pri = priority_update_from_batch(store.priority, indices, labels,
                                     cfg.priority, valid=valid)
    tiers = assign_tiers(pri, cfg.tiers)
    flat = indices.reshape(-1).to(torch.int64)
    rows = store.table[flat]
    if cfg.stochastic:
        noise = _hash_uniform(flat + first, seed, store.table.shape[1])
        q8 = rq.dequantize_rowwise(*_sr_quant(rows, noise, cfg))
    else:
        q8 = rq.fake_quant_rowwise(rows, cfg.bits, mode=cfg.mode,
                                   reciprocal=True)
    qh = rq.fake_quant_half(rows, strict_fp16=cfg.strict_fp16,
                            scaled=cfg.scaled_half)
    t = tiers[flat][:, None]
    snapped = torch.where(t == Tier.INT8.value, q8,
                          torch.where(t == Tier.HALF.value, qh, rows))
    store.table[flat] = snapped.to(store.table.dtype)
    return QATStore(table=store.table, priority=pri)


def current_tiers(store: QATStore, cfg: FQuantConfig) -> torch.Tensor:
    return assign_tiers(store.priority, cfg.tiers)
