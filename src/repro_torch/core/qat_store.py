"""Quantization-aware training store for F-Quantization.

Port of ``repro/core/qat_store.py`` (the parts serving needs).  The table
stays fp32[V, D]; ``snap`` projects each row onto the representable set
of its tier (int8 grid / half cast / identity), so the values the model
sees are bit-identical to what the packed serving store produces.

    table    fp32[V, D]   tier-exact values
    priority fp32[V]      Eq. 7 EMA scores

The stochastic-rounding write path (``post_step``) and its ``stochastic``
flag arrive with training: here ``snap`` is the round-to-nearest
projection that serving packs.  ``priority`` configures the Eq. 7 EMA,
which arrives with online serving.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import rowwise_quant as rq
from repro_torch.core.priority import PriorityConfig
from repro_torch.core.tiers import Tier, TierConfig, assign_tiers


class FQuantConfig(NamedTuple):
    """Full F-Quantization hyper-parameter set (paper defaults)."""
    tiers: TierConfig = TierConfig(t8=1e3, t16=1e5)
    priority: PriorityConfig = PriorityConfig(alpha=2.0, beta=0.99)
    bits: int = 8
    mode: str = "narrow"        # idempotent; "full" = literal Eq. 6
    strict_fp16: bool = False   # True -> IEEE fp16 half tier (CPU only)
    scaled_half: bool = True    # row-normalised half tier


class QATStore(NamedTuple):
    """One embedding table under F-Quantization training."""
    table: torch.Tensor      # fp32[V, D], tier-exact values
    priority: torch.Tensor   # fp32[V]


def snap(table: torch.Tensor, tiers: torch.Tensor,
         cfg: FQuantConfig) -> torch.Tensor:
    """Project each row onto its tier's representable value set.

    Round-to-nearest, as the reference's ``snap`` without a key.  Row-wise,
    so snapping any block of rows equals snapping them inside the whole
    table.
    """
    q8 = rq.fake_quant_rowwise(table, cfg.bits, mode=cfg.mode)
    qh = rq.fake_quant_half(table, strict_fp16=cfg.strict_fp16,
                            scaled=cfg.scaled_half)
    t = tiers[:, None]
    return torch.where(t == Tier.INT8.value, q8,
                       torch.where(t == Tier.HALF.value, qh, table))


def current_tiers(store: QATStore, cfg: FQuantConfig) -> torch.Tensor:
    return assign_tiers(store.priority, cfg.tiers)
