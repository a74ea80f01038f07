"""Tier assignment and memory accounting (SHARK Eq. 8 + Table 1 adaptation).

Port of ``repro/core/tiers.py``.  Rows are assigned one of three precision
tiers by their priority score w_r:

    tier(r) = INT8  if w_r <  t8
            = HALF  if t8 <= w_r < t16          ("fp16" in the paper)
            = FP32  if t16 <= w_r

Memory is accounted for the tier-partitioned layout of ``packed_store``:

    int8 row : D bytes payload + 4 bytes scale + 4 bytes indirection
    half row : 2D bytes payload + 4 bytes scale + 4 bytes indirection
    fp32 row : 4D bytes payload            + 4 bytes indirection
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import numpy as np
import torch


class Tier(enum.IntEnum):
    INT8 = 0
    HALF = 1   # fp16 in the paper; bf16 by default (see rowwise_quant.py)
    FP32 = 2


class TierConfig(NamedTuple):
    t8: float = 1e3    # rows with w < t8 -> int8
    t16: float = 1e5   # rows with t8 <= w < t16 -> half


def assign_tiers(w: torch.Tensor, cfg: TierConfig = TierConfig()
                 ) -> torch.Tensor:
    """Eq. 8 selector.  w: (V,) fp32 priority -> tiers: (V,) int8.

    The thresholds are Python floats; the comparison runs in w's fp32,
    as the reference's weakly-typed ``w < cfg.t8`` does.
    """
    t = torch.full(w.shape, Tier.FP32.value, dtype=torch.int8,
                   device=w.device)
    t.masked_fill_(w < cfg.t16, Tier.HALF.value)
    t.masked_fill_(w < cfg.t8, Tier.INT8.value)
    return t


def tier_counts(tiers: torch.Tensor) -> list[int]:
    """Rows per tier, [int8, half, fp32].  Three comparisons and sums:
    ``torch.bincount`` into 3 bins serialises on atomics on the card
    (~5.7 ms over 86.7M rows)."""
    t = tiers.reshape(-1)
    return [int(x) for x in torch.stack([(t == k).sum()
                                         for k in range(3)]).tolist()]


def tier_crossings(old_tiers: torch.Tensor, new_tiers: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows whose tier changed, and the 3x3 transition histogram.

    Port of ``repro/core/tiers.py::tier_crossings`` on the tiers' device:
    (changed int64 (M,) ascending, hist int64 (3, 3)) with ``hist[src,
    dst]`` = rows moving src -> dst.
    """
    o = old_tiers.reshape(-1)
    n = new_tiers.reshape(-1)
    changed = torch.nonzero(o != n).reshape(-1)
    code = o[changed].to(torch.int64) * 3 + n[changed].to(torch.int64)
    hist = torch.stack([(code == j).sum() for j in range(9)])
    return changed, hist.reshape(3, 3)


def row_bytes(tiers, dim: int):
    """Serving bytes a row (payload + scale + indirection word), the unit
    the hierarchical store's budget planner packs against: int64, the
    shape of ``tiers``; a tensor on its device for a tensor, numpy for
    anything else (``repro/core/tiers.py::row_bytes``)."""
    per = [dim + 8, 2 * dim + 8, 4 * dim + 4]
    if isinstance(tiers, torch.Tensor):
        return torch.tensor(per, dtype=torch.int64,
                            device=tiers.device)[tiers.to(torch.int64)]
    return np.asarray(per, np.int64)[np.asarray(tiers).astype(np.int64)]


def memory_bytes(tiers: torch.Tensor, dim: int) -> int:
    """Total embedding-table bytes under the tier-partitioned layout:
    payloads, the int8 and half scales, and one indirection word a row."""
    c8, c16, c32 = tier_counts(tiers)
    payload = c8 * dim + c16 * 2 * dim + c32 * 4 * dim
    return payload + (c8 + c16) * 4 + (c8 + c16 + c32) * 4


def fp32_bytes(vocab: int, dim: int) -> int:
    return vocab * dim * 4


def _quantile_f32(sorted_w: torch.Tensor, p: float) -> float:
    """``jnp.quantile(w, p)`` (linear) on an ascending-sorted fp32 vector.

    Sort-based, so it works at any size (``torch.quantile`` refuses inputs
    above 2**24 elements).  Like the reference it computes the position
    ``p * (n - 1)`` and the interpolation weights in fp32, then blends
    the two neighbours in fp32.
    """
    n = sorted_w.numel()
    f32 = torch.float32
    q = torch.tensor(p, dtype=f32) * (torch.tensor(n, dtype=f32) - 1)
    low, high = torch.floor(q), torch.ceil(q)
    hw = q - low
    lw = 1 - hw
    lo = int(low.clamp(0, n - 1))
    hi = int(high.clamp(0, n - 1))
    vals = sorted_w[[lo, hi]].to("cpu", f32)
    return float(vals[0] * lw + vals[1] * hw)


def plan_thresholds_for_ratio(w: torch.Tensor, dim: int,
                              target_ratio: float) -> TierConfig:
    """Pick (t8, t16) so the table compresses to ~target_ratio of fp32.

    Closed form as in the reference: with fractions (p8, p16, p32),
    bytes/row/dim = p8*1 + p16*2 + p32*4 and p8+p16+p32 = 1, and the
    quantized mass is split half and half between int8 and half.  The
    cuts are quantiles of ``w``; both come from one sort of ``w`` on its
    own device.
    """
    t = max(0.25, min(4.0, target_ratio * 4.0))
    hf = 0.5                        # the reference's half_fraction
    q = (t - 4.0) / (1.0 + hf - 4.0)
    q = min(1.0, max(0.0, q))
    p8 = (1.0 - hf) * q
    p16 = hf * q
    w = w.reshape(-1).to(torch.float32)
    sorted_w = torch.sort(w).values
    # Eq. 8 uses strict w < t: nudge thresholds above the quantile so the
    # mass of rows tied AT the quantile falls below it into the cheaper tier
    eps = 1e-9 + 1e-6 * float(w.abs().max())
    t8 = _quantile_f32(sorted_w, p8) + eps if p8 > 0 \
        else float(sorted_w[0]) - 1.0
    t16 = _quantile_f32(sorted_w, min(p8 + p16, 1.0)) + eps
    return TierConfig(t8=t8, t16=max(t16, t8))
