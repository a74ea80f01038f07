"""Mixed-Precision Embedding with a full-precision cache (Yang et al. [32]).

Port of ``repro/core/baselines/mpe.py``, the baseline F-Quantization is
compared against in Table 3.  The original keeps a host-side LFU/LRU
cache of hot rows at fp32 and the backing table at low precision; as in
the reference, the same semantics with static shapes:

  * priority = LFU (cumulative access count) or LRU (last-access step);
    unlike SHARK Eq. 7, no positive/negative weighting and no decay;
  * the C highest-priority rows are "in cache" -> fp32; all others int8.

Membership is refreshed every ``refresh_every`` steps.  The reference's
``lax.cond`` on the device step is a Python branch here on
``MPEState.step``, a host int, so reading it costs no device sync.
Memory: C*4D + (V-C)*(D + 4) bytes + a membership word a row, which at
the paper's 55% point is C ~ 0.18V.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import rowwise_quant as rq


class MPEConfig(NamedTuple):
    capacity: int              # C: rows kept at fp32
    policy: str = "lfu"        # "lfu" | "lru"
    bits: int = 8
    refresh_every: int = 1


class MPEState(NamedTuple):
    table: torch.Tensor       # fp32[V, D] value-space (tier-exact)
    priority: torch.Tensor    # fp32[V]  LFU count or LRU last-step
    in_cache: torch.Tensor    # bool[V]
    step: int                 # steps taken, on the host


def init(gen: torch.Generator, vocab: int, dim: int, cfg: MPEConfig,
         scale: float = 0.01) -> MPEState:
    dev = gen.device
    table = torch.randn((vocab, dim), generator=gen, device=dev) * scale
    pri = torch.zeros((vocab,), dtype=torch.float32, device=dev)
    in_cache = torch.zeros((vocab,), dtype=torch.bool, device=dev)
    in_cache[:cfg.capacity] = True
    return MPEState(table, pri, in_cache, 0)


def _touch(state: MPEState, indices: torch.Tensor, cfg: MPEConfig
           ) -> torch.Tensor:
    idx = indices.reshape(-1).to(torch.int64)
    if cfg.policy == "lfu":
        # integer counts: exact in fp32 in any order of the adds
        return state.priority.index_add(
            0, idx, torch.ones(idx.shape, dtype=torch.float32,
                               device=idx.device))
    pri = state.priority.clone()             # lru: last access step
    pri[idx] = float(state.step)
    return pri


def post_step(state: MPEState, indices: torch.Tensor, cfg: MPEConfig,
              draw: rq.Draw | None = None) -> MPEState:
    """Update priorities, refresh cache membership, snap non-cached rows.

    The snap rounds stochastically with uniforms from ``draw`` when given
    (see ``rowwise_quant``), else to nearest; its int8 scale is the
    reference's jitted train step's (``reciprocal=True``).
    """
    pri = _touch(state, indices, cfg)
    step = state.step + 1
    in_cache = state.in_cache
    if step % cfg.refresh_every == 0:
        # top-C rows by priority are cached, ties at the C-th included
        if cfg.capacity > 0:
            thresh = torch.sort(pri, descending=True).values[cfg.capacity - 1]
            in_cache = pri >= thresh
        else:
            in_cache = torch.zeros_like(state.in_cache)
    snapped = rq.fake_quant_rowwise(state.table, cfg.bits, draw=draw,
                                    reciprocal=True)
    table = torch.where(in_cache[:, None], state.table, snapped)
    return MPEState(table, pri, in_cache, step)


def lookup(state: MPEState, indices: torch.Tensor) -> torch.Tensor:
    return state.table[indices.to(torch.int64)]


def memory_bytes(vocab: int, dim: int, cfg: MPEConfig) -> int:
    cached = cfg.capacity * dim * 4
    backing = (vocab - cfg.capacity) * (dim * cfg.bits // 8 + 4)
    return cached + backing + vocab * 4  # + membership word
