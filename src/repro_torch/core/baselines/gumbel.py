"""Gumbel-softmax field selection (FSCD [17] / AutoField [27] style).

Port of ``repro/core/baselines/gumbel.py``.  A keep-probability per
field is learned with a binary-concrete (Gumbel-sigmoid) relaxation:
during selection training each field's embedding is gated by a sampled
soft mask, temperature-annealed; the learned logits rank the fields.

``sample_mask`` takes its uniforms in [1e-6, 1 - 1e-6] from a draw
source: a ``torch.Generator`` (drawn on its device and mapped into the
range as ``jax.random.uniform(minval=, maxval=)`` does), or a callable
``shape -> uniforms already in the range``, through which a test feeds
the reference's draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.rowwise_quant import Draw

_LO, _HI = 1e-6, 1 - 1e-6


class GumbelConfig(NamedTuple):
    init_logit: float = 2.0      # start ~sigmoid(2) = 0.88 keep prob
    tau_start: float = 1.0
    tau_end: float = 0.1
    anneal_steps: int = 1000
    lr: float = 0.01


def init_logits(num_fields: int, cfg: GumbelConfig,
                device: str | torch.device = "cpu") -> torch.Tensor:
    return torch.full((num_fields,), cfg.init_logit, dtype=torch.float32,
                      device=device)


def temperature(step, cfg: GumbelConfig) -> torch.Tensor:
    """The annealed temperature at ``step`` (an int or a tensor), fp32."""
    step = torch.as_tensor(step)
    frac = torch.clamp(step.to(torch.float32) / cfg.anneal_steps, 0.0, 1.0)
    return cfg.tau_start + (cfg.tau_end - cfg.tau_start) * frac


def _uniform(draw: Draw, shape: tuple) -> torch.Tensor:
    if isinstance(draw, torch.Generator):
        u = torch.rand(shape, generator=draw, device=draw.device)
        return torch.clamp_min(u * (_HI - _LO) + _LO, _LO)
    return draw(shape)


def sample_mask(logits: torch.Tensor, draw: Draw, tau) -> torch.Tensor:
    """Binary-concrete sample in (0, 1), shape (F,)."""
    u = _uniform(draw, tuple(logits.shape)).to(logits.device)
    g = torch.log(u) - torch.log1p(-u)          # logistic noise
    return torch.sigmoid((logits + g) / tau)


def apply_mask(emb: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return emb * mask[None, :, None]


def field_scores(logits: torch.Tensor) -> torch.Tensor:
    """Importance = learned keep probability."""
    return torch.sigmoid(logits)


def sparsity_loss(logits: torch.Tensor, target_keep: float) -> torch.Tensor:
    """Encourage mean keep-prob towards the compression target."""
    return (torch.sigmoid(logits).mean() - target_keep) ** 2
