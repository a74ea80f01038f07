"""Group-LASSO feature selection via proximal SGD (Li et al. [12]).

Port of ``repro/core/baselines/lasso.py``.  A per-field gate vector
g_f in R^D multiplies field f's embedding (the weights "directly
connected with the output of the embedding layer", Sec. 4.1.3); the
proximal step is a block soft-threshold:

    g <- g * max(0, 1 - lambda*lr / ||g||_2)

The gate norms are the importance ranking.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LassoConfig(NamedTuple):
    lam: float = 1e-4     # group-lasso coefficient (paper sweeps 1e-4..1e-8)
    lr: float = 0.01


def init_gates(num_fields: int, dim: int,
               device: str | torch.device = "cpu") -> torch.Tensor:
    return torch.ones((num_fields, dim), dtype=torch.float32, device=device)


def apply_gates(emb: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """emb (B, F, D) * gates (F, D)."""
    return emb * gates[None, :, :]


def proximal_step(gates: torch.Tensor, grad: torch.Tensor,
                  cfg: LassoConfig) -> torch.Tensor:
    """SGD step then block soft-threshold (proximal operator of ||.||_2,1)."""
    g = gates - cfg.lr * grad
    norms = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    shrink = torch.clamp_min(
        1.0 - cfg.lam * cfg.lr / torch.clamp_min(norms, 1e-12), 0.0)
    return g * shrink


def field_scores(gates: torch.Tensor) -> torch.Tensor:
    """Importance = gate group norm."""
    return torch.linalg.vector_norm(gates, dim=-1)


def select_fields(gates: torch.Tensor, keep: int) -> torch.Tensor:
    """Boolean mask keeping the ``keep`` highest-norm fields; ties keep
    the lower field, as the reference's stable ``argsort(-scores)``."""
    scores = field_scores(gates)
    order = torch.sort(-scores, stable=True).indices
    mask = torch.zeros(scores.shape[0], dtype=torch.bool,
                       device=scores.device)
    mask[order[:keep]] = True
    return mask
