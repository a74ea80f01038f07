"""Loss and metric utilities (exact).

Port of ``repro/core/metrics.py``.  AUC is the paper's quality metric
(Tables 3-4), computed exactly via the rank-sum (Mann-Whitney U)
identity with average ranks for ties.
"""

from __future__ import annotations

import torch


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """Per-sample binary cross entropy; logits/labels same shape."""
    return (torch.clamp_min(logits, 0.0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor
                 ) -> torch.Tensor:
    """Per-position cross entropy.  logits (..., V), labels int (...)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.to(torch.int64)[..., None])[..., 0]
    return logz - gold


def auc(scores: torch.Tensor, labels: torch.Tensor,
        valid: torch.Tensor | None = None) -> torch.Tensor:
    """Exact ROC-AUC with tie correction.  scores/labels: (N,) -> () fp32.

    ``valid`` (N,) masks entries out (weight 0), as the reference does.
    """
    scores = scores.reshape(-1).to(torch.float32)
    labels = labels.reshape(-1).to(torch.float32)
    w = (torch.ones_like(labels) if valid is None
         else valid.reshape(-1).to(torch.float32))
    order = torch.argsort(scores, stable=True)
    s_sorted = scores[order]
    w_sorted = w[order]
    l_sorted = labels[order] * w_sorted
    n = scores.shape[0]
    rank = torch.cumsum(w_sorted, 0)          # 1-based rank among valid
    same_as_prev = torch.zeros(n, dtype=torch.bool, device=scores.device)
    same_as_prev[1:] = s_sorted[1:] == s_sorted[:-1]
    group = torch.cumsum((~same_as_prev).to(torch.int64), 0) - 1
    g_sum = torch.zeros(n, device=scores.device).index_add_(
        0, group, rank * w_sorted)
    g_cnt = torch.zeros(n, device=scores.device).index_add_(
        0, group, w_sorted)
    g_mean = torch.where(g_cnt > 0, g_sum / g_cnt.clamp_min(1.0), 0.0)
    avg_rank = g_mean[group]
    n_pos = l_sorted.sum()
    n_neg = w_sorted.sum() - n_pos
    u = (avg_rank * l_sorted).sum() - n_pos * (n_pos + 1.0) / 2.0
    return (u / torch.clamp_min(n_pos * n_neg, 1.0)).to(torch.float32)
