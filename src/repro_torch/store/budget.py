"""Byte-budget placement planner for the hierarchical store.

Port of ``repro/store/budget.py``.  Given the live priority vector
(Eq. 7) and the per-row precision tiers (Eq. 8), decide which rows live
where:

    HOT   device memory, under ``hbm_budget_bytes``
    WARM  host RAM, under ``host_budget_bytes`` (None = unbounded:
          everything that spills from the device stays in RAM, cold is
          empty)
    COLD  mmap'd disk shards (everything else)

Rows are ranked by priority, ties to the lower row id (a stable sort of
``-priority``), and packed greedily into HOT, then WARM, by their serving
bytes (``tiers.row_bytes``).  A larger budget's hot set is a superset of
a smaller one's.  The hot set is the longest prefix of the ranking whose
per-device bytes (``hot_shard_bytes``: the padded tier shares, an empty
tier's placeholder row, and the indirection words) fit the budget.

The reference sorts and counts with numpy, and its binary search counts
the tiers of a prefix with a bincount at every probe (at dlrm-rm2's
204,185,088 rows: tens of seconds).  The port sorts on the priorities'
device (``torch.sort(stable=True)``) and counts each probe from two
prefix sums of the ranked tiers, so a probe is two reads.  The plan is
the reference's: the same levels, id lists and byte counts.  Sorting the
negated priority in fp32 orders as the reference's float64 negation does
(the widening is exact); ``0.0 - p`` keeps zero priorities a +0 tie.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.tiers import row_bytes

HOT, WARM, COLD = 0, 1, 2
LEVEL_NAMES = ("hot", "warm", "cold")


class BudgetPlan(NamedTuple):
    level: np.ndarray     # int8 (V,) in {HOT, WARM, COLD}
    hot_ids: np.ndarray   # int64, ascending: row order inside each level
    warm_ids: np.ndarray
    cold_ids: np.ndarray
    hot_bytes: int        # per-shard device bytes of the hot set
    warm_bytes: int
    cold_bytes: int


def _shard_bytes(counts, dim: int, hot_n: int, n_shards: int) -> int:
    """Per-device bytes of a hot store with ``counts`` rows a tier: each
    tier's share padded up (``ceil``), at least one placeholder row, and
    the replicated indirection words."""
    per = [max(-(-int(c) // n_shards), 1) for c in counts]
    return (per[0] * (dim + 4) + per[1] * (2 * dim + 4) + per[2] * 4 * dim
            + hot_n * 4)


def hot_shard_bytes(tiers, dim: int, hot_n: int, n_shards: int = 1,
                    order=None) -> int:
    """Per-device bytes of a hot store holding the first ``hot_n`` rows of
    ``order`` (default: rows ``0..hot_n``), row-sharded ``n_shards`` ways
    (see ``_shard_bytes``).  An empty tier charges one placeholder row a
    shard: ``extract_rows`` allocates it."""
    t = np.asarray(tiers).astype(np.int64).reshape(-1)
    sel = t[np.asarray(order)[:hot_n]] if order is not None else t[:hot_n]
    counts = np.bincount(sel, minlength=3)[:3]
    return _shard_bytes(counts, dim, hot_n, n_shards)


def plan_placement(priority, tiers, dim: int, hbm_budget_bytes: int,
                   host_budget_bytes: int | None = None,
                   n_shards: int = 1) -> BudgetPlan:
    """Rank rows by priority and pack them greedily into the level budgets.

    ``priority`` and ``tiers`` are (V,) tensors (the work runs on their
    device) or arrays (on the CPU).  At least one row is always hot.  The
    warm level is empty when ``host_budget_bytes`` cannot fit even the
    first spilled row; ``host_budget_bytes=None`` disables the cold level.
    """
    pri = torch.as_tensor(priority).reshape(-1)
    dev = pri.device
    t = torch.as_tensor(tiers).reshape(-1).to(device=dev,
                                               dtype=torch.int64)
    v = pri.shape[0]
    if not pri.is_floating_point():
        pri = pri.to(torch.float64)
    order = torch.sort(0.0 - pri, stable=True).indices
    t_ord = t[order]
    # rows of tiers 0 and 1 among the first n ranked rows: cum[k][n - 1]
    cum = [torch.cumsum(t_ord == k, 0, dtype=torch.int64) for k in (0, 1)]

    def probe(n: int) -> int:
        c0, c1 = (int(c[n - 1]) for c in cum)
        return _shard_bytes((c0, c1, n - c0 - c1), dim, n, n_shards)

    # the longest prefix whose per-device bytes fit (monotone in n)
    lo, hi = 1, v
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if probe(mid) <= hbm_budget_bytes:
            lo = mid
        else:
            hi = mid - 1
    hot_n = lo
    hot_bytes = probe(hot_n)
    del cum

    spill_bytes = torch.cumsum(row_bytes(t_ord[hot_n:], dim), 0)
    if host_budget_bytes is None:
        warm_n = spill_bytes.numel()
    else:
        warm_n = int(torch.searchsorted(
            spill_bytes, torch.tensor([int(host_budget_bytes)],
                                      dtype=torch.int64, device=dev),
            right=True))
    warm_bytes = int(spill_bytes[warm_n - 1]) if warm_n else 0
    total_spill = int(spill_bytes[-1]) if spill_bytes.numel() else 0
    del spill_bytes, t_ord

    level = torch.full((v,), COLD, dtype=torch.int8, device=dev)
    level[order[:hot_n]] = HOT
    level[order[hot_n:hot_n + warm_n]] = WARM
    del order
    ids = [torch.nonzero(level == k).reshape(-1).cpu().numpy()
           for k in (HOT, WARM, COLD)]
    return BudgetPlan(level=level.cpu().numpy(), hot_ids=ids[0],
                      warm_ids=ids[1], cold_ids=ids[2], hot_bytes=hot_bytes,
                      warm_bytes=warm_bytes,
                      cold_bytes=total_spill - warm_bytes)
