"""Frequency-based row priority scores (SHARK Eq. 7): configuration.

    w_r^(t+1) = (1 - beta) * w_r^(t) + beta * (alpha * c+ + c-)

Port of ``repro/core/priority.py``.  Only the configuration is here yet:
``FQuantConfig`` carries it.  The Eq. 7 update arrives with online
serving, which folds every served batch into the scores.
"""

from __future__ import annotations

from typing import NamedTuple


class PriorityConfig(NamedTuple):
    alpha: float = 2.0   # importance weight of positive examples
    beta: float = 0.99   # time-decay rate
