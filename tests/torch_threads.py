"""Caps torch's CPU threads in the port's tests.

Under pytest-xdist every worker process runs its own torch, and each
torch would start one intra-op thread per core: six workers on eight
cores then run 48 threads and stall one another by orders of magnitude.
Importing this module sets ``torch.set_num_threads`` to the cores each
worker gets (``os.cpu_count() // PYTEST_XDIST_WORKER_COUNT``, at least 1;
all cores without xdist).  Every ``tests/test_torch_*.py`` imports it
(``tests/test_torch_port_rules.py`` checks), and a port test that starts
a subprocess gives it ``subprocess_env()``, the same cap as
``OMP_NUM_THREADS``.
"""

from __future__ import annotations

import os

import torch

WORKERS = max(1, int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
THREADS = max(1, (os.cpu_count() or 1) // WORKERS)
torch.set_num_threads(THREADS)


def subprocess_env(env: dict | None = None) -> dict:
    """``env`` (default: this process's environment) with the worker's
    thread cap as ``OMP_NUM_THREADS``."""
    out = dict(os.environ if env is None else env)
    out["OMP_NUM_THREADS"] = str(THREADS)
    return out
