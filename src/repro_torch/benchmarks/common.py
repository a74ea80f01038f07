"""Shared benchmark harness: a small DLRM on planted synthetic Criteo.

Port of ``make_setup`` and ``BenchSetup`` from ``benchmarks/common.py``:
the same ``CriteoSynth`` stream (numpy, the same seeds give the same
arrays) and the same DLRM widths (embed dim 16, bottom MLP 4-32-16, top
MLP 64-1).  The reference draws the params with ``jax.random``, which
torch cannot reproduce: here they come from an explicit
``torch.Generator`` seeded with ``seed``, and ``params=`` takes given
params instead (the reference's, carried across with ``convert.py``).
The training drivers (``train_fp32``, ``train_fquant``, ``train_mpe``,
``train_alpt``) come with the table benchmarks that call them (ROADMAP
Queue 1 item 10).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.data.criteo import CriteoConfig, CriteoSynth
from repro_torch.models import recsys as R


@dataclasses.dataclass
class BenchSetup:
    ds: CriteoSynth
    model: R.Model
    params: dict
    device: torch.device
    train_steps: int = 800
    batch_size: int = 512
    eval_batches: int = 8
    eval_batch_size: int = 1024


def make_setup(num_fields=10, important=5, embed_dim=16, seed=0,
               train_steps=800, *, params: dict | None = None,
               device: str | torch.device | None = None) -> BenchSetup:
    """The bench DLRM over ``num_fields`` synthetic fields (``important``
    of them with a planted signal), on ``device`` (default the GPU)."""
    dev = resolve_device(device)
    ds = CriteoSynth(CriteoConfig(num_fields=num_fields,
                                  important_fields=important,
                                  num_dense=4, noise=0.3, seed=seed))
    model = R.make_dlrm(R.DLRMConfig(
        cardinalities=tuple(int(c) for c in ds.cards), embed_dim=embed_dim,
        num_dense=4, bot_mlp=(32, embed_dim), top_mlp=(64, 1)))
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = model.init(gen, dev)
    return BenchSetup(ds=ds, model=model, params=params, device=dev,
                      train_steps=train_steps)
