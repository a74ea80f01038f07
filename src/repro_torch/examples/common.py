"""What the examples share: the small DLRM on synthetic click logs, a
batch on the device, and the tiered-memory fraction."""

from __future__ import annotations

import torch

from repro_torch.benchmarks.common import device_batch
from repro_torch.core.tiers import fp32_bytes, memory_bytes
from repro_torch.data.criteo import CriteoConfig, CriteoSynth
from repro_torch.models import recsys as R


def small_dlrm(ds: CriteoSynth):
    """The examples' DLRM over ``ds``'s fields: 16-dim rows, MLPs
    4-32-16 and -64-1."""
    return R.make_dlrm(R.DLRMConfig(
        cardinalities=tuple(int(c) for c in ds.cards), embed_dim=16,
        num_dense=4, bot_mlp=(32, 16), top_mlp=(64, 1)))


def synth(num_fields: int, seed: int = 0, noise: float = 0.5
          ) -> CriteoSynth:
    return CriteoSynth(CriteoConfig(num_fields=num_fields,
                                    important_fields=num_fields // 2,
                                    num_dense=4, noise=noise, seed=seed))


def batch(ds: CriteoSynth, size: int, step: int, device: torch.device
          ) -> dict:
    return device_batch(ds.batch(size, step), device)


def compression_ratio(tiers: torch.Tensor, dim: int) -> float:
    """bytes(tiered) / bytes(fp32), the paper's memory figure."""
    return memory_bytes(tiers, dim) / fp32_bytes(tiers.shape[0], dim)
