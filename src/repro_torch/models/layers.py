"""Shared layers: dense + bias and the MLP (plain functions, dict params).

Port of ``repro/models/layers.py``.  Params are nested dicts of tensors
keyed as in the reference (``l{i}`` -> ``{"w": (d_in, d_out), "b":
(d_out,)}``), so ``convert.py`` carries them across unchanged.  Products
go to ``torch.matmul`` in fp32 (TF32 off, see ``resolve_device``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def dense_bias_init(gen: torch.Generator, d_in: int, d_out: int,
                    device: torch.device) -> dict:
    w = torch.randn((d_in, d_out), generator=gen, device=device)
    return {"w": w * (1.0 / math.sqrt(d_in)),
            "b": torch.zeros((d_out,), device=device)}


def dense_bias(params: dict, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, params["w"]) + params["b"]


def mlp_init(gen: torch.Generator, dims: Sequence[int],
             device: torch.device) -> dict:
    return {f"l{i}": dense_bias_init(gen, dims[i], dims[i + 1], device)
            for i in range(len(dims) - 1)}


def mlp(params: dict, x: torch.Tensor, final_act: bool = False
        ) -> torch.Tensor:
    n = len(params)
    for i in range(n):
        x = dense_bias(params[f"l{i}"], x)
        if i < n - 1 or final_act:
            x = torch.relu(x)
    return x
