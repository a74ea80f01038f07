"""Shared layers: dense + bias, the MLP and its fused tail, layer norm
(plain functions, dict params).

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


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def mlp(params: dict, x: torch.Tensor, act=torch.relu,
        final_act: bool = False) -> torch.Tensor:
    n = len(params)
    for i in range(n):
        x = dense_bias(params[f"l{i}"], x)
        if i < n - 1 or final_act:
            x = act(x)
    return x


def layernorm_init(dim: int, device: torch.device) -> dict:
    return {"g": torch.ones((dim,), device=device),
            "b": torch.zeros((dim,), device=device)}


def layernorm(params: dict, x: torch.Tensor, eps: float = 1e-6
              ) -> torch.Tensor:
    """Layer norm over the last axis in fp32 (biased variance), as the
    reference's."""
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["g"].to(torch.float32)
            + params["b"].to(torch.float32)).to(x.dtype)


def mlp_tail(params: dict, y0: torch.Tensor, final_act: bool = False
             ) -> torch.Tensor:
    """Finish an ``mlp`` whose first matmul ran elsewhere.

    ``y0`` is ``x @ params["l0"]["w"]`` before the bias, e.g. the output of
    the fused bag -> matmul kernel (``kernels.bag_matmul``).  Adds the
    layer-0 bias, applies its activation, then runs layers 1..n-1, so
    ``mlp(params, x) == mlp_tail(params, x @ params["l0"]["w"])``.
    """
    n = len(params)
    x = (y0.to(torch.float32)
         + params["l0"]["b"].to(torch.float32)).to(y0.dtype)
    if n > 1 or final_act:
        x = torch.relu(x)
    for i in range(1, n):
        x = dense_bias(params[f"l{i}"], x)
        if i < n - 1 or final_act:
            x = torch.relu(x)
    return x
