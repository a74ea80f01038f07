"""Shared layers: dense (with and without bias), the MLP and its fused
tail, layer and RMS norm, RoPE, SwiGLU (plain functions, dict params).

Port of ``repro/models/layers.py``.  Params are nested dicts of tensors
keyed as in the reference (``l{i}`` -> ``{"w": (d_in, d_out), "b":
(d_out,)}``), so ``convert.py`` carries them across unchanged.  Products
go to ``torch.matmul`` in fp32 (TF32 off, see ``resolve_device``).

``dense`` is the reference's ``jnp.dot(x, w, preferred_element_type=
float32).astype(x.dtype)``: ``jnp.dot`` of bf16 activations and fp32
weights promotes both to fp32, so the port upcasts ``x`` (never casts
``w`` down) and rounds the product back to ``x.dtype``.  bf16 operands
are exact in fp32, so a bf16 x bf16 product accumulated in fp32 is the
same fp32 GEMM.

``silu`` is ``jax.nn.silu`` as XLA expands it, ``x * (1 / (1 + exp(-x)))``
with each step rounded to ``x.dtype``: in bf16 that rounds four times
where ``torch.nn.functional.silu`` rounds once, and the two disagree in
~40% of bf16 outputs.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               device: torch.device, dtype=torch.float32,
               scale: float | None = None) -> dict:
    """``{"w": (d_in, d_out)}`` of N(0, scale^2), scale 1/sqrt(d_in) by
    default, drawn in fp32 and stored in ``dtype``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=device)
    return {"w": w.mul_(scale).to(dtype)}


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in fp32, rounded to ``x.dtype`` (see the module note)."""
    return torch.matmul(x.float(), params["w"].float()).to(x.dtype)


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


def rmsnorm_init(dim: int, device: torch.device, dtype=torch.float32
                 ) -> dict:
    return {"g": torch.ones((dim,), device=device, dtype=dtype)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMS norm over the last axis in fp32, as the reference's."""
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["g"].to(torch.float32)).to(x.dtype)


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


# RoPE frequencies come from positions directly (no (max_pos, Dh/2)
# table), as in the reference: at a 512k-token decode a table would cost
# hundreds of MB; position-wise computation is O(T * Dh/2).

def rope_inv_freq(head_dim: int, theta: float = 10000.0,
                  device: torch.device | None = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, inv_freq: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """x: (B, T, H, Dh); inv_freq: (Dh/2,); positions: (T,) or (B, T)."""
    ang = positions[..., None].to(torch.float32) * inv_freq  # (.., T, d/2)
    if ang.dim() == 2:           # (T, d/2) -> broadcast over the batch
        ang = ang[None]
    c = torch.cos(ang)[..., None, :]     # (B|1, T, 1, d/2)
    s = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU as the reference computes it (see the module note)."""
    return x * torch.reciprocal(torch.exp(-x) + 1.0)


def swiglu_init(gen: torch.Generator, d_model: int, d_ff: int,
                device: torch.device, dtype=torch.float32) -> dict:
    return {"gate": dense_init(gen, d_model, d_ff, device, dtype),
            "up": dense_init(gen, d_model, d_ff, device, dtype),
            "down": dense_init(gen, d_ff, d_model, device, dtype)}


def swiglu(params: dict, x: torch.Tensor) -> torch.Tensor:
    g = dense(params["gate"], x)
    u = dense(params["up"], x)
    return dense(params["down"], silu(g) * u)


def count_params(tree) -> int:
    """Elements over the tensor leaves of nested dicts and lists."""
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_params(v) for v in tree)
    return tree.numel()
