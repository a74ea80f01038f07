"""ALPT: Adaptive Low-Precision Training (Li et al. [9]).

Port of ``repro/core/baselines/alpt.py``.  The table is stored int8 with
a learnable per-row fp32 scale s; rows dequantize as s * q, and s gets
gradients through the straight-through estimator:

    e_dq = s * clip(round_sr(e / s), Imin, Imax)
    de_dq/ds ~= q - (e/s) * 1[|e/s| <= Imax]

``ste_quant`` (the reference's ``jax.custom_vjp``) is a
``torch.autograd.Function`` with the reference's backward.
``apply_grads`` sums the batch's gradient rows into (V, D) with
``index_put_(accumulate=True)`` (deterministic on the card, where it
sorts the ids) in place of ``segment_sum``, and takes its two
stochastic re-quantizations' uniforms from a draw source (a generator,
or a callable; see ``rowwise_quant``) in the reference's order: the
Newton step's codes first, then the stored codes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import rowwise_quant as rq


class ALPTConfig(NamedTuple):
    bits: int = 8
    scale_lr: float = 1e-4
    init_scale: float = 1e-2


class ALPTState(NamedTuple):
    q: torch.Tensor        # int8[V, D] payload
    scale: torch.Tensor    # fp32[V, 1] learnable


def init(gen: torch.Generator, vocab: int, dim: int, cfg: ALPTConfig,
         init_std: float = 0.01) -> ALPTState:
    dev = gen.device
    table = torch.randn((vocab, dim), generator=gen, device=dev) * init_std
    scale = torch.full((vocab, 1), cfg.init_scale, dtype=torch.float32,
                       device=dev)
    imin, imax = rq.int_range(cfg.bits)
    q = torch.clamp(torch.round(table / scale), imin, imax).to(torch.int8)
    return ALPTState(q=q, scale=scale)


def dequant(state: ALPTState) -> torch.Tensor:
    return state.q.to(torch.float32) * state.scale


def lookup(state: ALPTState, indices: torch.Tensor) -> torch.Tensor:
    idx = indices.to(torch.int64)
    return state.q[idx].to(torch.float32) * state.scale[idx]


class _STEQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, e, scale, bits):
        imin, imax = rq.int_range(bits)
        x = e / scale
        q = torch.clamp(torch.round(x), imin, imax)
        ctx.save_for_backward(x, q)
        ctx.bounds = (imin, imax)
        return scale * q

    @staticmethod
    def backward(ctx, g):
        x, q = ctx.saved_tensors
        imin, imax = ctx.bounds
        inside = ((x >= imin) & (x <= imax)).to(g.dtype)
        de = g * inside                              # STE through round
        # d(s*q)/ds = q - x * 1[inside]  (ALPT Eq.; gradient w.r.t. scale)
        ds = (g * (q - x * inside)).sum(dim=-1, keepdim=True)
        return de, ds, None


def ste_quant(e: torch.Tensor, scale: torch.Tensor, bits: int = 8
              ) -> torch.Tensor:
    """s * clip(round(e / s)), with the STE gradients of both inputs."""
    return _STEQuant.apply(e, scale, bits)


def apply_grads(state: ALPTState, grad_rows: torch.Tensor,
                indices: torch.Tensor, lr: float, cfg: ALPTConfig,
                draw: rq.Draw) -> ALPTState:
    """SGD on touched rows with stochastic re-quantization + scale update.

    As the reference: the STE scale gradient at the continuous updated
    weight ``new_e = e - lr * g`` (at the stored point q - e/s is 0, so
    the gradient never flows there), then a Newton step on the row error
    ||s q - new_e||^2 at the stochastic codes, whose minimiser for fixed
    q is s* = <new_e, q> / <q, q> (rows with a non-zero code jump to it;
    all-zero rows keep the gradient-updated scale), then the stored codes
    re-quantized stochastically at the new scale.
    """
    idx = indices.reshape(-1).to(torch.int64)
    g = grad_rows.reshape(-1, grad_rows.shape[-1])
    v = state.q.shape[0]
    gsum = torch.zeros((v, g.shape[1]), dtype=g.dtype,
                       device=g.device).index_put_((idx,), g,
                                                   accumulate=True)
    imin, imax = rq.int_range(cfg.bits)
    new_e = dequant(state) - lr * gsum

    # (1) STE scale gradient at the continuous updated weight
    x = new_e / state.scale
    inside = ((x >= imin) & (x <= imax)).to(torch.float32)
    q_hat = torch.clamp(torch.round(x), imin, imax)
    ds = (gsum * (q_hat - x * inside)).sum(dim=-1, keepdim=True)
    scale = torch.clamp_min(state.scale - cfg.scale_lr * ds, 1e-8)

    # (2) Newton step on the row error at the stochastic codes
    uniform = rq.uniform_source(draw)
    q_new = torch.clamp(rq.stochastic_round(new_e / scale, uniform),
                        imin, imax)
    num = (new_e * q_new).sum(dim=-1, keepdim=True)
    den = (q_new * q_new).sum(dim=-1, keepdim=True)
    s_star = num / torch.clamp_min(den, 1e-12)
    scale = torch.clamp_min(
        torch.where((den > 0) & (s_star > 0), s_star, scale), 1e-8)

    q = torch.clamp(rq.stochastic_round(new_e / scale, uniform),
                    imin, imax).to(torch.int8)
    return ALPTState(q=q, scale=scale)


def memory_bytes(vocab: int, dim: int, cfg: ALPTConfig) -> int:
    return vocab * dim * cfg.bits // 8 + vocab * 4
