"""Mixture-of-Experts FFN: top-k routing with sort-based dispatch.

Port of ``repro/models/moe.py`` (static shapes, no per-token pointer
chasing):

  1. router logits (fp32) -> top-k expert ids + normalised weights;
  2. the (T*k) assignments sorted by expert id (stable);
  3. position within the expert = rank in the sorted order minus the
     expert's group start (``searchsorted``, side left);
  4. tokens scattered into an (E, C, D) capacity buffer; assignments
     beyond capacity C = round(T*k/E * capacity_factor) are dropped
     (GShard-style: slot ``expert*C + 0`` with the row zeroed);
  5. the batched expert SwiGLU (E, C, D) x (E, D, F) in fp32;
  6. scatter-add back with the routing weights.

``jax.lax.top_k`` breaks ties toward the lower index and ``torch.topk``
promises no order, so the top k come from a stable descending sort.
Shared experts (DeepSeek-V2) bypass the routing.  The load-balance and
router z losses are the reference's (Switch / ST-MoE).  The reference's
sharding annotations are no-ops on one device and are left out.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist import ctx
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                   # per-expert hidden dim
    num_experts: int
    top_k: int
    num_shared: int = 0         # DeepSeek shared experts
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3
    # tokens are dispatched into this many independent blocks, each with
    # its own capacity buffers (the reference shards the block dim over
    # the data axis); 1 is one global dispatch
    dispatch_blocks: int = 1


def moe_init(gen: torch.Generator, cfg: MoEConfig, device: torch.device,
             dtype=torch.float32) -> dict:
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=device).mul_(
            scale).to(dtype)

    p = {
        "router": L.dense_init(gen, d, e, device),   # router kept fp32
        "gate": normal((e, d, f), d ** -0.5),
        "up": normal((e, d, f), d ** -0.5),
        "down": normal((e, f, d), f ** -0.5),
    }
    if cfg.num_shared:
        p["shared"] = L.swiglu_init(gen, d, f * cfg.num_shared, device,
                                    dtype)
    return p


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, ties to the lower index (as
    ``jax.lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _routing(router_logits: torch.Tensor, cfg: MoEConfig):
    """(T, E) logits -> (T, k) expert ids, (T, k) weights, aux losses."""
    probs = torch.softmax(router_logits.to(torch.float32), dim=-1)
    weights, experts = top_k(probs, cfg.top_k)
    weights = weights / torch.clamp_min(weights.sum(dim=-1, keepdim=True),
                                        1e-9)
    # load-balance aux (Switch eq. 4): E * sum_e f_e * p_e
    me = probs.mean(dim=0)
    one_hot = torch.nn.functional.one_hot(
        experts[:, 0], cfg.num_experts).to(torch.float32)
    fe = one_hot.mean(dim=0)
    aux = cfg.num_experts * torch.sum(fe * me) * cfg.router_aux_coef
    z = torch.mean(torch.logsumexp(router_logits, dim=-1) ** 2) \
        * cfg.router_z_coef
    return experts, weights, aux + z


def moe_ffn(params: dict, cfg: MoEConfig, x: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) -> (out (B, T, D), aux_loss scalar).

    Block-local dispatch: tokens split into ``dispatch_blocks`` groups;
    routing, sort, scatter and combine run independently per block.
    """
    b, t, d = x.shape
    n = b * t
    nb = max(1, min(cfg.dispatch_blocks, n))
    nloc = n // nb
    assert n % nb == 0, (n, nb)
    dev = x.device
    tokens = ctx.constrain(x.reshape(nb, nloc, d), "batch", None, None)
    logits = torch.matmul(tokens.to(torch.float32), params["router"]["w"])
    experts, weights, aux = _routing(logits.reshape(n, -1), cfg)

    k = cfg.top_k
    e = cfg.num_experts
    cap = int(max(1, round(nloc * k / e * cfg.capacity_factor)))
    l_blk = nloc * k

    blk_expert = experts.reshape(nb, l_blk)         # (nb, nloc*k)
    blk_weight = weights.reshape(nb, l_blk)
    blk_token = torch.arange(nloc, device=dev).repeat_interleave(k)[
        None].expand(nb, l_blk)

    sorted_expert, order = torch.sort(blk_expert, dim=-1, stable=True)
    sorted_token = torch.gather(blk_token, -1, order)
    sorted_weight = torch.gather(blk_weight, -1, order)

    # per-block group starts: searchsorted (side left) on the sorted ids
    starts = torch.searchsorted(
        sorted_expert, torch.arange(e, device=dev).expand(nb, e).contiguous())
    pos_in_expert = torch.arange(l_blk, device=dev)[None, :] \
        - torch.gather(starts, -1, sorted_expert)
    keep = pos_in_expert < cap
    slot = sorted_expert * cap + torch.where(keep, pos_in_expert, 0)

    # block-local scatter into (nb, E*C, D); a dropped row adds zeros
    gathered = torch.gather(tokens, 1, sorted_token[..., None].expand(
        nb, l_blk, d)) * keep[..., None].to(x.dtype)
    buf = torch.zeros((nb, e * cap, d), dtype=x.dtype, device=dev) \
        .scatter_add(1, slot[..., None].expand(nb, l_blk, d), gathered)
    buf = ctx.constrain(buf.reshape(nb, e, cap, d), "batch", None, None,
                        None).to(torch.float32)

    # the batched expert SwiGLU, fp32 products as the reference's einsums
    g = torch.matmul(buf, params["gate"].to(torch.float32))
    u = torch.matmul(buf, params["up"].to(torch.float32))
    h = (L.silu(g) * u).to(x.dtype)
    y = torch.matmul(h.to(torch.float32), params["down"].to(torch.float32)
                     ).to(x.dtype)

    # block-local combine: a token's top_k contributions are added one at
    # a time in the sorted order, each sum rounded to x.dtype, as the
    # reference's scatter-add adds them (a bf16 ``scatter_add`` sums in
    # fp32 on the CPU, and in any order through atomics on the card)
    by_token = torch.sort(sorted_token, dim=-1, stable=True).indices
    y_flat = y.reshape(nb, e * cap, d)
    contrib = torch.gather(y_flat, 1, torch.gather(slot, -1, by_token)[
        ..., None].expand(nb, l_blk, d)) * torch.gather(
        sorted_weight * keep, -1, by_token)[..., None].to(x.dtype)
    contrib = contrib.reshape(nb, nloc, k, d)
    out = contrib[:, :, 0]
    for j in range(1, k):
        out = out + contrib[:, :, j]

    if cfg.num_shared:
        out = out + L.swiglu(params["shared"], tokens)
    out = ctx.constrain(out, "batch", None, None)
    return out.reshape(b, t, d), aux
