"""Attention: GQA / MLA / sliding window, with a chunked (flash-style)
softmax.

Port of ``repro/models/attention.py``.  One implementation covers
training, prefill and decode:

  * ``chunked_attention`` walks the keys in chunks with a running (max,
    denominator, accumulator) triple, the FlashAttention recurrence in
    torch ops, so the Tq x Tk score matrix never exists beyond (Tq,
    chunk).  Its numerics are the reference's: fp32 queries and scores,
    masked scores at -1e30, a fully masked row kept finite by the running
    max, ``acc / max(l, 1e-30)``.  The keys and values stay views of the
    caller's tensors (a decode cache is never copied whole); each chunk is
    cast to fp32 on its own, and only a short last chunk is padded (zero
    keys at position 2**30, masked).
  * GQA: n_q heads grouped onto n_kv heads (Hq = G * Hkv).
  * SWA: sliding-window masking (Mixtral); window W bounds the live keys.
  * MLA (DeepSeek-V2): queries and keys split into nope and rope parts,
    the keys and values rebuilt from a per-token latent ``c_kv``
    (kv_lora_rank) and a shared ``k_rope``; the decode cache holds only
    (c_kv, k_rope).

The reference's sharding annotations (``ctx.constrain``) are no-ops on
one device and are left out.  Decode writes the new token's keys into
the cache IN PLACE (the reference returns updated copies; a 48 GB cache
has no room for a second one) and returns the cache tensors it wrote.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models import layers as L

NEG_INF = -1e30
PAD_POSITION = 2 ** 30


def _pad_rows(x: torch.Tensor, rows: int, dim: int, value=0
              ) -> torch.Tensor:
    """``x`` with ``rows`` more entries of ``value`` along ``dim``."""
    shape = list(x.shape)
    shape[dim] = rows
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype,
                                    device=x.device)], dim=dim)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_positions: torch.Tensor, kv_positions: torch.Tensor,
                      causal: bool = True, window: int | None = None,
                      chunk: int = 1024,
                      kv_valid: torch.Tensor | None = None,
                      scale: float | None = None) -> torch.Tensor:
    """Flash-style attention with GQA grouping.

    q: (B, Tq, Hq, Dh) with Hq = G * Hkv; k: (B, Tk, Hkv, Dh);
    v: (B, Tk, Hkv, Dv); q_positions (Tq,), kv_positions (Tk,) absolute
    positions; kv_valid: optional (B, Tk) mask of live cache slots.
    Returns (B, Tq, Hq, Dv) in q.dtype.
    """
    b, tq, hq, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    dev = q.device
    # in place where autograd keeps nothing (prefill, decode)
    inplace = not (torch.is_grad_enabled()
                   and (q.requires_grad or k.requires_grad
                        or v.requires_grad))
    qg = q.reshape(b, tq, hkv, g, dh).to(torch.float32) * scale
    qg = qg.permute(0, 2, 3, 1, 4).reshape(b, hkv, g * tq, dh)

    m = torch.full((b, hkv, g, tq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, tq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, tq, dv), dtype=torch.float32, device=dev)
    for c0 in range(0, tk, chunk):
        c1 = min(c0 + chunk, tk)
        k_i, v_i, p_i = k[:, c0:c1], v[:, c0:c1], kv_positions[c0:c1]
        valid = None if kv_valid is None else kv_valid[:, c0:c1]
        pad = chunk - (c1 - c0)
        if pad:
            k_i, v_i = _pad_rows(k_i, pad, 1), _pad_rows(v_i, pad, 1)
            p_i = _pad_rows(p_i, pad, 0, PAD_POSITION)
            valid = _pad_rows(torch.ones((b, c1 - c0), dtype=torch.bool,
                                         device=dev)
                              if valid is None else valid, pad, 1, False)
        # (B|1, 1, 1, Tq|1, C) live entries
        mask = (torch.ones((1, chunk), dtype=torch.bool, device=dev)
                if valid is None else valid)[:, None, None, None, :]
        if causal:
            cm = q_positions[:, None] >= p_i[None, :]
            mask = mask & cm[None, None, None]
        if window is not None:
            wm = (q_positions[:, None] - p_i[None, :]) < window
            mask = mask & wm[None, None, None]
        dead = ~mask
        s = torch.matmul(qg, k_i.to(torch.float32).permute(0, 2, 3, 1))
        s = s.view(b, hkv, g, tq, chunk).masked_fill_(dead, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # a fully masked row keeps m_new finite through the running max
        if inplace:
            p = s.sub_(m_new[..., None]).exp_().masked_fill_(dead, 0.0)
        else:
            p = torch.exp(s - m_new[..., None]).masked_fill(dead, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.matmul(p.view(b, hkv, g * tq, chunk),
                          v_i.to(torch.float32).permute(0, 2, 1, 3))
        acc = acc * corr[..., None] + pv.view(b, hkv, g, tq, dv)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]   # (B,Hkv,G,Tq,Dv)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, tq, hq, dv)
    return out.to(q.dtype)


def _write_slot(slot: int, size: int) -> int:
    """``dynamic_update_slice``'s start index: clamped into the cache."""
    return min(max(slot, 0), size - 1)


# ------------------------------------------------------------------- GQA

@dataclasses.dataclass(frozen=True)
class GQAConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False          # Qwen3
    window: int | None = None      # Mixtral SWA
    rope_theta: float = 10000.0
    chunk: int = 1024


def gqa_init(gen: torch.Generator, cfg: GQAConfig, device: torch.device,
             dtype=torch.float32) -> dict:
    p = {
        "wq": L.dense_init(gen, cfg.d_model, cfg.n_heads * cfg.head_dim,
                           device, dtype),
        "wk": L.dense_init(gen, cfg.d_model, cfg.n_kv_heads * cfg.head_dim,
                           device, dtype),
        "wv": L.dense_init(gen, cfg.d_model, cfg.n_kv_heads * cfg.head_dim,
                           device, dtype),
        "wo": L.dense_init(gen, cfg.n_heads * cfg.head_dim, cfg.d_model,
                           device, dtype),
    }
    if cfg.qk_norm:
        p["qnorm"] = L.rmsnorm_init(cfg.head_dim, device, dtype)
        p["knorm"] = L.rmsnorm_init(cfg.head_dim, device, dtype)
    return p


def gqa_qkv(params: dict, cfg: GQAConfig, x: torch.Tensor,
            rope: torch.Tensor, positions: torch.Tensor):
    b, t, _ = x.shape
    q = L.dense(params["wq"], x).reshape(b, t, cfg.n_heads, cfg.head_dim)
    k = L.dense(params["wk"], x).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    v = L.dense(params["wv"], x).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = L.rmsnorm(params["qnorm"], q)
        k = L.rmsnorm(params["knorm"], k)
    q = L.apply_rope(q, rope, positions)
    k = L.apply_rope(k, rope, positions)
    return q, k, v


def gqa_attend(params: dict, cfg: GQAConfig, x: torch.Tensor,
               rope: torch.Tensor, positions: torch.Tensor,
               causal: bool = True):
    """Training / prefill.  Returns (out, (k, v)) for the cache."""
    q, k, v = gqa_qkv(params, cfg, x, rope, positions)
    out = chunked_attention(q, k, v, q_positions=positions,
                            kv_positions=positions, causal=causal,
                            window=cfg.window, chunk=cfg.chunk)
    b, t = x.shape[:2]
    out = L.dense(params["wo"], out.reshape(b, t, -1))
    return out, (k, v)


def gqa_decode(params: dict, cfg: GQAConfig, x: torch.Tensor,
               cache_k: torch.Tensor, cache_v: torch.Tensor, cache_len: int,
               rope: torch.Tensor,
               kv_positions: torch.Tensor | None = None,
               write_slot: int | None = None):
    """One decode step.  x: (B, 1, D); cache_{k,v}: (B, S, Hkv, Dh).

    Linear cache (default): writes at slot ``cache_len``; slots beyond it
    are masked.  Rolling cache (SWA serving, S == window): pass
    ``write_slot = cache_len % S`` and the per-slot absolute positions
    ``kv_positions (S,)`` (unwritten slots carry 2**30 and are masked by
    the causal test).  Writes the caches in place; returns (out (B, 1, D),
    cache_k, cache_v).
    """
    b, s = cache_k.shape[0], cache_k.shape[1]
    positions = torch.full((1,), cache_len, dtype=torch.int32,
                           device=x.device)
    q, k, v = gqa_qkv(params, cfg, x, rope, positions)
    slot = _write_slot(cache_len if write_slot is None else write_slot, s)
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    if kv_positions is None:
        kv_positions = torch.arange(s, dtype=torch.int32, device=x.device)
    else:
        kv_positions = kv_positions.clone()
        kv_positions[slot] = cache_len
    kv_valid = (kv_positions <= cache_len)[None, :].expand(b, s)
    out = chunked_attention(q, cache_k, cache_v, q_positions=positions,
                            kv_positions=kv_positions, causal=True,
                            window=cfg.window, chunk=cfg.chunk,
                            kv_valid=kv_valid)
    out = L.dense(params["wo"], out.reshape(b, 1, -1))
    return out, cache_k, cache_v


# ------------------------------------------------------------------- MLA

@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0
    chunk: int = 1024

    @property
    def qk_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim


def mla_init(gen: torch.Generator, cfg: MLAConfig, device: torch.device,
             dtype=torch.float32) -> dict:
    h, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    return {
        "wq": L.dense_init(gen, cfg.d_model, h * (dn + dr), device, dtype),
        "wdkv": L.dense_init(gen, cfg.d_model, cfg.kv_lora_rank, device,
                             dtype),
        "kv_norm": L.rmsnorm_init(cfg.kv_lora_rank, device, dtype),
        "wkr": L.dense_init(gen, cfg.d_model, dr, device, dtype),
        "wuk": L.dense_init(gen, cfg.kv_lora_rank, h * dn, device, dtype),
        "wuv": L.dense_init(gen, cfg.kv_lora_rank, h * dv, device, dtype),
        "wo": L.dense_init(gen, h * dv, cfg.d_model, device, dtype),
    }


def _mla_qk(params, cfg: MLAConfig, x: torch.Tensor, c_kv: torch.Tensor,
            k_rope: torch.Tensor, rope, q_positions: torch.Tensor,
            kv_positions: torch.Tensor):
    """q (B, Tq, H, Dq), k (B, Tk, H, Dq) and v (B, Tk, H, Dv) from the
    latents."""
    b, tq, _ = x.shape
    tk = c_kv.shape[1]
    h, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    q = L.dense(params["wq"], x).reshape(b, tq, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = L.apply_rope(q_rope, rope, q_positions)
    q = torch.cat([q_nope, q_rope], dim=-1)

    k_nope = L.dense(params["wuk"], c_kv).reshape(b, tk, h, dn)
    kr = L.apply_rope(k_rope[:, :, None, :], rope, kv_positions)
    kr = kr.expand(b, tk, h, dr)
    k = torch.cat([k_nope, kr], dim=-1)
    v = L.dense(params["wuv"], c_kv).reshape(b, tk, h, cfg.v_head_dim)
    return q, k, v


def mla_latents(params, cfg: MLAConfig, x: torch.Tensor):
    c_kv = L.rmsnorm(params["kv_norm"], L.dense(params["wdkv"], x))
    k_rope = L.dense(params["wkr"], x)      # (B, T, dr), before RoPE
    return c_kv, k_rope


def mla_attend(params: dict, cfg: MLAConfig, x: torch.Tensor, rope,
               positions: torch.Tensor, causal: bool = True):
    c_kv, k_rope = mla_latents(params, cfg, x)
    q, k, v = _mla_qk(params, cfg, x, c_kv, k_rope, rope, positions,
                      positions)
    out = chunked_attention(q, k, v, q_positions=positions,
                            kv_positions=positions, causal=causal,
                            chunk=cfg.chunk,
                            scale=1.0 / math.sqrt(cfg.qk_dim))
    b, t = x.shape[:2]
    out = L.dense(params["wo"], out.reshape(b, t, -1))
    return out, (c_kv, k_rope)


def mla_decode(params: dict, cfg: MLAConfig, x: torch.Tensor,
               cache_ckv: torch.Tensor, cache_kr: torch.Tensor,
               cache_len: int, rope):
    """Decode with the compressed cache (B, S, kv_lora) + (B, S, dr),
    written in place."""
    b, s = cache_ckv.shape[0], cache_ckv.shape[1]
    positions = torch.full((1,), cache_len, dtype=torch.int32,
                           device=x.device)
    c_new, kr_new = mla_latents(params, cfg, x)
    slot = _write_slot(cache_len, s)
    cache_ckv[:, slot] = c_new[:, 0].to(cache_ckv.dtype)
    cache_kr[:, slot] = kr_new[:, 0].to(cache_kr.dtype)
    kv_pos = torch.arange(s, dtype=torch.int32, device=x.device)
    q, k, v = _mla_qk(params, cfg, x, cache_ckv.to(x.dtype),
                      cache_kr.to(x.dtype), rope, positions, kv_pos)
    kv_valid = (kv_pos <= cache_len)[None, :].expand(b, s)
    out = chunked_attention(q, k, v, q_positions=positions,
                            kv_positions=kv_pos, causal=True,
                            chunk=cfg.chunk, kv_valid=kv_valid,
                            scale=1.0 / math.sqrt(cfg.qk_dim))
    out = L.dense(params["wo"], out.reshape(b, 1, -1))
    return out, cache_ckv, cache_kr
