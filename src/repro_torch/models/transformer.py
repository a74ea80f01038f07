"""Decoder-only LM family: SmolLM / Qwen3 / DeepSeek-Coder / Mixtral /
DeepSeek-V2-lite as one configurable architecture.

Port of ``repro/models/transformer.py``.  The params keep the
reference's layout: the non-dense layers stacked along a leading (L, ...)
axis under ``params["layers"]`` and DeepSeek's ``first_dense`` layers as
``dense_layer_{i}``, so ``convert.params_from_jax`` carries them across
unchanged.  Where the reference scans the stacked layers (``lax.scan``),
the port loops over the layer index on views of the stacked leaves
(``torch.unbind``, so a backward stacks the layers' gradients once).

``remat`` is the reference's per-layer rematerialisation: ``"full"`` a
``torch.utils.checkpoint`` a layer (non-reentrant), ``"dots"`` the same
saving every plain matmul output (torch's selective checkpoint; the
reference's ``checkpoint_dots_with_no_batch_dims``), ``"none"`` plain
autograd; all three give the same numbers.  The token embedding is the
F-Quantization surface of the family (token frequency == row priority).

Decode writes the new token into the cache in place and returns the
same cache dict (see ``attention``).  ``logits_fn`` returns the fp32
accumulator, as the reference's ``preferred_element_type=float32``
product: the bf16 operands are upcast, which is exact.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.core import metrics
from repro_torch.dist import ctx
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    attn: str = "gqa"                 # "gqa" | "mla"
    qk_norm: bool = False             # Qwen3
    window: int | None = None         # Mixtral SWA
    moe: M.MoEConfig | None = None
    first_dense: int = 0              # DeepSeek first_k_dense_replace
    kv_lora_rank: int = 512           # MLA
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    max_seq: int = 4096
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    remat: str = "full"               # "full" | "dots" | "none"
    attn_chunk: int = 1024
    # (the reference's ``attn_pin`` is a sharding hint and is not carried)

    def gqa(self) -> A.GQAConfig:
        return A.GQAConfig(self.d_model, self.n_heads, self.n_kv_heads,
                           self.head_dim, self.qk_norm, self.window,
                           self.rope_theta, self.attn_chunk)

    def mla(self) -> A.MLAConfig:
        return A.MLAConfig(self.d_model, self.n_heads, self.kv_lora_rank,
                           self.qk_nope_dim, self.qk_rope_dim,
                           self.v_head_dim, self.rope_theta,
                           self.attn_chunk)


# ------------------------------------------------------------------- init

def _init_layer(gen: torch.Generator, cfg: LMConfig, dense_ffn: bool,
                device: torch.device) -> dict:
    dt = cfg.param_dtype
    if cfg.attn == "mla":
        attn = A.mla_init(gen, cfg.mla(), device, dt)
    else:
        attn = A.gqa_init(gen, cfg.gqa(), device, dt)
    p = {"attn": attn,
         "ln1": L.rmsnorm_init(cfg.d_model, device, dt),
         "ln2": L.rmsnorm_init(cfg.d_model, device, dt)}
    if cfg.moe is not None and not dense_ffn:
        p["moe"] = M.moe_init(gen, cfg.moe, device, dt)
    else:
        p["ffn"] = L.swiglu_init(gen, cfg.d_model, cfg.d_ff, device, dt)
    return p


def _stack_into(trees_fn, n: int) -> Any:
    """n calls of ``trees_fn`` (same-structured nested dicts) stacked
    leaf-wise along a new leading axis, each tree written into the
    preallocated (n, ...) leaves and dropped (a whole model does not fit
    twice)."""
    first = trees_fn()

    def alloc(x):
        if isinstance(x, dict):
            return {k: alloc(v) for k, v in x.items()}
        return torch.empty((n, *x.shape), dtype=x.dtype, device=x.device)

    def put(dst, src, i):
        if isinstance(src, dict):
            for k in src:
                put(dst[k], src[k], i)
        else:
            dst[i].copy_(src)

    out = alloc(first)
    put(out, first, 0)
    del first
    for i in range(1, n):
        put(out, trees_fn(), i)
    return out


def init_params(gen: torch.Generator, cfg: LMConfig,
                device: torch.device) -> dict:
    """Random params at ``cfg``'s widths on ``device`` (a torch generator
    on that device; the draws differ from the reference's)."""
    params: dict = {
        "embed": torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                             device=device).mul_(0.02).to(cfg.param_dtype),
        "final_norm": L.rmsnorm_init(cfg.d_model, device, cfg.param_dtype),
    }
    n_scan = cfg.n_layers - cfg.first_dense
    params["layers"] = _stack_into(
        lambda: _init_layer(gen, cfg, False, device), n_scan)
    for i in range(cfg.first_dense):
        params[f"dense_layer_{i}"] = _init_layer(gen, cfg, True, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab, device,
                                         cfg.param_dtype, scale=0.02)
    return params


def _unstack(tree) -> list:
    """The (L, ...) leaves of ``tree`` as L per-layer trees of views."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return list(torch.unbind(tree, 0))


# ---------------------------------------------------------------- forward

def _rope(cfg: LMConfig, device) -> torch.Tensor:
    return L.rope_inv_freq(
        cfg.head_dim if cfg.attn == "gqa" else cfg.qk_rope_dim,
        cfg.rope_theta, device)


def _layer_fwd(layer: dict, cfg: LMConfig, x: torch.Tensor, rope,
               positions: torch.Tensor, dense_ffn: bool):
    """Pre-norm block.  Returns (x, aux_loss, kv_cache_parts)."""
    x = ctx.constrain(x, "batch", None, None)
    h = L.rmsnorm(layer["ln1"], x)
    if cfg.attn == "mla":
        a, cache = A.mla_attend(layer["attn"], cfg.mla(), h, rope, positions)
    else:
        a, cache = A.gqa_attend(layer["attn"], cfg.gqa(), h, rope, positions)
    x = ctx.constrain(x + a, "batch", None, None)
    h = L.rmsnorm(layer["ln2"], x)
    if cfg.moe is not None and not dense_ffn:
        f, aux = M.moe_ffn(layer["moe"], cfg.moe, h)
    else:
        f = L.swiglu(layer["ffn"], h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return ctx.constrain(x + f, "batch", None, None), aux, cache


_PLAIN_DOTS = (torch.ops.aten.mm.default,)


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the plain
    matmul outputs (no batch dims), recompute the rest."""
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _PLAIN_DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_call(fn, cfg: LMConfig, *args):
    """``fn(*args)`` under ``cfg.remat`` (plain when nothing is traced)."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if cfg.remat == "dots":
        return ckpt.checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots))
    return ckpt.checkpoint(fn, *args, use_reentrant=False)


def backbone(params: dict, cfg: LMConfig, tokens: torch.Tensor,
             return_caches: bool = False):
    """tokens (B, T) -> hidden (B, T, D), aux_loss, caches (optional):
    ``(dense_caches, (k, v))``, a list of (k, v) pairs a dense layer and
    the stacked layers' (L, B, T, ...) keys and values (MLA: latents and
    pre-RoPE k_rope)."""
    b, t = tokens.shape
    dev = tokens.device
    x = params["embed"][tokens.long()].to(cfg.compute_dtype)
    rope = _rope(cfg, dev)
    positions = torch.arange(t, dtype=torch.int32, device=dev)
    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    caches = []

    for i in range(cfg.first_dense):
        x, aux, cache = _layer_fwd(params[f"dense_layer_{i}"], cfg, x, rope,
                                   positions, dense_ffn=True)
        aux_total = aux_total + aux
        caches.append(cache)

    def body(x, layer):
        return _layer_fwd(layer, cfg, x, rope, positions, dense_ffn=False)

    scan_k, scan_v = [], []
    for layer in _unstack(params["layers"]):
        x, aux, cache = _remat_call(body, cfg, x, layer)
        aux_total = aux_total + aux
        if return_caches:
            scan_k.append(cache[0])
            scan_v.append(cache[1])
    x = L.rmsnorm(params["final_norm"], x)
    if return_caches:
        return x, aux_total, (caches, (torch.stack(scan_k),
                                       torch.stack(scan_v)))
    return x, aux_total


def logits_fn(params: dict, cfg: LMConfig, hidden: torch.Tensor
              ) -> torch.Tensor:
    """fp32 logits of ``hidden`` against the (tied) head in the compute
    dtype."""
    head = params["embed"].T if cfg.tie_embeddings \
        else params["lm_head"]["w"]
    return torch.matmul(hidden.to(torch.float32),
                        head.to(cfg.compute_dtype).to(torch.float32))


def lm_loss(params: dict, cfg: LMConfig, tokens: torch.Tensor
            ) -> torch.Tensor:
    """Next-token cross entropy (mean over positions) + the MoE aux."""
    hidden, aux = backbone(params, cfg, tokens)
    logits = logits_fn(params, cfg, hidden[:, :-1])
    ce = metrics.softmax_xent(logits, tokens[:, 1:])
    return ce.mean() + aux


def prefill(params: dict, cfg: LMConfig, tokens: torch.Tensor):
    """(last-position logits (B, 1, V), caches): the serving prefill."""
    hidden, _, caches = backbone(params, cfg, tokens, return_caches=True)
    logits = logits_fn(params, cfg, hidden[:, -1:])
    return logits, caches


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, rolling: bool = False,
               device: torch.device | str = "cpu") -> dict:
    """Decode cache, stacked over the layers (``k``, ``v``; ``dense_k``,
    ``dense_v`` for the first dense layers).

    rolling=True (SWA serving): ``max_len`` is the window; a per-slot
    absolute-position array ``pos`` (2**30 = never written) rides along
    and writes wrap at ``cache_len % max_len``.
    """
    n_scan = cfg.n_layers - cfg.first_dense
    if cfg.attn == "mla":
        tail_a, tail_b = (cfg.kv_lora_rank,), (cfg.qk_rope_dim,)
    else:
        tail_a = tail_b = (cfg.n_kv_heads, cfg.head_dim)

    def zeros(n, tail):
        return torch.zeros((n, batch, max_len, *tail), dtype=dtype,
                           device=device)

    cache = {"k": zeros(n_scan, tail_a), "v": zeros(n_scan, tail_b)}
    if cfg.first_dense:
        cache["dense_k"] = zeros(cfg.first_dense, tail_a)
        cache["dense_v"] = zeros(cfg.first_dense, tail_b)
    if rolling:
        cache["pos"] = torch.full((max_len,), A.PAD_POSITION,
                                  dtype=torch.int32, device=device)
    return cache


def decode_step(params: dict, cfg: LMConfig, token: torch.Tensor,
                cache: dict, cache_len) -> tuple[torch.Tensor, dict]:
    """One token for every sequence of the batch.

    token: (B, 1) int; cache: see ``init_cache``, written in place;
    cache_len: int (or a 0-d tensor).  Returns (logits (B, 1, V) fp32,
    cache).
    """
    cache_len = int(cache_len)
    dev = token.device
    x = params["embed"][token.long()].to(cfg.compute_dtype)
    rope = _rope(cfg, dev)

    rolling = "pos" in cache
    if rolling:
        write_slot = cache_len % cache["pos"].shape[0]
        kv_positions = cache["pos"]
    else:
        write_slot = kv_positions = None

    def block(layer, x, ck, cv, dense_ffn):
        h = L.rmsnorm(layer["ln1"], x)
        if cfg.attn == "mla":
            a, _, _ = A.mla_decode(layer["attn"], cfg.mla(), h, ck, cv,
                                   cache_len, rope)
        else:
            a, _, _ = A.gqa_decode(layer["attn"], cfg.gqa(), h, ck, cv,
                                   cache_len, rope, kv_positions, write_slot)
        x = x + a
        h = L.rmsnorm(layer["ln2"], x)
        if cfg.moe is not None and not dense_ffn:
            f, _ = M.moe_ffn(layer["moe"], cfg.moe, h)
        else:
            f = L.swiglu(layer["ffn"], h)
        return x + f

    for i in range(cfg.first_dense):
        x = block(params[f"dense_layer_{i}"], x, cache["dense_k"][i],
                  cache["dense_v"][i], dense_ffn=True)
    for i, layer in enumerate(_unstack(params["layers"])):
        x = block(layer, x, cache["k"][i], cache["v"][i], dense_ffn=False)
    if rolling:
        cache["pos"][write_slot] = cache_len
    x = L.rmsnorm(params["final_norm"], x)
    return logits_fn(params, cfg, x), cache


def param_count(cfg: LMConfig) -> int:
    """Analytic parameter count (no allocation)."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    if cfg.attn == "mla":
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        attn = (d * cfg.n_heads * qk               # wq
                + d * cfg.kv_lora_rank + cfg.kv_lora_rank  # wdkv + norm
                + d * cfg.qk_rope_dim              # wkr
                + cfg.kv_lora_rank * cfg.n_heads * cfg.qk_nope_dim
                + cfg.kv_lora_rank * cfg.n_heads * cfg.v_head_dim
                + cfg.n_heads * cfg.v_head_dim * d)
    else:
        attn = d * cfg.head_dim * (cfg.n_heads * 2 + cfg.n_kv_heads * 2) \
            + (2 * cfg.head_dim if cfg.qk_norm else 0)
    dense_ffn = 3 * d * f
    if cfg.moe is not None:
        m = cfg.moe
        moe_ffn_p = d * m.num_experts + 3 * m.num_experts * d * m.d_ff \
            + (3 * d * m.d_ff * m.num_shared if m.num_shared else 0)
    else:
        moe_ffn_p = dense_ffn
    per_layer = attn + 2 * d
    total = cfg.first_dense * (per_layer + dense_ffn) \
        + (cfg.n_layers - cfg.first_dense) * (per_layer + moe_ffn_p)
    total += v * d + d
    if not cfg.tie_embeddings:
        total += v * d
    return total


def active_param_count(cfg: LMConfig) -> int:
    """Active params a token (MoE: only the top-k and shared experts)."""
    if cfg.moe is None:
        return param_count(cfg)
    m = cfg.moe
    full_moe = 3 * m.num_experts * cfg.d_model * m.d_ff
    active_moe = 3 * (m.top_k + m.num_shared) * cfg.d_model * m.d_ff
    n_moe_layers = cfg.n_layers - cfg.first_dense
    return param_count(cfg) - n_moe_layers * (full_moe - active_moe)
