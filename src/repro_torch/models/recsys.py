"""Recsys models: DLRM, Wide&Deep, xDeepFM and BERT4Rec.

Port of ``repro/models/recsys.py`` (``make_dlrm``, ``make_wide_deep``,
``make_xdeepfm``, ``make_bert4rec``).  Every model exposes the SHARK interface: ``init``,
``embed``, ``head``, ``forward``, ``loss_from_emb`` and ``spec`` (the
stacked table); params keep the reference's nesting, so ``convert.py``
carries them across unchanged:

    dlrm       {"embed_table", "net": {"bot", "top"}}
    wide_deep  {"embed_table", "wide_table", "net": {"deep", "bias"}}
    xdeepfm    {"embed_table", "wide_table",
                "net": {"cin": {"w0", ...}, "cin_out", "deep"}}
    bert4rec   {"embed_table", "net": {"blocks": [{"wq", "wk", "wv", "wo",
                "ln1", "ln2", "ffn"}, ...], "ln_f"}}

``init(gen, device, with_table=False)`` leaves the big table out (serving
holds only its packed store); the net is drawn first, so it is the same
with and without the table.  Wide&deep and xDeepFM carry
``extras = {"fused_head", "fused_needs_emb"}`` as in the reference: the
fused head takes ``bag_matmul(w)`` = ``emb.reshape(B, F*D) @ w`` (the
``kernels.bag_matmul`` kernel over the packed store) for the deep
branch's first layer.  The wide branch is an fp32 (V, 1) table lookup.
xDeepFM's CIN layer runs the ``kernels.cin`` kernel on the card, the
function the reference's own ``cin_layer`` computes in jnp.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from repro_torch.core import metrics
from repro_torch.kernels.cin import ops as cin_ops
from repro_torch.models import embedding as E
from repro_torch.models import layers as L


class Model(NamedTuple):
    """Bound model API (callables close over the config)."""
    name: str
    spec: E.FieldSpec
    init: Callable           # (gen, device, with_table=True) -> params
    embed: Callable          # (params, batch, field_mask=None) -> (B, F, D)
    head: Callable           # (params, emb (B, F, D), batch) -> (B,) logits
    forward: Callable        # (params, batch, field_mask=None) -> (B,)
    loss_from_emb: Callable  # (params, emb, batch) -> (B,) per-sample loss
    extras: dict = {}        # model-specific extra entry points


def _bce_from_emb(head):
    def loss_from_emb(params, emb, batch):
        return metrics.bce_with_logits(head(params, emb, batch),
                                       batch["labels"])
    return loss_from_emb


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    cardinalities: tuple
    embed_dim: int = 64
    num_dense: int = 13
    bot_mlp: tuple = (512, 256, 64)
    top_mlp: tuple = (512, 512, 256, 1)


def make_dlrm(cfg: DLRMConfig) -> Model:
    spec = E.FieldSpec(tuple(int(c) for c in cfg.cardinalities),
                       cfg.embed_dim)
    f = spec.num_fields
    if cfg.bot_mlp[-1] != cfg.embed_dim:
        raise ValueError("bottom MLP must project dense features to "
                         "embed_dim")
    top_in = cfg.embed_dim + (f + 1) * f // 2

    def init(gen: torch.Generator, device: torch.device,
             with_table: bool = True) -> dict:
        params = {"net": {
            "bot": L.mlp_init(gen, (cfg.num_dense,) + cfg.bot_mlp, device),
            "top": L.mlp_init(gen, (top_in,) + cfg.top_mlp, device)}}
        if with_table:
            params["embed_table"] = E.init_table(gen, spec, device)
        return params

    def embed(params: dict, batch: dict, field_mask=None) -> torch.Tensor:
        return E.field_lookup(params["embed_table"], batch["indices"], spec,
                              field_mask)

    def head(params: dict, emb: torch.Tensor, batch: dict) -> torch.Tensor:
        dense = L.mlp(params["net"]["bot"], batch["dense"], final_act=True)
        feats = torch.cat([dense[:, None, :], emb], dim=1)    # (B, F+1, D)
        inter = torch.bmm(feats, feats.transpose(1, 2))       # (B, F+1, F+1)
        iu, ju = torch.triu_indices(f + 1, f + 1, offset=1,
                                    device=emb.device)
        z = torch.cat([dense, inter[:, iu, ju]], dim=-1)      # (B, top_in)
        return L.mlp(params["net"]["top"], z)[:, 0]

    def forward(params: dict, batch: dict, field_mask=None) -> torch.Tensor:
        return head(params, embed(params, batch, field_mask), batch)

    return Model("dlrm", spec, init, embed, head, forward,
                 _bce_from_emb(head))


# ======================================================================
# Wide & Deep (Cheng et al. 2016)
# ======================================================================

@dataclasses.dataclass(frozen=True)
class WideDeepConfig:
    cardinalities: tuple
    embed_dim: int = 32
    mlp: tuple = (1024, 512, 256)


def _wide_table(spec: E.FieldSpec, device: torch.device) -> torch.Tensor:
    """Per-row scalar weights, an embed_dim = 1 table of zeros (the
    reference draws it at scale 0)."""
    return torch.zeros((spec.total_rows, 1), dtype=torch.float32,
                       device=device)


def _wide(params: dict, batch: dict, spec: E.FieldSpec) -> torch.Tensor:
    wide_spec = E.FieldSpec(spec.cardinalities, 1)
    return E.field_lookup(params["wide_table"], batch["indices"],
                          wide_spec).sum(dim=(1, 2))


def make_wide_deep(cfg: WideDeepConfig) -> Model:
    spec = E.FieldSpec(tuple(int(c) for c in cfg.cardinalities),
                       cfg.embed_dim)
    f = spec.num_fields

    def init(gen: torch.Generator, device: torch.device,
             with_table: bool = True) -> dict:
        params = {"net": {
            "deep": L.mlp_init(gen, (f * cfg.embed_dim,) + cfg.mlp + (1,),
                               device),
            "bias": torch.zeros((1,), device=device)}}
        params["wide_table"] = _wide_table(spec, device)
        if with_table:
            params["embed_table"] = E.init_table(gen, spec, device)
        return params

    def embed(params: dict, batch: dict, field_mask=None) -> torch.Tensor:
        return E.field_lookup(params["embed_table"], batch["indices"], spec,
                              field_mask)

    def head(params: dict, emb: torch.Tensor, batch: dict) -> torch.Tensor:
        b = emb.shape[0]
        deep = L.mlp(params["net"]["deep"], emb.reshape(b, -1))[:, 0]
        return deep + _wide(params, batch, spec) + params["net"]["bias"][0]

    def fused_head(params: dict, batch: dict, bag_matmul) -> torch.Tensor:
        """``head`` with the deep branch's first matmul fused into the
        gather: ``bag_matmul(w)`` computes ``emb.reshape(B, F*D) @ w``
        (``packed_store.bag_matmul`` over the batch's global ids), so the
        (B, F*D) activations never materialise."""
        y0 = bag_matmul(params["net"]["deep"]["l0"]["w"])
        deep = L.mlp_tail(params["net"]["deep"], y0)[:, 0]
        return deep + _wide(params, batch, spec) + params["net"]["bias"][0]

    def forward(params: dict, batch: dict, field_mask=None) -> torch.Tensor:
        return head(params, embed(params, batch, field_mask), batch)

    return Model("wide_deep", spec, init, embed, head, forward,
                 _bce_from_emb(head),
                 extras={"fused_head": fused_head, "fused_needs_emb": False})


# ======================================================================
# xDeepFM (Lian et al. 2018): CIN feature interaction
# ======================================================================

@dataclasses.dataclass(frozen=True)
class XDeepFMConfig:
    cardinalities: tuple
    embed_dim: int = 10
    cin_layers: tuple = (200, 200, 200)
    mlp: tuple = (400, 400)


class CinLayer(torch.autograd.Function):
    """The CIN layer with a gradient: the forward is ``kernels.cin`` (the
    kernel on the card, its bit-exact plain version on the CPU, neither
    differentiable), the backward the three dense contractions of
    ``out[b,o,d] = sum_{h,m} W[o,h,m] x_k[b,h,d] x_0[b,m,d]``, as the
    reference's jnp layer differentiates."""

    @staticmethod
    def forward(ctx, w, x_k, x_0):
        ctx.save_for_backward(w, x_k, x_0)
        return cin_ops.cin_layer(w, x_k, x_0)

    @staticmethod
    def backward(ctx, g):
        w, x_k, x_0 = ctx.saved_tensors
        g = g.to(torch.float32)
        dw = dxk = dx0 = None
        if ctx.needs_input_grad[0]:
            dw = torch.einsum("bod,bhd,bmd->ohm", g, x_k, x_0).to(w.dtype)
        if ctx.needs_input_grad[1]:
            dxk = torch.einsum("bod,ohm,bmd->bhd", g, w, x_0).to(x_k.dtype)
        if ctx.needs_input_grad[2]:
            dx0 = torch.einsum("bod,ohm,bhd->bmd", g, w, x_k).to(x_0.dtype)
        return dw, dxk, dx0


def cin_layer(w: torch.Tensor, x_k: torch.Tensor, x_0: torch.Tensor
              ) -> torch.Tensor:
    """One CIN layer: (O, H, M), (B, H, D), (B, M, D) -> (B, O, D):
    ``X^{k+1}_o = sum_{h,m} W[o,h,m] * (X^k_h o X^0_m)`` (Hadamard over
    D).  The (B, H, M, D) outer product is the hot spot: the
    ``kernels.cin`` kernel on the card (the plain version on the CPU),
    differentiable through ``CinLayer``."""
    return CinLayer.apply(w, x_k, x_0).to(x_k.dtype)


def make_xdeepfm(cfg: XDeepFMConfig) -> Model:
    spec = E.FieldSpec(tuple(int(c) for c in cfg.cardinalities),
                       cfg.embed_dim)
    f = spec.num_fields

    def init(gen: torch.Generator, device: torch.device,
             with_table: bool = True) -> dict:
        cin = {}
        h = f
        for i, o in enumerate(cfg.cin_layers):
            cin[f"w{i}"] = (torch.randn((o, h, f), generator=gen,
                                        device=device)
                            * (1.0 / math.sqrt(h * f)))
            h = o
        params = {"net": {
            "cin": cin,
            "cin_out": L.dense_bias_init(gen, sum(cfg.cin_layers), 1,
                                         device),
            "deep": L.mlp_init(gen, (f * cfg.embed_dim,) + cfg.mlp + (1,),
                               device)}}
        params["wide_table"] = _wide_table(spec, device)
        if with_table:
            params["embed_table"] = E.init_table(gen, spec, device)
        return params

    def embed(params: dict, batch: dict, field_mask=None) -> torch.Tensor:
        return E.field_lookup(params["embed_table"], batch["indices"], spec,
                              field_mask)

    def cin_logit(params: dict, emb: torch.Tensor) -> torch.Tensor:
        xk = emb
        pooled = []
        for i in range(len(cfg.cin_layers)):
            xk = cin_layer(params["net"]["cin"][f"w{i}"], xk, emb)
            pooled.append(xk.sum(dim=-1))          # (B, O_i)
        feat = torch.cat(pooled, dim=-1)
        return L.dense_bias(params["net"]["cin_out"], feat)[:, 0]

    def head(params: dict, emb: torch.Tensor, batch: dict) -> torch.Tensor:
        b = emb.shape[0]
        deep = L.mlp(params["net"]["deep"], emb.reshape(b, -1))[:, 0]
        return cin_logit(params, emb) + deep + _wide(params, batch, spec)

    def fused_head(params: dict, batch: dict, bag_matmul,
                   emb: torch.Tensor) -> torch.Tensor:
        """``head`` with the deep branch's first matmul fused into the
        gather (``bag_matmul(w)`` as in wide&deep); the CIN still takes
        the (B, F, D) embeddings, so ``emb`` is required."""
        y0 = bag_matmul(params["net"]["deep"]["l0"]["w"])
        deep = L.mlp_tail(params["net"]["deep"], y0)[:, 0]
        return cin_logit(params, emb) + deep + _wide(params, batch, spec)

    def forward(params: dict, batch: dict, field_mask=None) -> torch.Tensor:
        return head(params, embed(params, batch, field_mask), batch)

    return Model("xdeepfm", spec, init, embed, head, forward,
                 _bce_from_emb(head),
                 extras={"fused_head": fused_head, "fused_needs_emb": True})


# ======================================================================
# BERT4Rec (Sun et al. 2019): bidirectional sequence recommendation
# ======================================================================

@dataclasses.dataclass(frozen=True)
class Bert4RecConfig:
    num_items: int = 50002        # incl. [MASK]/[PAD]
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    d_ff_mult: int = 4


def make_bert4rec(cfg: Bert4RecConfig) -> Model:
    """The SHARK fields are {item table, position table}: one stacked
    table laid out ``[items | positions | pad]`` by ``FieldSpec``.
    ``extras``: ``encode`` (B, T) -> (B, T, D), ``item_logits`` (B, T,
    num_items) cloze logits (tied item head), ``seq_loss`` the masked
    cross entropy (the training objective).  The reference's gelu is
    ``jax.nn.gelu``'s tanh form (``layers.gelu``)."""
    spec = E.FieldSpec((cfg.num_items, cfg.seq_len), cfg.embed_dim)
    d = cfg.embed_dim
    hd = d // cfg.n_heads

    def init(gen: torch.Generator, device: torch.device,
             with_table: bool = True) -> dict:
        blocks = []
        for _ in range(cfg.n_blocks):
            blocks.append({
                "wq": L.dense_bias_init(gen, d, d, device),
                "wk": L.dense_bias_init(gen, d, d, device),
                "wv": L.dense_bias_init(gen, d, d, device),
                "wo": L.dense_bias_init(gen, d, d, device),
                "ln1": L.layernorm_init(d, device),
                "ln2": L.layernorm_init(d, device),
                "ffn": L.mlp_init(gen, (d, d * cfg.d_ff_mult, d), device),
            })
        params = {"net": {"blocks": blocks,
                          "ln_f": L.layernorm_init(d, device)}}
        if with_table:
            table = torch.zeros((spec.total_rows, d), device=device)
            rows = cfg.num_items + cfg.seq_len
            table[:rows].normal_(generator=gen).mul_(0.02)
            params["embed_table"] = table
        return params

    def _tables(params):
        t = params["embed_table"]
        return (t[:cfg.num_items],
                t[cfg.num_items:cfg.num_items + cfg.seq_len])

    def encode(params, inputs: torch.Tensor) -> torch.Tensor:
        item, pos = _tables(params)
        b, t = inputs.shape
        x = item[inputs.to(torch.int64)] + pos[None, :t]
        for blk in params["net"]["blocks"]:
            h = L.layernorm(blk["ln1"], x)
            q = L.dense_bias(blk["wq"], h).reshape(b, t, cfg.n_heads, hd)
            k = L.dense_bias(blk["wk"], h).reshape(b, t, cfg.n_heads, hd)
            v = L.dense_bias(blk["wv"], h).reshape(b, t, cfg.n_heads, hd)
            s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
            a = torch.softmax(s, dim=-1)
            o = torch.einsum("bhqk,bkhd->bqhd", a, v)
            x = x + L.dense_bias(blk["wo"], o.reshape(b, t, d))
            h = L.layernorm(blk["ln2"], x)
            x = x + L.mlp(blk["ffn"], h, act=L.gelu)
        return L.layernorm(params["net"]["ln_f"], x)

    def item_logits(params, inputs: torch.Tensor) -> torch.Tensor:
        """(B, T, num_items) cloze logits (tied item embedding head)."""
        hidden = encode(params, inputs)
        item, _ = _tables(params)
        return torch.matmul(hidden, item.t())

    # -- SHARK interface (fields = {item, position} tables) -------------

    def embed(params, batch, field_mask=None) -> torch.Tensor:
        item, pos = _tables(params)
        inputs = batch["inputs"]
        b, t = inputs.shape
        e_item = item[inputs.to(torch.int64)].mean(dim=1)        # (B, D)
        e_pos = pos[:t].mean(dim=0).expand(b, d)
        emb = torch.stack([e_item, e_pos], dim=1)               # (B, 2, D)
        if field_mask is not None:
            emb = emb * field_mask.to(emb.device, emb.dtype)[None, :, None]
        return emb

    def head(params, emb, batch):
        raise NotImplementedError(
            "bert4rec uses sequence loss; see seq_loss/forward")

    def seq_loss(params, batch) -> torch.Tensor:
        """Masked-position cross entropy (the training objective)."""
        logits = item_logits(params, batch["inputs"])
        ce = metrics.softmax_xent(logits, batch["targets"])
        m = batch["mask"]
        return (ce * m).sum() / torch.clamp_min(m.sum(), 1.0)

    def forward(params, batch, field_mask=None) -> torch.Tensor:
        """Score of the true last item (serving: next-item score)."""
        last = item_logits(params, batch["inputs"])[:, -1]
        return torch.gather(last, -1, batch["targets"][:, -1:].to(
            torch.int64))[:, 0]

    def loss_from_emb(params, emb, batch):
        del emb
        return seq_loss(params, batch)[None]

    return Model("bert4rec", spec, init, embed, head, forward,
                 loss_from_emb,
                 extras={"encode": encode, "item_logits": item_logits,
                         "seq_loss": seq_loss})
