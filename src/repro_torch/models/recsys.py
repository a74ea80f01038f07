"""Recsys models: DLRM, Wide&Deep and xDeepFM.

Port of ``repro/models/recsys.py`` (``make_dlrm``, ``make_wide_deep``,
``make_xdeepfm``).  Every model exposes the SHARK interface: ``init``,
``embed``, ``head``, ``forward``, ``loss_from_emb`` and ``spec`` (the
stacked table); params keep the reference's nesting, so ``convert.py``
carries them across unchanged:

    dlrm       {"embed_table", "net": {"bot", "top"}}
    wide_deep  {"embed_table", "wide_table", "net": {"deep", "bias"}}
    xdeepfm    {"embed_table", "wide_table",
                "net": {"cin": {"w0", ...}, "cin_out", "deep"}}

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


def cin_layer(w: torch.Tensor, x_k: torch.Tensor, x_0: torch.Tensor
              ) -> torch.Tensor:
    """One CIN layer: (O, H, M), (B, H, D), (B, M, D) -> (B, O, D):
    ``X^{k+1}_o = sum_{h,m} W[o,h,m] * (X^k_h o X^0_m)`` (Hadamard over
    D).  The (B, H, M, D) outer product is the hot spot: the
    ``kernels.cin`` kernel on the card (the plain version on the CPU)."""
    return cin_ops.cin_layer(w, x_k, x_0).to(x_k.dtype)


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
