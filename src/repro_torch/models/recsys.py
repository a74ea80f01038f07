"""DLRM (Naumov et al. 2019), the paper's public-dataset baseline model.

Port of ``repro/models/recsys.py::make_dlrm``: the bottom MLP (ReLU after
every layer, the last included) projects the dense features to the
embedding width; the dot interaction takes the upper triangle (k=1,
row-major, as ``jnp.triu_indices``) of the Gram of [dense, field
embeddings]; the top MLP maps [dense, interactions] to one logit.

    params = {"embed_table": (sum_f V_f, D), "net": {"bot": mlp params,
                                                     "top": mlp params}}

as in the reference.  ``init(gen, device, with_table=False)`` leaves the
table out: serving holds only its packed store, built chunk by chunk
(``embedding.table_rows`` + ``packed_store.build_chunked``).  The net is
drawn first, so it is the same with and without the table.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.core import metrics
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
