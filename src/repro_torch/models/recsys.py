"""DLRM (Naumov et al. 2019), the paper's public-dataset baseline model.

Port of ``repro/models/recsys.py::make_dlrm``: the bottom MLP (ReLU after
every layer, the last included) projects the dense features to the
embedding width; the dot interaction takes the upper triangle (k=1,
row-major, as ``jnp.triu_indices``) of the Gram of [dense, field
embeddings]; the top MLP maps [dense, interactions] to one logit.

    params = {"net": {"bot": mlp params, "top": mlp params}}

The embedding table is not among the params: serving holds only its
packed store, built chunk by chunk (``embedding.table_rows`` +
``packed_store.build_chunked``), and ``head`` takes the looked-up
embeddings.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.models import embedding as E
from repro_torch.models import layers as L


class Model(NamedTuple):
    """Bound model API (callables close over the config)."""
    name: str
    spec: E.FieldSpec
    init: Callable    # (gen, device) -> params
    head: Callable    # (params, emb (B, F, D), batch) -> (B,) logits


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

    def init(gen: torch.Generator, device: torch.device) -> dict:
        return {"net": {
            "bot": L.mlp_init(gen, (cfg.num_dense,) + cfg.bot_mlp, device),
            "top": L.mlp_init(gen, (top_in,) + cfg.top_mlp, device)}}

    def head(params: dict, emb: torch.Tensor, batch: dict) -> torch.Tensor:
        dense = L.mlp(params["net"]["bot"], batch["dense"], final_act=True)
        feats = torch.cat([dense[:, None, :], emb], dim=1)    # (B, F+1, D)
        inter = torch.bmm(feats, feats.transpose(1, 2))       # (B, F+1, F+1)
        iu, ju = torch.triu_indices(f + 1, f + 1, offset=1,
                                    device=emb.device)
        z = torch.cat([dense, inter[:, iu, ju]], dim=-1)      # (B, top_in)
        return L.mlp(params["net"]["top"], z)[:, 0]

    return Model("dlrm", spec, init, head)
