"""PNA: Principal Neighbourhood Aggregation (Corso et al. 2020).

Port of ``repro/models/gnn.py``: message passing over an edge list, the
reference's ``jax.ops.segment_*`` as ``index_add`` (sums, counts) and
``scatter_reduce("amax", include_self=False)`` over a ``-inf`` fill
(max; the min is ``-max(-msg)``), each non-finite result set to 0 as in
the reference (an empty segment, or a non-finite message).

Per layer:  m_ij = MLP_msg([h_i, h_j])
            agg  = [mean, max, min, std]  over incoming edges
            scal = [1, log(d+1)/delta, delta/log(d+1)]
            h_i' = LN(h_i + MLP_upd([h_i, concat(agg x scal)]))

Shapes: node features (N, F_in); edges (src, dst) int (E,).  An optional
learned node-id table (``minibatch_lg``: 232,965 rows padded to 233,472)
is where F-Quantization applies in this family.  Params are the
reference's nesting (``enc``, ``embed_table``, ``layer_{i}.msg/upd/ln``,
``out``), so ``convert.params_from_jax`` carries them across.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.metrics import softmax_xent
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    d_in: int
    d_hidden: int = 75
    n_layers: int = 4
    num_classes: int = 16
    delta: float = 2.5            # avg log-degree normaliser
    node_vocab: int = 0           # > 0: learned id-embedding table
    graph_readout: bool = False   # molecule cell: per-graph regression


def init_params(gen: torch.Generator, cfg: PNAConfig,
                device: torch.device) -> dict:
    d = cfg.d_hidden
    p: dict = {"enc": L.dense_bias_init(gen, max(cfg.d_in, 1), d, device)}
    if cfg.node_vocab:
        p["embed_table"] = torch.randn((cfg.node_vocab, d), generator=gen,
                                       device=device).mul_(0.02)
    for i in range(cfg.n_layers):
        p[f"layer_{i}"] = {
            "msg": L.mlp_init(gen, (2 * d, d, d), device),
            "upd": L.mlp_init(gen, (d + 12 * d, d, d), device),
            "ln": L.layernorm_init(d, device),
        }
    p["out"] = L.dense_bias_init(gen, d, 1 if cfg.graph_readout
                                 else cfg.num_classes, device)
    return p


def _segment_max(msg: torch.Tensor, dst: torch.Tensor, n: int
                 ) -> torch.Tensor:
    """Per-segment max over rows of ``msg``; non-finite results (an empty
    segment's -inf, a non-finite message) are 0."""
    out = torch.full((n, msg.shape[1]), -torch.inf, dtype=msg.dtype,
                     device=msg.device)
    idx = dst[:, None].expand(msg.shape)
    mx = out.scatter_reduce(0, idx, msg, "amax", include_self=False)
    return torch.where(torch.isfinite(mx), mx, 0.0)


def _aggregate(msg: torch.Tensor, dst: torch.Tensor, n: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The 4 PNA aggregators and the in-degree.  msg (E, D), dst int64
    (E,) -> (N, 4D), deg (N,)."""
    ones = torch.ones((msg.shape[0],), dtype=torch.float32,
                      device=msg.device)
    deg = torch.zeros((n,), dtype=torch.float32,
                      device=msg.device).index_add(0, dst, ones)
    zeros = torch.zeros((n, msg.shape[1]), dtype=msg.dtype,
                        device=msg.device)
    s = zeros.index_add(0, dst, msg)
    den = torch.clamp_min(deg, 1.0)[:, None]
    mean = s / den
    sq = zeros.index_add(0, dst, torch.square(msg))
    q = sq / den
    # the jitted reference contracts ``q - mean ** 2`` into one FMA, which
    # rounds the exact difference once: at in-degree 1 its variance is the
    # rounding error of x^2, not 0, and the std is sqrt(that + 1e-8).  In
    # float64 mean^2 is exact, so is the difference where it cancels, and
    # the cast rounds it once as the FMA does.  Its cost on the card: five
    # (N, D) elementwise passes moving ~76 bytes an entry, where the fp32
    # expression's two move 20
    var = (q.double() - torch.square(mean.double())).to(q.dtype)
    var = torch.clamp_min(var, 0.0)
    std = torch.sqrt(var + 1e-8)
    mx = _segment_max(msg, dst, n)
    mn = -_segment_max(-msg, dst, n)
    return torch.cat([mean, mx, mn, std], dim=-1), deg


def pna_layer(params: dict, cfg: PNAConfig, h: torch.Tensor,
              src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    n = h.shape[0]
    m_in = torch.cat([h[dst], h[src]], dim=-1)             # (E, 2D)
    msg = L.mlp(params["msg"], m_in, act=torch.relu, final_act=True)
    agg, deg = _aggregate(msg, dst, n)                     # (N, 4D)
    logd = torch.log(deg + 1.0)[:, None]
    amp = logd / cfg.delta
    att = cfg.delta / torch.clamp_min(logd, 1e-6)
    scaled = torch.cat([agg, agg * amp, agg * att], dim=-1)   # 12D
    upd_in = torch.cat([h, scaled.to(h.dtype)], dim=-1)
    out = L.mlp(params["upd"], upd_in, act=torch.relu, final_act=True)
    return L.layernorm(params["ln"], h + out)


def forward(params: dict, cfg: PNAConfig, batch: dict) -> torch.Tensor:
    """batch: features (N, F), src / dst (E,), optional node_ids (N,),
    optional graph_ids (N,) for the graph readout.  Returns node logits
    (N, C) or graph predictions (G,)."""
    feats = batch["features"]
    if feats.shape[-1] > 0:
        h = L.dense_bias(params["enc"], feats)
    else:
        h = torch.zeros((feats.shape[0], cfg.d_hidden), dtype=torch.float32,
                        device=feats.device)
    if cfg.node_vocab and "node_ids" in batch:
        h = h + params["embed_table"][batch["node_ids"].long()]
    h = torch.relu(h)
    src, dst = batch["src"].long(), batch["dst"].long()
    for i in range(cfg.n_layers):
        h = pna_layer(params[f"layer_{i}"], cfg, h, src, dst)
    if cfg.graph_readout:
        g = batch["graph_ids"].long()
        ngraphs = int(batch["labels"].shape[0])
        pooled = torch.zeros((ngraphs, h.shape[1]), dtype=h.dtype,
                             device=h.device).index_add(0, g, h)
        cnt = torch.zeros((ngraphs,), dtype=torch.float32,
                          device=h.device).index_add(
            0, g, torch.ones(g.shape, dtype=torch.float32, device=h.device))
        pooled = pooled / torch.clamp_min(cnt, 1.0)[:, None]
        return L.dense_bias(params["out"], pooled)[:, 0]
    return L.dense_bias(params["out"], h)


def node_loss(params: dict, cfg: PNAConfig, batch: dict) -> torch.Tensor:
    """Cross entropy on the seed nodes (all nodes for a full batch)."""
    logits = forward(params, cfg, batch)
    if "seed_local" in batch:
        logits = logits[batch["seed_local"].long()]
    return softmax_xent(logits, batch["labels"]).mean()


def graph_loss(params: dict, cfg: PNAConfig, batch: dict) -> torch.Tensor:
    pred = forward(params, cfg, batch)
    return torch.mean(torch.square(pred - batch["labels"]))
