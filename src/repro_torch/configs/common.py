"""Shapes and the arch records shared by the configs.

Port of ``repro/configs/common.py``: each family's arch record and its
family smoke, which the train CLI's ``--smoke`` runs.  Recsys
(``RecsysArch.smoke``, ``:539-585``): a sequence arch's (bert4rec) only
training path.  LM (``LMArch``, ``:298-338``) and GNN (``GNNArch``,
``:594-724``): the only path of those families in the train CLI, as in
the reference.  The reference's ``lowerable`` (the dry-run's abstract
cells) is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

RECSYS_SHAPES = {
    "train_batch": dict(batch=65536),
    "serve_p99": dict(batch=512),
    "serve_bulk": dict(batch=262144),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000),
}


class Arch:
    """What every family's arch record answers: its name and family, and
    whether it is a sequence recsys arch (no field-based serving)."""
    name: str = ""
    family: str = ""
    seq_model: bool = False


@dataclasses.dataclass
class RecsysArch(Arch):
    model: Any                       # models.recsys.Model (full size)
    smoke_model: Any                 # reduced
    num_dense: int = 13              # dense features of the full model
    smoke_num_dense: int = 5         # reduced config's dense width (0:
                                     # the model takes no dense input)
    name: str = ""
    cfg: Any = None                  # the full model's config dataclass
    smoke_cfg: Any = None            # the reduced one's
    seq_model: bool = False          # BERT4Rec batch format
    seq_len: int = 200
    family: str = "recsys"

    @property
    def has_dense(self) -> bool:
        """The model takes dense features (DLRM)."""
        return self.smoke_num_dense > 0

    def _loss_fn(self, model=None):
        """``(params, batch) -> scalar``: the sequence loss, or the mean
        per-sample loss of the field head."""
        model = model or self.model
        if self.seq_model:
            return lambda p, b: model.extras["seq_loss"](p, b)
        return lambda p, b: model.loss_from_emb(
            p, model.embed(p, b), b).mean()

    def _fquant_hook(self, model, sparse: bool = False):
        from repro_torch.core.qat_store import FQuantConfig
        from repro_torch.models import embedding as E
        from repro_torch.train.steps import FQuantHook
        if self.seq_model:
            return FQuantHook(
                cfg=FQuantConfig(), table_path="embed_table",
                indices_fn=lambda b: b["inputs"],
                labels_fn=lambda b: torch.ones(
                    b["inputs"].shape[0], dtype=torch.float32,
                    device=b["inputs"].device),
                sparse_snap=sparse)
        spec = model.spec
        return FQuantHook(
            cfg=FQuantConfig(), table_path="embed_table",
            indices_fn=lambda b: E.globalize(b["indices"], spec),
            labels_fn=lambda b: b["labels"], sparse_snap=sparse)

    def smoke(self, device=None) -> dict:
        """The family smoke at the reduced size: three generic train steps
        (row-wise adagrad 0.05, the F-Quantization hook) on one batch,
        then the table packed and unpacked and a forward through it.
        Returns loss_first, loss_last, serve_shape and finite (the losses
        and the forward all finite).  On ``cuda`` unless ``device``
        says otherwise; raises without a GPU."""
        from repro_torch import resolve_device
        from repro_torch.core.packed_store import pack, unpack
        from repro_torch.core.qat_store import FQuantConfig, QATStore
        from repro_torch.optim import optimizers as opt_lib
        from repro_torch.train import steps as steps_lib
        dev = resolve_device(device)
        model = self.smoke_model
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = model.init(gen, dev)
        batch = self._smoke_batch(model, dev)
        optimizer = opt_lib.rowwise_adagrad(0.05)
        hook = self._fquant_hook(model)
        step = steps_lib.make_train_step(self._loss_fn(model), optimizer,
                                         hook)
        state = steps_lib.init_state(params, optimizer, hook)
        losses = []
        for _ in range(3):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        # serve smoke through the packed store
        store = QATStore(table=state.params["embed_table"],
                         priority=state.priority)
        p2 = dict(state.params)
        p2["embed_table"] = unpack(pack(store, FQuantConfig()))
        with torch.no_grad():
            out = model.forward(p2, batch)
        finite = (all(torch.isfinite(torch.tensor(losses)).tolist())
                  and bool(torch.isfinite(out).all()))
        return {"loss_first": losses[0], "loss_last": losses[-1],
                "serve_shape": tuple(out.shape), "finite": finite}

    def _smoke_batch(self, model, device) -> dict:
        """The smoke's one batch, drawn from a seeded ``torch.Generator``
        on ``device`` (the reference draws it with ``jax.random``): 4
        sequences of the position table's length, or 8 field rows."""
        gen = torch.Generator(device=device)
        gen.manual_seed(7)
        if self.seq_model:
            t = model.spec.cardinalities[1]   # position table = seq_len
            items = model.spec.cardinalities[0]
            return {"inputs": torch.randint(0, items, (4, t), generator=gen,
                                            device=device,
                                            dtype=torch.int32),
                    "targets": torch.randint(0, items - 2, (4, t),
                                             generator=gen, device=device,
                                             dtype=torch.int32),
                    "mask": torch.ones((4, t), device=device)}
        f = model.spec.num_fields
        idx = torch.randint(0, min(model.spec.cardinalities), (8, f),
                            generator=gen, device=device, dtype=torch.int32)
        b = {"indices": idx,
             "labels": torch.tensor([0., 1., 0., 1., 1., 0., 0., 1.],
                                    device=device)}
        if self.has_dense:
            b["dense"] = torch.randn((8, self.smoke_num_dense),
                                     generator=gen, device=device)
        return b


# ======================================================================
# LM family
# ======================================================================

LM_SHAPES = {
    "train_4k": dict(seq=4096, batch=256),
    "prefill_32k": dict(seq=32768, batch=32),
    "decode_32k": dict(seq=32768, batch=128),
    "long_500k": dict(seq=524288, batch=1),
}


def _ones_labels(key: str):
    """The hook's labels: one positive a row of ``batch[key]``."""
    return lambda b: torch.ones(b[key].shape[0], dtype=torch.float32,
                                device=b[key].device)


@dataclasses.dataclass
class LMArch(Arch):
    lm_cfg: Any                      # transformer.LMConfig (full size)
    smoke_cfg: Any                   # reduced same-family config
    supports_long: bool = False      # a sub-quadratic decode path exists
    rolling_window: int | None = None  # SWA serving cache (mixtral)
    lr: float = 3e-4
    fquant: bool = True              # F-Quantization on the token table
    name: str = ""
    family: str = "lm"

    def cells(self) -> list[str]:
        out = ["train_4k", "prefill_32k", "decode_32k"]
        if self.supports_long:
            out.append("long_500k")
        return out

    def _fquant_hook(self):
        """The F-Quantization hook on the token table (``embed``), one
        positive label a sequence."""
        from repro_torch.core.qat_store import FQuantConfig
        from repro_torch.train.steps import FQuantHook
        if not self.fquant:
            return None
        return FQuantHook(cfg=FQuantConfig(), table_path="embed",
                          indices_fn=lambda b: b["tokens"],
                          labels_fn=_ones_labels("tokens"))

    def smoke(self, device=None) -> dict:
        """The family smoke at the reduced size: three generic train steps
        (Adam 1e-3, the hook on ``embed``) on one (2, 16) token batch, then
        one decode step over a 32-slot cache at position 3.  Returns
        loss_first, loss_last, decode_logits_shape and finite.  On
        ``cuda`` unless ``device`` says otherwise; raises without a
        GPU."""
        from repro_torch import resolve_device
        from repro_torch.models import transformer as T
        from repro_torch.optim import optimizers as opt_lib
        from repro_torch.train import steps as steps_lib
        dev = resolve_device(device)
        cfg = self.smoke_cfg
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = T.init_params(gen, cfg, dev)
        gen.manual_seed(1)
        toks = torch.randint(0, cfg.vocab, (2, 16), generator=gen,
                             device=dev, dtype=torch.int32)
        optimizer = opt_lib.adam(1e-3)
        hook = self._fquant_hook()
        step = steps_lib.make_train_step(
            lambda p, b: T.lm_loss(p, cfg, b["tokens"]), optimizer, hook)
        state = steps_lib.init_state(params, optimizer, hook)
        losses = []
        for _ in range(3):
            state, m = step(state, {"tokens": toks})
            losses.append(float(m["loss"]))
        cache = T.init_cache(cfg, 2, 32, device=dev)
        with torch.no_grad():
            logits, _ = T.decode_step(state.params, cfg, toks[:, :1], cache,
                                      3)
        finite = (all(torch.isfinite(torch.tensor(losses)).tolist())
                  and bool(torch.isfinite(logits).all()))
        return {"loss_first": losses[0], "loss_last": losses[-1],
                "decode_logits_shape": tuple(logits.shape),
                "finite": finite}


# ======================================================================
# GNN family (PNA)
# ======================================================================

GNN_SHAPES = {
    "full_graph_sm": dict(n_nodes=2708, n_edges=10556, d_feat=1433),
    "minibatch_lg": dict(n_nodes=232965, n_edges=114615892,
                         batch_nodes=1024, fanout=(15, 10), d_feat=602),
    "ogb_products": dict(n_nodes=2449029, n_edges=61859140, d_feat=100),
    "molecule": dict(n_nodes=30, n_edges=64, batch=128, d_feat=16),
}


@dataclasses.dataclass
class GNNArch(Arch):
    d_hidden: int = 75
    n_layers: int = 4
    lr: float = 0.01
    name: str = "pna"
    family: str = "gnn"

    def cells(self) -> list[str]:
        return list(GNN_SHAPES)

    def _cfg(self, shape: str):
        """The cell's ``PNAConfig``: ``minibatch_lg`` with its node-id
        table (512-padded), ``molecule`` with the graph readout."""
        from repro_torch.models.gnn import PNAConfig
        info = GNN_SHAPES[shape]
        if shape == "minibatch_lg":
            vocab = -(-info["n_nodes"] // 512) * 512
            return PNAConfig(d_in=info["d_feat"], d_hidden=self.d_hidden,
                             n_layers=self.n_layers, node_vocab=vocab)
        if shape == "molecule":
            return PNAConfig(d_in=info["d_feat"], d_hidden=self.d_hidden,
                             n_layers=self.n_layers, graph_readout=True)
        return PNAConfig(d_in=info["d_feat"], d_hidden=self.d_hidden,
                         n_layers=self.n_layers)

    def _block_shape(self, shape: str) -> tuple[int, int, int]:
        """Static (n_block_nodes, n_block_edges, n_seeds) of a cell: the
        sampled block's bound for ``minibatch_lg``."""
        info = GNN_SHAPES[shape]
        if shape == "minibatch_lg":
            s = info["batch_nodes"]
            f1, f2 = info["fanout"]
            l1 = s * f1
            l2 = s * f1 * f2
            return s + l1 + l2, l1 + l2, s
        if shape == "molecule":
            return (info["batch"] * info["n_nodes"],
                    info["batch"] * info["n_edges"], info["batch"])
        return info["n_nodes"], info["n_edges"], info["n_nodes"]

    def _fquant_hook(self):
        """The F-Quantization hook on the node-id table, one positive
        label a block node (1-D indices)."""
        from repro_torch.core.qat_store import FQuantConfig
        from repro_torch.train.steps import FQuantHook
        return FQuantHook(cfg=FQuantConfig(), table_path="embed_table",
                          indices_fn=lambda b: b["node_ids"],
                          labels_fn=_ones_labels("node_ids"))

    def smoke(self, device=None) -> dict:
        """The family smoke at the reduced size: a 400-node graph, one
        16-seed block with fanout 4-3, three generic train steps (Adam
        0.01, the hook on the node-id table), then a forward.  Returns
        loss_first, loss_last, serve_shape and finite.  On ``cuda``
        unless ``device`` says otherwise; raises without a GPU."""
        import numpy as np

        from repro_torch import resolve_device
        from repro_torch.data.graphs import padded_subgraph, random_graph
        from repro_torch.models import gnn as G
        from repro_torch.models.gnn import PNAConfig
        from repro_torch.optim import optimizers as opt_lib
        from repro_torch.train import steps as steps_lib
        dev = resolve_device(device)
        g = random_graph(400, 6, 12, seed=3)
        blk = padded_subgraph(g, np.arange(16), (4, 3), seed=1)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in blk.items()}
        cfg = PNAConfig(d_in=12, d_hidden=16, n_layers=2, node_vocab=400)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = G.init_params(gen, cfg, dev)
        optimizer = opt_lib.adam(self.lr)
        hook = self._fquant_hook()
        step = steps_lib.make_train_step(
            lambda p, b: G.node_loss(p, cfg, b), optimizer, hook)
        state = steps_lib.init_state(params, optimizer, hook)
        losses = []
        for _ in range(3):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        with torch.no_grad():
            logits = G.forward(state.params, cfg, batch)
        finite = (all(torch.isfinite(torch.tensor(losses)).tolist())
                  and bool(torch.isfinite(logits).all()))
        return {"loss_first": losses[0], "loss_last": losses[-1],
                "serve_shape": tuple(logits.shape), "finite": finite}
