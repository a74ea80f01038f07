"""Shapes and the recsys arch record shared by the configs.

Port of the recsys part of ``repro/configs/common.py``: the arch record
and the recsys family smoke (``RecsysArch.smoke``, ``:539-585``), which
the train CLI's ``--smoke`` runs and which is a sequence arch's (bert4rec)
only training path.
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


@dataclasses.dataclass
class RecsysArch:
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
