"""Shapes, the arch records shared by the configs, and their dry-run
cells.

Port of ``repro/configs/common.py``.  An arch record owns its published
config, ``cells()`` (its shape names), ``smoke()`` (the family smoke at a
reduced size, which the train CLI's ``--smoke`` runs) and
``lowerable(shape, mesh_axis_names, variant=)`` -> ``Cell``: everything
``launch/dryrun.py`` needs.  A cell's arguments are tensors on the
``meta`` device at full width (nothing is allocated) and its specs are
``PartitionSpec`` trees aligned with them (``dist.sharding``).  Training
cells run the generic train step (grad, optimizer, the F-Quantization
hook; ``"optimized"``: the sparse snap, and recsys' sparse-table step);
serving cells prefill, decode, serve from the packed store (the fused
lookup, ``kernels.dequant_bag``'s tiered entry) or score candidates.

Where the reference's train state has a leaf with no tensor here, the
cell has none: the generic step's ``rng`` is a ``torch.Generator`` on a
device and a draw source on ``meta`` (``core.rowwise_quant.meta_uniform``),
not the reference's uint32[2] key.  The port's decode takes the position
as a host int: the cell keeps the reference's 0-d int32 ``cache_len``
argument for its layout and decodes at the sequence's last position (the
port attends every cache slot whatever the position, so the count is the
same).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from repro_torch.dist import sharding as sh
from repro_torch.dist.ctx import PartitionSpec as P

META = torch.device("meta")


def sds(shape, dtype=torch.float32) -> torch.Tensor:
    """An abstract argument: a ``meta`` tensor (shape and dtype only)."""
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                       device=META)


@dataclasses.dataclass
class Cell:
    fn: Callable
    args: tuple            # trees of meta tensors
    in_specs: tuple        # PartitionSpec trees, aligned with args
    kind: str              # "train" | "prefill" | "decode" | "serve"
    donate: tuple = ()     # argnums the step may overwrite
    out_specs: Any = None  # PartitionSpec tree of the outputs, or a
                           # callable outputs -> that tree


TRAIN_METRIC_SPECS = {"loss": P(), "grad_norm": P()}


def data_axes_of(mesh_axis_names) -> Any:
    axes = tuple(a for a in ("pod", "data") if a in mesh_axis_names)
    return axes if len(axes) != 1 else axes[0]


def opt_state_specs(opt_abs, params_abs, pspecs):
    """Spec tree of an optimizer state: moments shaped like their param
    take its spec, row-wise accumulators keep its row axis, the rest
    (scalars) replicate."""

    def match(_, leaf, param, spec):
        if tuple(leaf.shape) == tuple(param.shape):
            return spec
        if tuple(leaf.shape) == tuple(param.shape[:1]):
            return P(spec[0]) if len(spec) else P()
        return P()

    fields = {}
    for f in opt_abs._fields:
        val = getattr(opt_abs, f)
        if f == "step":
            fields[f] = P()
        else:
            fields[f] = sh.tree_map_with_path(match, val, params_abs, pspecs)
    return type(opt_abs)(**fields)


def train_state_specs(state_abs, pspecs, table_path: str | None = None):
    """Spec tree of a ``train.steps.TrainState``: the params', the
    optimizer's, the priorities along the table's row axis."""
    from repro_torch.train.steps import TrainState
    pri_spec = None
    if state_abs.priority is not None:
        row_axis = None
        if table_path is not None:
            tspec = pspecs[table_path]
            row_axis = tspec[0] if len(tspec) else None
        pri_spec = P(row_axis)
    return TrainState(
        params=pspecs,
        opt=opt_state_specs(state_abs.opt, state_abs.params, pspecs),
        step=P(), priority=pri_spec, rng=None)


class Arch:
    """What every family's arch record answers: its name and family,
    whether it is a sequence recsys arch (no field-based serving), its
    sharding ruleset, its cells and their ``lowerable``."""
    name: str = ""
    family: str = ""
    ruleset: str = ""
    seq_model: bool = False

    def cells(self) -> list[str]:
        raise NotImplementedError

    def lowerable(self, shape: str, mesh_axis_names=("data", "model"),
                  variant: str = "baseline") -> Cell:
        """variant: ``"baseline"`` (paper-faithful) or ``"optimized"``
        (the sparse snap and sparse-table levers)."""
        raise NotImplementedError


RECSYS_SHAPES = {
    "train_batch": dict(batch=65536),
    "serve_p99": dict(batch=512),
    "serve_bulk": dict(batch=262144),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000),
}


# steady-state tier fractions for abstract PackedStore shapes (zipf access
# under the paper's t8/t16 thresholds; they only set the tiers' sizes)
TIER_FRACTIONS = (0.70, 0.25, 0.05)


def packed_abs(total_rows: int, dim: int):
    """A ``PackedStore`` of ``total_rows`` (512-padded) rows on ``meta``,
    tiered by ``TIER_FRACTIONS``."""
    from repro_torch.core.packed_store import PackedStore
    v8 = (int(total_rows * TIER_FRACTIONS[0]) // 512) * 512
    v16 = (int(total_rows * TIER_FRACTIONS[1]) // 512) * 512
    v32 = total_rows - v8 - v16
    return PackedStore(
        payload8=sds((v8, dim), torch.int8), scale8=sds((v8,)),
        payload16=sds((v16, dim), torch.bfloat16), scale16=sds((v16,)),
        payload32=sds((v32, dim)), indirect=sds((total_rows,), torch.int32))


def packed_specs(rows_axis):
    from repro_torch.core.packed_store import PackedStore
    return PackedStore(
        payload8=P(rows_axis, None), scale8=P(rows_axis),
        payload16=P(rows_axis, None), scale16=P(rows_axis),
        payload32=P(rows_axis, None), indirect=P(rows_axis))


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
    lr: float = 0.01                 # the dry-run cells' train step
    family: str = "recsys"
    ruleset: str = "recsys"

    def cells(self) -> list[str]:
        return list(RECSYS_SHAPES)

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

    # -- dry-run cells -------------------------------------------------

    def _batch_abs(self, batch: int) -> dict:
        if self.seq_model:
            return {"inputs": sds((batch, self.seq_len), torch.int32),
                    "targets": sds((batch, self.seq_len), torch.int32),
                    "mask": sds((batch, self.seq_len))}
        b = {"indices": sds((batch, self.model.spec.num_fields),
                            torch.int32),
             "labels": sds((batch,))}
        if self.has_dense:
            b["dense"] = sds((batch, self.num_dense))
        return b

    def _batch_specs(self, batch_abs: dict, mesh_axis_names) -> dict:
        d = data_axes_of(mesh_axis_names)
        return {k: P(d, *([None] * (v.ndim - 1)))
                for k, v in batch_abs.items()}

    def lowerable(self, shape: str, mesh_axis_names=("data", "model"),
                  variant: str = "baseline") -> Cell:
        from repro_torch.core.packed_store import lookup_fused, unpack
        from repro_torch.models import embedding as E
        from repro_torch.optim import optimizers as opt_lib
        from repro_torch.train import steps as steps_lib
        model = self.model
        d = data_axes_of(mesh_axis_names)
        info = RECSYS_SHAPES[shape]
        params_abs = model.init(None, META)
        pspecs = sh.param_specs(params_abs, self.ruleset, mesh_axis_names)

        if shape == "train_batch":
            batch_abs = self._batch_abs(info["batch"])
            bspecs = self._batch_specs(batch_abs, mesh_axis_names)
            if variant == "optimized" and not self.seq_model:
                # sparse-table path: gradients w.r.t. the gathered rows;
                # adagrad and the table touch <= B*F rows, not V
                hook = self._fquant_hook(model, sparse=True)
                step = steps_lib.make_sparse_table_train_step(
                    model.embed, model.loss_from_emb, hook.indices_fn,
                    hook.labels_fn, "embed_table", self.lr, fq_cfg=hook.cfg)
                state_abs = step.init_state(params_abs)
                table_spec = pspecs["embed_table"]
                row_axis = table_spec[0] if len(table_spec) else None
                opt_specs = (opt_state_specs(
                    state_abs.opt[0],
                    {k: v for k, v in params_abs.items()
                     if k != "embed_table"},
                    {k: v for k, v in pspecs.items()
                     if k != "embed_table"}), P(row_axis))
                sspecs = steps_lib.TrainState(
                    params=pspecs, opt=opt_specs, step=P(),
                    priority=P(row_axis), rng=None)
                return Cell(step, (state_abs, batch_abs),
                            (sspecs, bspecs), kind="train", donate=(0,),
                            out_specs=(sspecs, TRAIN_METRIC_SPECS))
            optimizer = opt_lib.rowwise_adagrad(self.lr)
            hook = self._fquant_hook(model, sparse=variant == "optimized")
            step = steps_lib.make_train_step(self._loss_fn(), optimizer,
                                             hook)
            state_abs = steps_lib.init_state(params_abs, optimizer, hook)
            sspecs = train_state_specs(state_abs, pspecs, "embed_table")
            return Cell(step, (state_abs, batch_abs), (sspecs, bspecs),
                        kind="train", donate=(0,),
                        out_specs=(sspecs, TRAIN_METRIC_SPECS))

        if shape in ("serve_p99", "serve_bulk"):
            spec = model.spec
            packed = packed_abs(spec.total_rows, spec.dim)
            batch_abs = self._batch_abs(info["batch"])
            bspecs = self._batch_specs(batch_abs, mesh_axis_names)
            # dense-side params only (the table is served from the store)
            net_abs = {k: v for k, v in params_abs.items()
                       if k != "embed_table"}
            net_specs = {k: v for k, v in pspecs.items()
                         if k != "embed_table"}

            if self.seq_model:
                def fn(net, packed, batch):
                    # small vocab: dequantize the table once a batch
                    with torch.no_grad():
                        p = dict(net)
                        p["embed_table"] = unpack(packed)
                        return model.forward(p, batch)
            else:
                def fn(net, packed, batch):
                    with torch.no_grad():
                        gidx = E.globalize(batch["indices"], spec)
                        # the port's fused serving path (the reference's
                        # cell calls its plain ``lookup``)
                        emb = lookup_fused(packed, gidx)   # (B, F, D)
                        p = dict(net)
                        p["embed_table"] = packed.payload32  # unused
                        return model.head(p, emb, batch)

            return Cell(fn, (net_abs, packed, batch_abs),
                        (net_specs, packed_specs("model"), bspecs),
                        kind="serve", out_specs=P(d))

        if shape == "retrieval_cand":
            n = info["n_candidates"]
            dim = model.spec.dim
            cand_axes = tuple(a for a in ("pod", "model")
                              if a in mesh_axis_names)
            batch_abs = self._batch_abs(info["batch"])

            def fn(params, cand_payload, cand_scales, batch):
                with torch.no_grad():
                    if self.seq_model:
                        user = model.extras["encode"](
                            params, batch["inputs"])[:, -1]     # (1, D)
                    else:
                        user = model.embed(params, batch).mean(dim=1)
                    scores = torch.einsum(
                        "nd,bd->bn", cand_payload.to(torch.float32),
                        user.to(torch.float32)) * cand_scales[None, :]
                    vals, idx = torch.topk(scores, 100)
                    return vals, idx.to(torch.int32)

            return Cell(
                fn, (params_abs, sds((n, dim), torch.int8), sds((n,)),
                     batch_abs),
                (pspecs, P(cand_axes, None), P(cand_axes),
                 {k: P() for k in batch_abs}),
                kind="serve", out_specs=(P(), P()))

        raise KeyError(shape)

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
    ruleset: str = "lm"

    def cells(self) -> list[str]:
        out = ["train_4k", "prefill_32k", "decode_32k"]
        if self.supports_long:
            out.append("long_500k")
        return out

    def _fquant_hook(self, sparse: bool = False):
        """The F-Quantization hook on the token table (``embed``), one
        positive label a sequence."""
        from repro_torch.core.qat_store import FQuantConfig
        from repro_torch.train.steps import FQuantHook
        if not self.fquant:
            return None
        return FQuantHook(cfg=FQuantConfig(), table_path="embed",
                          indices_fn=lambda b: b["tokens"],
                          labels_fn=_ones_labels("tokens"),
                          sparse_snap=sparse)

    # -- dry-run cells -------------------------------------------------

    def _params_abs(self, cfg) -> dict:
        from repro_torch.models import transformer as T
        return T.init_params(None, cfg, META)

    def _train_cell(self, cfg, batch: int, seq: int, mesh_axis_names,
                    variant: str = "baseline") -> Cell:
        from repro_torch.models import transformer as T
        from repro_torch.optim import optimizers as opt_lib
        from repro_torch.train import steps as steps_lib
        d = data_axes_of(mesh_axis_names)
        optimizer = opt_lib.adam(self.lr)
        hook = self._fquant_hook(sparse=variant == "optimized")
        if variant == "optimized" and cfg.moe is not None:
            # block-local MoE dispatch: per-data-shard capacity buffers
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, dispatch_blocks=32))
        step = steps_lib.make_train_step(
            lambda p, b: T.lm_loss(p, cfg, b["tokens"]), optimizer, hook)
        params_abs = self._params_abs(cfg)
        state_abs = steps_lib.init_state(params_abs, optimizer, hook)
        pspecs = sh.param_specs(params_abs, self.ruleset, mesh_axis_names)
        sspecs = train_state_specs(state_abs, pspecs, "embed")
        return Cell(step, (state_abs, {"tokens": sds((batch, seq),
                                                     torch.int32)}),
                    (sspecs, {"tokens": P(d, None)}), kind="train",
                    donate=(0,), out_specs=(sspecs, TRAIN_METRIC_SPECS))

    def _cache_specs(self, cache_abs: dict, mesh_axis_names,
                     shard_batch: bool, model_size: int = 16,
                     data_size: int = 16) -> dict:
        d = data_axes_of(mesh_axis_names) if shard_batch else None

        def fits(dim: int) -> bool:
            return dim % model_size == 0

        def assign(path, leaf):
            if "pos" in sh.pathstr(path):
                return P()
            db = d if (d is not None
                       and leaf.shape[1] % data_size == 0) else None
            if leaf.ndim == 5:    # (L, B, S, Hkv, Dh)
                # kv heads rarely divide 16; fall back to head_dim
                if fits(leaf.shape[3]):
                    return P(None, db, None, "model", None)
                if fits(leaf.shape[4]):
                    return P(None, db, None, None, "model")
                return P(None, db, None, None, None)
            if leaf.ndim == 4:    # (L, B, S, R) MLA latent
                if fits(leaf.shape[3]):
                    return P(None, db, None, "model")
                return P(None, db, None, None)
            return P()

        return sh.tree_map_with_path(assign, cache_abs)

    def _serve_out_specs(self, out, mesh_axis_names, shard_batch: bool):
        """(logits, caches...) output specs: vocab-sharded logits, cache
        dims sharded as the input cache's rules."""
        d = data_axes_of(mesh_axis_names) if shard_batch else None
        vocab_ok = self.lm_cfg.vocab % 16 == 0

        def assign(path, leaf):
            if path[0] == 0:     # logits (B, 1|T, V)
                return P(d, None, "model" if vocab_ok else None)
            if "pos" in sh.pathstr(path):
                return P()
            shp = leaf.shape
            if leaf.ndim == 5:
                if shp[3] % 16 == 0:
                    return P(None, d, None, "model", None)
                if shp[4] % 16 == 0:
                    return P(None, d, None, None, "model")
                return P(None, d, None, None, None)
            if leaf.ndim == 4:   # (L, B, T, R) stacked latent
                return P(None, d, None,
                         "model" if shp[3] % 16 == 0 else None)
            if leaf.ndim == 3:   # (B, T, R) unstacked (first-dense cache)
                return P(d, None, "model" if shp[2] % 16 == 0 else None)
            return P()

        return sh.tree_map_with_path(assign, out)

    def lowerable(self, shape: str, mesh_axis_names=("data", "model"),
                  variant: str = "baseline") -> Cell:
        from repro_torch.models import transformer as T
        cfg = self.lm_cfg
        d = data_axes_of(mesh_axis_names)
        info = LM_SHAPES[shape]
        if shape == "train_4k":
            return self._train_cell(cfg, info["batch"], info["seq"],
                                    mesh_axis_names, variant)

        params_abs = self._params_abs(cfg)
        pspecs = sh.param_specs(params_abs, self.ruleset, mesh_axis_names)

        if shape == "prefill_32k":
            def fn(p, toks):
                with torch.no_grad():
                    return T.prefill(p, cfg, toks)
            toks = sds((info["batch"], info["seq"]), torch.int32)
            return Cell(fn, (params_abs, toks), (pspecs, P(d, None)),
                        kind="prefill", out_specs=functools.partial(
                            self._serve_out_specs,
                            mesh_axis_names=mesh_axis_names,
                            shard_batch=True))

        # decode shapes
        batch = info["batch"]
        rolling = bool(shape == "long_500k" and self.rolling_window)
        cache_len_max = self.rolling_window if rolling else info["seq"]
        cache_abs = T.init_cache(cfg, batch, cache_len_max, torch.bfloat16,
                                 rolling=rolling, device=META)
        cspecs = self._cache_specs(cache_abs, mesh_axis_names,
                                   shard_batch=batch > 1)
        position = info["seq"] - 1

        def fn(p, tok, cache, cache_len):
            del cache_len   # a host int in the port: the last position
            with torch.no_grad():
                return T.decode_step(p, cfg, tok, cache, position)

        tok_spec = P(d, None) if batch > 1 else P()
        args = (params_abs, sds((batch, 1), torch.int32), cache_abs,
                sds((), torch.int32))
        return Cell(fn, args, (pspecs, tok_spec, cspecs, P()),
                    kind="decode", donate=(2,), out_specs=functools.partial(
                        self._serve_out_specs,
                        mesh_axis_names=mesh_axis_names,
                        shard_batch=batch > 1))

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
    ruleset: str = "gnn"

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

    def _fquant_hook(self, sparse: bool = False):
        """The F-Quantization hook on the node-id table, one positive
        label a block node (1-D indices)."""
        from repro_torch.core.qat_store import FQuantConfig
        from repro_torch.train.steps import FQuantHook
        return FQuantHook(cfg=FQuantConfig(), table_path="embed_table",
                          indices_fn=lambda b: b["node_ids"],
                          labels_fn=_ones_labels("node_ids"),
                          sparse_snap=sparse)

    def lowerable(self, shape: str, mesh_axis_names=("data", "model"),
                  variant: str = "baseline") -> Cell:
        from repro_torch.models import gnn as G
        from repro_torch.optim import optimizers as opt_lib
        from repro_torch.train import steps as steps_lib
        cfg = self._cfg(shape)
        info = GNN_SHAPES[shape]
        d = data_axes_of(mesh_axis_names)
        # ragged graph arrays padded to mesh-divisible sizes (padding
        # edges point at a dummy node / carry zero weight in a real run)
        n_nodes, n_edges, n_seeds = (-(-n // 512) * 512
                                     for n in self._block_shape(shape))
        batch_abs = {"features": sds((n_nodes, info["d_feat"])),
                     "src": sds((n_edges,), torch.int32),
                     "dst": sds((n_edges,), torch.int32)}
        bspecs = {"features": P(d, None), "src": P(d), "dst": P(d)}
        if shape == "molecule":
            batch_abs["graph_ids"] = sds((n_nodes,), torch.int32)
            batch_abs["labels"] = sds((n_seeds,))
            bspecs["graph_ids"] = P(d)
            bspecs["labels"] = P(d)

            def loss_fn(p, b):
                return G.graph_loss(p, cfg, b)
        else:
            batch_abs["labels"] = sds((n_seeds,), torch.int32)
            bspecs["labels"] = P(d)
            if shape == "minibatch_lg":
                batch_abs["node_ids"] = sds((n_nodes,), torch.int32)
                batch_abs["seed_local"] = sds((n_seeds,), torch.int32)
                bspecs["node_ids"] = P(d)
                bspecs["seed_local"] = P(d)

            def loss_fn(p, b):
                return G.node_loss(p, cfg, b)

        params_abs = G.init_params(None, cfg, META)
        pspecs = sh.param_specs(params_abs, self.ruleset, mesh_axis_names)
        optimizer = opt_lib.adam(self.lr)
        hook = (self._fquant_hook(sparse=variant == "optimized")
                if cfg.node_vocab else None)
        step = steps_lib.make_train_step(loss_fn, optimizer, hook)
        state_abs = steps_lib.init_state(params_abs, optimizer, hook)
        sspecs = train_state_specs(state_abs, pspecs, "embed_table")
        return Cell(step, (state_abs, batch_abs), (sspecs, bspecs),
                    kind="train", donate=(0,),
                    out_specs=(sspecs, TRAIN_METRIC_SPECS))

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
