"""Recsys training-stage setup for the training CLI.

Port of ``repro/train/setup.py``: a synthetic click-log stream matched to
the model's FieldSpec, the compressed train step and its initial state,
on one device or placed over a mesh (``place_train_state``: the
row-aligned leaves a shard a device, as the reference places them).

``model="smoke"`` is the reference's training size (its setup always
trains the smoke model); ``model="full"`` trains the published widths.
``max_ind_range`` caps every field's cardinality, as the DLRM
reference's ``--max-ind-range`` flag does (facebookresearch/dlrm,
``dlrm_s_pytorch.py``): at full width the table, its dense gradient
and the (V,) state must fit the cards that hold them.  On one 80 GB card
204,185,088 rows do not (2 x 52.3 GB), so ``launch/train.py`` caps each
field at 24,000,000 rows there (124,185,088 rows); placed over two or
four cards they do (a quarter of the table and of its gradient a card at
mesh 4), and the CLI trains them uncut.  A cut is listed under
``reduced``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.core.qat_store import FQuantConfig
from repro_torch.data.criteo import CriteoConfig, CriteoSynth
from repro_torch.dist.packed import place_rows, whole
from repro_torch.models import embedding as E
from repro_torch.models.recsys import make_dlrm
from repro_torch.train.steps import TrainState, make_compressed_train_step


def tree_to(tree, device: torch.device):
    """Every tensor of a (NamedTuple / tuple / list / dict) tree on
    ``device``; other leaves as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_to(x, device) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_to(x, device) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree


def place_train_state(state: TrainState, mesh, axis: str = "model"
                      ) -> TrainState:
    """The reference's placement under a mesh
    (``repro/train/setup.py::place_train_state``): the table, the row-wise
    adagrad accumulator, the priority and the access EMA row-sharded
    (``dist.packed.place_rows``: shard ``i`` on ``mesh.devices[i]``, row
    views on a one-device mesh, copies of their own across devices),
    everything else (the dense params, Adam's state, ``step``, ``rng``
    and the rest of the accumulator) replicated on the mesh's first
    device.  A leaf placed already is gathered whole and placed anew (an
    elastic move to another mesh).  The table's rows must divide the
    axis (ValueError otherwise)."""
    if mesh is None:
        return state
    dev = mesh.device

    def rows(x):
        return None if x is None else place_rows(whole(x), mesh, axis)

    params = tree_to({k: v for k, v in state.params.items()
                      if k != "embed_table"}, dev)
    params["embed_table"] = rows(state.params["embed_table"])
    dense_opt, accum_sq = state.opt
    accum = state.accum
    if accum is not None:
        accum = tree_to(accum._replace(access=None), dev)._replace(
            access=rows(accum.access))
    return TrainState(params=params,
                      opt=(tree_to(dense_opt, dev), rows(accum_sq)),
                      step=state.step.to(dev), priority=rows(state.priority),
                      rng=tree_to(state.rng, dev), accum=accum)


class RecsysTrainSetup(NamedTuple):
    model: object
    spec: E.FieldSpec
    ds: CriteoSynth
    step: Callable          # (state, batch, mark=None) -> (state, metrics)
    state: TrainState       # initial state, on the device
    batch_fn: Callable      # step index -> batch dict on the device
    indices_fn: Callable    # batch -> (B, F) global row ids
    reduced: list           # scale cuts against the published config


def build_recsys_training(arch, *, batch: int, device: torch.device,
                          model: str = "smoke", lr: float = 0.05,
                          seed: int = 0, max_ind_range: int | None = None,
                          fq_cfg: FQuantConfig | None = None,
                          state: TrainState | None = None, mesh=None,
                          axis: str = "model") -> RecsysTrainSetup:
    """Dataset + compressed train step + initial state on ``device``.

    The weights are random from ``seed`` (a generator on the device),
    unless ``state`` is given: then training starts from it (moved to
    ``device``), e.g. the reference's initial state carried across by
    ``convert.train_state_from_jax``.  The data stream is
    ``CriteoSynth`` seeded as the reference seeds it.  ``mesh`` (a
    ``dist.Mesh`` whose first device is ``device``) row-shards the step:
    the state is made whole on ``device``, so its bits are mesh 1's, then
    placed (``place_train_state``: each row-aligned leaf's shards copied
    to their devices and the whole freed).  The stacked table's rows must
    divide the mesh's axis (raises SystemExit otherwise, as the
    reference).
    """
    if model not in ("full", "smoke"):
        raise ValueError(f"model must be 'full' or 'smoke', got {model!r}")
    full = model == "full"
    cfg = arch.cfg if full else arch.smoke_cfg
    num_dense = arch.num_dense if full else arch.smoke_num_dense
    reduced = []
    if max_ind_range is not None:
        capped = tuple(min(int(c), max_ind_range) for c in cfg.cardinalities)
        cut = [f for f, (a, b) in enumerate(zip(cfg.cardinalities, capped))
               if a != b]
        if cut:
            before = make_dlrm(cfg).spec.total_rows
            cfg = dataclasses.replace(cfg, cardinalities=capped)
            after = make_dlrm(cfg).spec.total_rows
            reduced.append(
                f"cardinalities capped at max_ind_range={max_ind_range:,} "
                f"(fields {cut}); rows {before:,} -> {after:,}")
    net = make_dlrm(cfg)
    spec = net.spec
    if mesh is not None and spec.total_rows % mesh.shape[axis]:
        raise SystemExit(f"table rows {spec.total_rows} not divisible "
                         f"by mesh axis {axis}={mesh.shape[axis]}")
    ds = CriteoSynth(CriteoConfig(
        num_fields=spec.num_fields,
        cardinalities=tuple(int(c) for c in spec.cardinalities),
        num_dense=max(num_dense, 1),
        important_fields=max(1, spec.num_fields // 2),
        seed=seed))

    def indices_fn(b: dict) -> torch.Tensor:
        return E.globalize(b["indices"], spec)

    step = make_compressed_train_step(
        net.loss_from_emb, indices_fn, lambda b: b["labels"],
        "embed_table", lr, spec.num_fields,
        fq_cfg=fq_cfg if fq_cfg is not None else FQuantConfig(),
        mesh=mesh, axis=axis)
    if state is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        state = step.init_state(net.init(gen, device))
    else:
        state = tree_to(state, device)
    state = place_train_state(state, mesh, axis)   # the whole is freed

    def batch_fn(s: int) -> dict:
        return {k: torch.from_numpy(v).to(device)
                for k, v in ds.batch(batch, s).items()}

    return RecsysTrainSetup(model=net, spec=spec, ds=ds, step=step,
                            state=state, batch_fn=batch_fn,
                            indices_fn=indices_fn, reduced=reduced)
