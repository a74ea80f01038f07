"""One-command SHARK pipeline: train -> prune -> quantize -> pack -> serve.

    python -m repro_torch.launch.pipeline --model full \\
        --max-ind-range 24000000 --batch 65536 [--steps 40]
    python -m repro_torch.launch.pipeline --model smoke --device cpu --fast

Port of ``repro/launch/pipeline.py``, the paper's whole loop in one
command:

  1. **train**    the compressed train step (``dequant_bag`` gather,
     ``bag_grad`` scatter backward, the Eq. 5-8 fold, the in-training
     Taylor / access accumulator) under ``train.loop.run``, with atomic
     checkpoints; the newest must carry the accumulator
     (``verify_accum_checkpointed``).  A one-batch gradcheck compares
     the fused backward with dense autodiff
     (``verify_grad_fp32_tolerance``).
  2. **prune**    fields ranked by the accumulated first-order Taylor
     scores (Eq. 2-4) are masked until the kept-memory fraction is at
     most ``--prune-to`` (F-Permutation), then a short masked finetune
     (the same step with ``field_mask``); the pruned fields' rows and
     priorities are zeroed.
  3. **quantize** Eq. 8 thresholds planned for ``--target-ratio`` from
     the trained priority EMA; the table is snapped (Eq. 5-6, RTN).
  4. **pack**     ``packed_store.pack`` and a ``CheckpointManager`` round
     trip of its ``packed_store/v1`` manifest; the restored pack must
     equal the pack and a fresh pack bit for bit
     (``verify_pack_bit_identical``).  ``--store-backend hashed`` fits a
     ROBE-style pool to the table instead (in row chunks at full width:
     ``store.hashed.fit_chunk_rows``; the record adds ``fit_s``,
     ``fit_chunks`` and ``fit_relative_residual``) and round-trips its
     ``hashed_store/v1`` manifest.
  5. **serve**    BCE and AUC of the fp32 table against the served one on
     held-out batches, then ``OnlineServer`` driven micro-batched
     (``serve.loop.serve_forward``) under drifting zipf; after a final
     re-tier the live pack must equal a fresh pack of the live
     priorities (``verify_serve_bit_identical``).

The last stdout line is the reference's ``bench_pipeline/v1`` record
(``tools/check_bench_schema.py`` validates it) plus the port's keys:
model, device, device_name, rows, reduced, the train and finetune
losses, ``kernel_launches`` by stage, ``checkpoints`` (bytes and seconds
of each save) and ``max_memory_allocated_bytes``.  Any false
``verify_*`` flag exits non-zero (``verify_failures``).

What the port changes, and only in what is held at once (the numbers
are the reference's): at full width (124,185,088 rows x 64, 31.8 GB
fp32) the reference's host copies and full unpacks of the (V, D) table
do not fit beside it.  So the gradcheck runs on the sub-table of the
rows its batch touches (the gradient's other rows are zero in both
forms, and ``bag_grad`` keeps each row's (b, k) order, so the errors are
the same); the pruned rows are zeroed and the table snapped in place on
the device (the fp32 eval runs first: its masked forward reads no
pruned row); the packed eval reads the restored pack through the
serving gather (bit-equal to its unpacked rows); packs are built in row
chunks; and the serve check compares the two unpacked stores in row
chunks.  The accumulator check restores only the accumulator's leaves
of the newest checkpoint.

``--metrics-out PATH`` turns the ``obs`` registry on and writes
``metrics_snapshot/v1`` JSONL there (one line every ``--metrics-every``
ticks, default 16: a tick is a train step or a served micro-batch, and
one final line before the record): the ``pipeline.<stage>_us`` stage
timeblocks (one observation a stage; the eval's two passes are one),
the train loop's and the server's metrics, and the serving span catalog
pre-registered.  ``main`` closes the sink on every exit path.

``--mesh N`` (N > 1) row-shards the run over an N-shard mesh, every shard
on ``--device`` or shard ``i`` on the ``i``-th card of a ``--device``
list (``launch.mesh.mesh_from_args``), as the reference's ``--mesh``
over N devices.  Every stage works from the placed state that
``train.setup.place_train_state`` leaves (``dist.packed.RowShards``
leaves, a shard a card; row views of one table on one device, the same
code path): the train and finetune steps a shard at a time; the
gradcheck's sub-table and the resumed state's loss gathered from the
shards that own the rows; the prune zeroing each shard's window on its
card; the fp32 eval through ``sharded_lookup_train``'s forward (one
``dequant_bag`` a shard a batch); the Eq. 8 plan from the priorities
gathered on the first card, the snap a shard at a time; the packs
(``ps.pack``, the server's, its re-tiers' ``repack_delta``) and the
hashed fit reading the table in ``CHUNK_ROWS`` / ``FIT_CHUNK_ROWS``
blocks from the shards that own them; the served eval and the serve
stage over the packed backend's row shards (or the hashed pool's).  No
stage after the set-up makes the whole fp32 table on one device; the
packs (one whole pack at 204,185,088 rows and a ratio of ~0.28 is ~15 GB)
live on the mesh's first card, as the server's pack of record.  The
table's rows must divide N; the training setup is dlrm-rm2's.  Over two
or more distinct cards ``--model full`` runs all 204,185,088 rows; on
one card every field is capped at ``FULL_MAX_IND_RANGE``.  Checkpoints
are elastic: ``--resume`` over another device list restores onto its
mesh.  The record adds ``devices`` (a shard's each),
``setup_peak_bytes_each``, ``stage_peak_bytes_each`` and
``device_peak_bytes_each`` (each distinct card's peak during the set-up,
during the stages after it, and over the whole run) and
``final_pack_digest`` (``store_digest`` of the served store after the
final re-tier).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch import configs, kernels, obs, sync
from repro_torch.ckpt.manager import CheckpointManager, tree_paths
from repro_torch.core import metrics as metrics_lib
from repro_torch.core import packed_store as ps
from repro_torch.core.pruning import memory_fraction
from repro_torch.core.qat_store import (CHUNK_ROWS, FQuantConfig, QATStore,
                                        snap_)
from repro_torch.dist.packed import (RowShards, row_pieces, shard_packed,
                                     sharded_lookup, sharded_lookup_train,
                                     whole)
from repro_torch.core.tiers import (assign_tiers, plan_thresholds_for_ratio,
                                    tier_counts)
from repro_torch.kernels.dequant_bag.autodiff import lookup_train
from repro_torch.launch.mesh import (card_count, check_device_arg,
                                     mesh_from_args)
from repro_torch.obs.trace import timeblock
from repro_torch.serve.loop import SERVE_PHASES, serve_forward
from repro_torch.serve.online import OnlineConfig, OnlineServer
from repro_torch.store import hashed as H
from repro_torch.store.api import build as store_build
from repro_torch.store.api import from_manifest as store_from_manifest
from repro_torch.train import accum as accum_lib
from repro_torch.train import loop as loop_lib
from repro_torch.train.setup import build_recsys_training
from repro_torch.train.steps import TrainState, make_compressed_train_step

FULL_MAX_IND_RANGE = 24_000_000


@dataclasses.dataclass
class PipelineConfig:
    arch: str = "dlrm-rm2"
    steps: int = 120
    batch: int = 64
    lr: float = 0.05
    mesh: int = 1                # shards: on ``device``, or one a listed card
    ckpt_dir: str = os.path.join(tempfile.gettempdir(),
                                 "repro_torch_pipeline")
    ckpt_every: int = 40
    target_ratio: float = 0.5    # Eq. 8 byte budget (fraction of fp32)
    prune_to: float = 0.85       # keep-memory fraction after F-Perm
    finetune_steps: int = 16
    serve_requests: int = 96
    serve_batch: int = 8
    retier_every: int = 24
    cache_rows: int = 64
    drift: float = 2.0
    eval_batches: int = 8
    gradcheck_batch: int = 8
    seed: int = 0
    resume: bool = False         # keep ckpt_dir and resume training
    store_backend: str = "packed"    # "packed" | "hashed" serving store
    hash_ratio: float = 100.0    # fp32/pool target (store_backend=hashed)
    model: str = "smoke"         # "smoke" | "full" (published widths)
    max_ind_range: int | None = None  # cap on every field's rows
    device: str | None = None    # None = cuda (raises when absent); a
                                 # comma-separated list: a card a shard


def fast_config(**overrides) -> PipelineConfig:
    """CI-sized pipeline (the ``--fast`` preset)."""
    base = dict(steps=24, batch=32, ckpt_every=10, finetune_steps=6,
                serve_requests=24, retier_every=12, eval_batches=4)
    base.update(overrides)
    return PipelineConfig(**base)


def _bits_equal(tree_a, tree_b) -> bool:
    """Leaf for leaf: tensors of one dtype and shape with the same bytes;
    other leaves equal.  Two placed leaves of one placement compare shard
    by shard, on their own devices."""
    la = [leaf for _, leaf in tree_paths(tree_a)]
    lb = [leaf for _, leaf in tree_paths(tree_b)]
    if len(la) != len(lb):
        return False
    for a, b in zip(la, lb):
        if (isinstance(a, RowShards) and isinstance(b, RowShards)
                and a.windows == b.windows):
            a, b = a.shards, b.shards
        else:
            a, b = [whole(a)], [whole(b)]
        if not all(_leaf_bits_equal(x, y) for x, y in zip(a, b)):
            return False
    return True


def _leaf_bits_equal(a, b) -> bool:
    if not (isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor)):
        return a == b
    if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
            and a.dtype == b.dtype and a.shape == b.shape):
        return False
    return torch.equal(a.detach().reshape(-1).view(torch.uint8),
                       b.detach().reshape(-1).to(a.device).view(torch.uint8))


DIGEST_BLOCK = 1 << 25


def store_digest(tree) -> int:
    """A 64-bit digest of a store's bytes (a ``PackedStore``, a hashed
    store's pool): each leaf's bytes, each times a weight of its position
    and its leaf, summed mod 2^64 on the leaf's device in blocks of
    ``DIGEST_BLOCK`` bytes.  Equal stores give equal digests on any
    device."""
    total = 0
    for li, (_, leaf) in enumerate(tree_paths(tree)):
        if not isinstance(leaf, torch.Tensor):
            continue
        b = leaf.detach().contiguous().reshape(-1).view(torch.uint8)
        acc = torch.zeros((), dtype=torch.int64, device=b.device)
        for i0 in range(0, b.numel(), DIGEST_BLOCK):
            i1 = min(b.numel(), i0 + DIGEST_BLOCK)
            w = torch.arange(i0, i1, dtype=torch.int64, device=b.device)
            acc += (b[i0:i1].to(torch.int64) * (w * 1000003 + 7919 * li
                                                 + 12345)).sum()
        total = (total + int(acc)) % 2 ** 64
    return total


def table_rows(table, g: torch.Tensor) -> torch.Tensor:
    """fp32 rows ``g`` (any shape) of the trained table: a tensor's plain
    gather, or a placed table's through ``sharded_lookup_train``'s forward
    (one ``dequant_bag`` a shard over the ids it owns, on its card, the
    partials summed on the mesh's first device: each row exactly once)."""
    if isinstance(table, RowShards):
        return sharded_lookup_train(table, g)
    return table[g.to(torch.int64)]


def _peaks(cards) -> list[int]:
    """Each card's ``max_memory_allocated`` since its last reset; 0 for
    the CPU."""
    return [torch.cuda.max_memory_allocated(d) if d.type == "cuda" else 0
            for d in cards]


def _reset_peaks(cards) -> None:
    for d in cards:
        if d.type == "cuda":
            torch.zeros(1, device=d)    # the card's allocator, first
            torch.cuda.reset_peak_memory_stats(d)


def unpacked_equal(a: ps.PackedStore, b: ps.PackedStore) -> bool:
    """``unpack(a)`` and ``unpack(b)`` bit for bit, compared in row chunks
    (the reference unpacks both whole)."""
    if a.vocab != b.vocab or a.dim != b.dim:
        return False
    for r0 in range(0, a.vocab, CHUNK_ROWS):
        r1 = min(a.vocab, r0 + CHUNK_ROWS)
        if not _bits_equal(ps.unpack(a, r0, r1), ps.unpack(b, r0, r1)):
            return False
    return True


def gradcheck(model, params: dict, table: torch.Tensor, gidx: torch.Tensor,
              batch: dict, compact: bool = True) -> tuple[float, float]:
    """(max |fused - dense|, max |dense|) of d mean-loss / d table for one
    batch: the fused backward (``lookup_train``: ``bag_grad``) against the
    autodiff of the plain gather ``table[gidx]``.

    ``compact`` runs both on the sub-table of the rows ``gidx`` touches,
    with the indices renumbered (ascending, so each row keeps its slots'
    (b, k) order); the full (V, D) gradients have zeros elsewhere in both
    forms, so the error and the scale are the same.
    """
    dense = {k: v for k, v in params.items() if k != "embed_table"}
    if compact:
        rows, inv = torch.unique(gidx.reshape(-1), return_inverse=True)
        table = table[rows]
        gidx = inv.reshape(gidx.shape).to(torch.int32)

    def grad_of(emb_of) -> torch.Tensor:
        leaf = table.detach().clone().requires_grad_()
        with torch.enable_grad():
            p = dict(dense)
            p["embed_table"] = leaf
            loss = model.loss_from_emb(p, emb_of(leaf), batch).mean()
            (g,) = torch.autograd.grad(loss, leaf)
        return g

    g_fused = grad_of(lambda t: lookup_train(t, gidx))
    g_dense = grad_of(lambda t: t[gidx.to(torch.int64)])
    return (float((g_fused - g_dense).abs().max()),
            float(g_dense.abs().max()))


def _launches_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in kernels.launch_counts().items()}


def run_pipeline(cfg: PipelineConfig, state: TrainState | None = None,
                 audit=None, fit_audit=None) -> dict:
    """Run the pipeline as ``cfg`` says; the ``bench_pipeline/v1`` record.

    ``state`` starts training from a given ``TrainState`` (e.g. the
    reference's, through ``convert.train_state_from_jax``) instead of the
    random one of ``cfg.seed``.

    ``audit(stage, store, gidx, emb)``, when given, sees what the served
    store gave, outside the timed stages and their launch counts:
    stage ``"eval"`` the first held-out batch of the served-table eval,
    ``"serve"`` each micro-batch that did not re-tier.  ``store`` is the
    ``PackedStore`` that served (the restored pack in the eval, the
    server's in the serve; under ``--mesh`` the serve stage's is its
    ``dist.packed.ShardedPack``) or the hashed backend; ``gidx`` the
    global ids
    (B, F), ``emb`` the served embeddings (B, F, D).  It lets a caller
    hold the serving gather to a plain one on the pipeline's own inputs.
    ``fit_audit(hcfg, r0, r1, g, bags, signs, before, after)``, when
    given, sees each row chunk's scatter in the hashed fit's first
    ``adj`` (``store.hashed.fit_pool_from_table``'s ``audit``), inside the
    pack stage's seconds and the record's ``fit_s``.
    """
    device, mesh = mesh_from_args(cfg.device, cfg.mesh)
    cards = [device] if mesh is None else mesh.distinct_devices()
    _reset_peaks(cards)
    arch = configs.get(cfg.arch)
    full = cfg.model == "full"
    num_dense = arch.num_dense if full else arch.smoke_num_dense
    fq_train = FQuantConfig()            # paper-default thresholds
    setup = build_recsys_training(
        arch, batch=cfg.batch, device=device, model=cfg.model, lr=cfg.lr,
        seed=cfg.seed, max_ind_range=cfg.max_ind_range, fq_cfg=fq_train,
        state=state, mesh=mesh)
    model, spec, batch_fn = setup.model, setup.spec, setup.batch_fn
    indices_fn, state, reduced = setup.indices_fn, setup.state, setup.reduced
    train_step = setup.step
    del setup
    # the set-up made the whole state on the first card and placed it:
    # its peaks apart, then a fresh window for the stages
    setup_peaks = _peaks(cards)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    _reset_peaks(cards)

    rec: dict = {"schema": "bench_pipeline/v1", "benchmark": "pipeline",
                 "arch": cfg.arch, "mesh": cfg.mesh,
                 "train_steps": cfg.steps, "batch": cfg.batch}
    stage_s: dict = {}
    launches: dict = {}

    # ------------------------------------------------------------ train
    train_dir = os.path.join(cfg.ckpt_dir, "train")
    if not cfg.resume and os.path.isdir(train_dir):
        shutil.rmtree(train_dir)
    loop_cfg = loop_lib.LoopConfig(
        total_steps=cfg.steps, ckpt_every=cfg.ckpt_every,
        ckpt_dir=train_dir, log_every=max(cfg.steps // 4, 1))
    l0 = kernels.launch_counts()
    with timeblock("pipeline.train") as tb:
        result = loop_lib.run(state, train_step, batch_fn, loop_cfg)
    launches["train"] = _launches_since(l0)
    state, train_losses = result.state, result.losses
    ckpt_writes = result.ckpt_writes
    stage_s["train"] = round(tb.seconds, 3)
    del result, train_step

    if train_losses:
        loss_first, loss_last = train_losses[0], train_losses[-1]
    else:
        # resumed with training already complete: no steps ran, so
        # report the restored state's loss on one batch
        with torch.inference_mode():
            b = batch_fn(cfg.steps)
            emb = table_rows(state.params["embed_table"], indices_fn(b))
            loss_first = loss_last = float(model.loss_from_emb(
                state.params, emb, b).mean())
    rec["train_loss_first"] = round(float(loss_first), 5)
    rec["train_loss_last"] = round(float(loss_last), 5)
    rec["train_losses"] = [float(x) for x in train_losses]

    # the accumulator checkpoints with the loop: the newest checkpoint
    # must carry it (restartable Taylor / access statistics)
    restored, _ = CheckpointManager(train_dir).restore(
        TrainState(params=None, opt=None, step=state.step,
                   accum=state.accum))
    accum_ckpt_ok = _bits_equal(state.accum, restored.accum)
    del restored

    # the gradcheck: fused backward vs dense autodiff
    with timeblock("pipeline.gradcheck") as tb:
        gb = batch_fn(1_000_003)
        gb = {k: (v[:cfg.gradcheck_batch] if v.ndim else v)
              for k, v in gb.items()}
        l0 = kernels.launch_counts()
        grad_err, grad_scale = gradcheck(
            model, state.params, state.params["embed_table"],
            indices_fn(gb), gb)
        launches["gradcheck"] = _launches_since(l0)
    stage_s["gradcheck"] = round(tb.seconds, 3)
    rec["gradcheck_max_abs_err"] = grad_err
    grad_ok = grad_err <= 1e-5 + 1e-4 * grad_scale

    # ------------------------------------------------------------ prune
    tb = timeblock("pipeline.prune").start()
    scores = accum_lib.field_scores(state.accum).cpu().numpy()
    table_bytes = spec.table_bytes()
    mask = np.ones(spec.num_fields, bool)
    for f in np.argsort(scores)[:spec.num_fields // 2]:
        if memory_fraction(mask, table_bytes) <= cfg.prune_to:
            break
        mask[int(f)] = False
    pruned = np.nonzero(~mask)[0]

    finetune_losses = []
    l0 = kernels.launch_counts()
    if pruned.size and cfg.finetune_steps:
        ft_step = make_compressed_train_step(
            model.loss_from_emb, indices_fn, lambda b: b["labels"],
            "embed_table", cfg.lr, spec.num_fields, fq_cfg=fq_train,
            mesh=mesh, with_accum=True, field_mask=mask.astype(np.float32))
        for i in range(cfg.finetune_steps):
            state, m = ft_step(state, batch_fn(500_000 + i))
            finetune_losses.append(float(m["loss"]))
    launches["finetune"] = _launches_since(l0)
    rec["finetune_losses"] = finetune_losses

    # physically drop pruned fields: zero their rows and priorities, in
    # place (zero priority -> coldest tier; zero rows quantize to zeros,
    # so masked serving and zero-row serving agree exactly); a placed
    # leaf a shard at a time, each its window's part on its own card
    table, shard_priority = state.params["embed_table"], state.priority
    offsets = spec.offsets()
    for f in pruned:
        lo = int(offsets[f])
        hi = lo + int(spec.cardinalities[f])
        for leaf in (table, shard_priority):
            for first, part in row_pieces(leaf):
                a = max(lo, first) - first
                b = min(hi, first + part.shape[0]) - first
                if a < b:
                    part[a:b] = 0.0
    for d in cards:
        sync(d)
    stage_s["prune"] = round(tb.stop(), 3)
    rec["fields_total"] = int(spec.num_fields)
    rec["fields_pruned"] = int(pruned.size)
    rec["kept_memory_fraction"] = round(
        memory_fraction(mask, table_bytes), 4)
    serve_params = {k: v for k, v in state.params.items()
                    if k != "embed_table"}
    state = None        # ``table`` and ``shard_priority`` live on

    # quality on held-out batches: the fp32 table now, the served one
    # after the pack (the masked forward reads no pruned row, so zeroing
    # them first changes nothing)
    fmask = torch.as_tensor(mask, dtype=torch.float32, device=device)

    def eval_quality(emb_of, keep: dict | None = None
                     ) -> tuple[float, float]:
        losses, aucs = [], []
        with torch.inference_mode():
            for i in range(cfg.eval_batches):
                b = batch_fn(2_000_000 + i)
                g = indices_fn(b)
                emb = emb_of(g)
                if keep is not None and i == 0:
                    keep["first"] = (g, emb)
                e = emb * fmask[None, :, None]
                logits = model.head(serve_params, e, b)
                losses.append(float(metrics_lib.bce_with_logits(
                    logits, b["labels"]).mean()))
                aucs.append(float(metrics_lib.auc(logits, b["labels"])))
        return float(np.mean(losses)), float(np.mean(aucs))

    # the eval stage is two passes, one either side of the pack; its
    # timeblocks record nothing, the stage is observed once below
    l0 = kernels.launch_counts()
    with timeblock() as tb_eval:
        loss_fp32, auc_fp32 = eval_quality(lambda g: table_rows(table, g))
    launches_fp32_eval = _launches_since(l0)

    # -------------------------------------------------------- quantize
    # the Eq. 8 plan reads every priority (gathered on the first card: on
    # one device the shards' base itself); assign and snap are row-wise,
    # a shard at a time on its card
    tb = timeblock("pipeline.quantize").start()
    priority = whole(shard_priority)
    tier_cfg = plan_thresholds_for_ratio(priority, spec.dim,
                                         cfg.target_ratio)
    final_cfg = FQuantConfig(tiers=tier_cfg, stochastic=False)
    counts = [0, 0, 0]
    for (_, part), (_, pri) in zip(row_pieces(table),
                                   row_pieces(shard_priority)):
        tiers = assign_tiers(pri, tier_cfg)
        snap_(part, tiers, final_cfg)
        counts = [a + b for a, b in zip(counts, tier_counts(tiers))]
        del tiers
    del shard_priority
    store = QATStore(table=table, priority=priority)
    for d in cards:
        sync(d)
    stage_s["quantize"] = round(tb.stop(), 3)
    rec["tier_rows_int8"] = int(counts[0])
    rec["tier_rows_half"] = int(counts[1])
    rec["tier_rows_fp32"] = int(counts[2])

    # ------------------------------------------------------------ pack
    tb = timeblock("pipeline.pack").start()
    l0 = kernels.launch_counts()
    bytes_fp32 = spec.total_rows * spec.dim * 4
    pack_dir = os.path.join(cfg.ckpt_dir, "packed")
    if os.path.isdir(pack_dir):
        shutil.rmtree(pack_dir)
    pmgr = CheckpointManager(pack_dir, keep=1)
    hashed_backend = restored_packed = hs = None
    if cfg.store_backend == "hashed":
        hcfg = H.HashedConfig(
            vocab=spec.total_rows, dim=spec.dim, chunk_dim=8,
            num_slots=H.plan_pool_slots(spec.total_rows, spec.dim, 8,
                                        cfg.hash_ratio))
        with timeblock() as tb_fit:
            hs = H.fit_pool_from_table(
                table, hcfg, priority=priority,
                audit=(None if fit_audit is None
                       else lambda *a: fit_audit(hcfg, *a)))
            sync(device)
        rec["fit_s"] = round(tb_fit.seconds, 3)
        rec["fit_chunks"] = -(-hcfg.vocab // H.fit_chunk_rows(hcfg))
        rec["fit_relative_residual"] = H.fit_residual(hs, hcfg, table)
        src_backend = store_build("hashed", hs, hcfg, mesh=mesh)
        bytes_packed = src_backend.nbytes()
        pmgr.save(cfg.steps, src_backend.snapshot_manifest())
        restored_tree, _ = pmgr.restore(src_backend.snapshot_manifest())
        hashed_backend = store_from_manifest(restored_tree, mesh=mesh)
        verify_pack = _bits_equal(hashed_backend.snapshot_manifest(),
                                  src_backend.snapshot_manifest())
        del src_backend, restored_tree
    else:
        packed = ps.pack(store, final_cfg)
        bytes_packed = packed.nbytes()
        manifest = {"kind": "packed_store/v1", "packed": packed,
                    "priority": store.priority}
        pmgr.save(cfg.steps, manifest)
        restored_tree, _ = pmgr.restore(manifest)
        restored_packed = store_from_manifest(
            restored_tree, store=store, cfg=final_cfg).host_packed
        del manifest, restored_tree
        # the handoff artifact must equal a fresh offline pack of the
        # same trained rows, bit for bit, through the round trip
        verify_pack = _bits_equal(restored_packed, packed)
        del packed
        verify_pack = verify_pack and _bits_equal(
            restored_packed, ps.pack(store, final_cfg))
    launches["pack"] = _launches_since(l0)
    sync(device)
    stage_s["pack"] = round(tb.stop(), 3)
    rec["bytes_fp32"] = int(bytes_fp32)
    rec["bytes_packed"] = int(bytes_packed)
    rec["compression_ratio"] = round(bytes_packed / bytes_fp32, 4)
    rec["verify_pack_bit_identical"] = bool(verify_pack)

    # served-table quality: the restored store through the serving
    # gather (K = 1: bit-equal to the unpacked rows)
    keep = None if audit is None else {}
    with timeblock() as tb:
        l0 = kernels.launch_counts()
        if hashed_backend is not None:
            loss_packed, auc_packed = eval_quality(hashed_backend.lookup,
                                                   keep)
        elif mesh is not None:
            shards = shard_packed(restored_packed, mesh)
            loss_packed, auc_packed = eval_quality(
                lambda g: sharded_lookup(shards, g, mesh=mesh), keep)
            del shards
        else:
            loss_packed, auc_packed = eval_quality(
                lambda g: ps.lookup_fused(restored_packed, g), keep)
        launches["eval"] = {k: v + launches_fp32_eval[k]
                            for k, v in _launches_since(l0).items()}
    obs.observe("pipeline.eval_us", (tb_eval.seconds + tb.seconds) * 1e6)
    stage_s["eval"] = round(tb_eval.seconds + tb.seconds, 3)
    if audit is not None:
        audit("eval", restored_packed if hashed_backend is None
              else hashed_backend, *keep.pop("first"))
    rec["eval_loss_fp32"] = round(loss_fp32, 5)
    rec["eval_loss_packed"] = round(loss_packed, 5)
    rec["eval_auc_fp32"] = round(auc_fp32, 5)
    rec["eval_auc_packed"] = round(auc_packed, 5)

    # ----------------------------------------------------------- serve
    tb = timeblock("pipeline.serve").start()
    l0 = kernels.launch_counts()
    online = OnlineConfig(cache_rows=cfg.cache_rows,
                          retier_every=cfg.retier_every)
    if hashed_backend is None:
        server = OnlineServer(store, final_cfg, online, mesh=mesh)
        # direct handoff: the server's own pack of the trained store
        # must BE the pipeline's packed artifact
        handoff_ok = _bits_equal(server.host_packed, restored_packed)
        restored_packed = None
    else:
        server = OnlineServer(online=online, backend=hashed_backend)
        handoff_ok = True       # the restored backend IS the server's
    serve_audit = None
    if audit is not None:
        def serve_audit(packed, gidx, emb):
            audit("serve", packed if hashed_backend is None
                  else hashed_backend, gidx, emb)
    loop_res = serve_forward(
        server, model, spec, serve_params, serve_batch=cfg.serve_batch,
        requests=cfg.serve_requests, drift=cfg.drift, num_dense=num_dense,
        seed=cfg.seed, audit=serve_audit)
    # lockstep bit-identity under live priorities: after a final re-tier
    # the served store equals a fresh pack of the live EMA (hashed: the
    # pool comes through serving untouched)
    server.retier()
    if hashed_backend is None:
        served = server.host_packed
        verify_serve = unpacked_equal(served, ps.pack(server.store,
                                                      final_cfg))
    else:
        served = server.backend.hs.pool
        verify_serve = _bits_equal(served, hs.pool)
    launches["serve"] = _launches_since(l0)
    for d in cards:
        sync(d)
    stage_s["serve"] = round(tb.stop(), 3)
    rec["final_pack_digest"] = store_digest(served)
    del served
    rec["serve_requests"] = int(cfg.serve_requests)
    rec["serve_batch"] = int(cfg.serve_batch)
    rec["steady_qps"] = round(loop_res.steady_qps, 1)
    rec["cache_hit_rate"] = float(loop_res.stats["cache_hit_rate"])
    rec["retiers"] = int(loop_res.stats["retiers"])
    rec["verify_serve_bit_identical"] = bool(verify_serve and handoff_ok)
    rec["verify_grad_fp32_tolerance"] = bool(grad_ok)
    rec["verify_accum_checkpointed"] = bool(accum_ckpt_ok)
    rec["store_backend"] = cfg.store_backend
    rec["stage_seconds"] = stage_s
    # each card's peak over the stages, and over the whole run
    stage_peaks = _peaks(cards)
    peaks = [max(a, b) for a, b in zip(setup_peaks, stage_peaks)]
    rec.update({
        "model": cfg.model, "device": device.type,
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "rows": spec.total_rows,
        "reduced": reduced,
        "serve_p50_us": loop_res.p50_us, "serve_p99_us": loop_res.p99_us,
        "kernel_launches": launches,
        "checkpoints": {"train": ckpt_writes, "pack": pmgr.writes},
        "devices": [str(d) for d in (mesh.devices if mesh else [device])],
        "setup_peak_bytes_each": setup_peaks,
        "stage_peak_bytes_each": stage_peaks,
        "device_peak_bytes_each": peaks,
        "max_memory_allocated_bytes": (
            peaks[0] if device.type == "cuda" else None)})
    return rec


def verify_failures(rec: dict) -> list[str]:
    """Names of the record's end-to-end verifications that did not hold;
    non-empty means the run must exit non-zero."""
    return [k for k in ("verify_pack_bit_identical",
                        "verify_serve_bit_identical",
                        "verify_grad_fp32_tolerance",
                        "verify_accum_checkpointed")
            if not rec.get(k)]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="The SHARK pipeline: train, prune, quantize, pack, "
                    "serve.",
        epilog="The row-sharded run: --mesh N, all N shards on --device "
               "or shard i on the i-th card of a --device list "
               "(cuda:0,cuda:1,...); over two or more cards --model full "
               "runs every row.")
    ap.add_argument("--arch", default="dlrm-rm2", choices=("dlrm-rm2",))
    ap.add_argument("--fast", action="store_true",
                    help="CI-sized budgets (see fast_config)")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--mesh", type=int, default=1,
                    help="row-shard every stage over an N-shard 'model' "
                         "mesh (repro_torch.dist; every shard on --device, "
                         "or shard i on its i-th entry)")
    ap.add_argument("--ckpt-dir", default=PipelineConfig.ckpt_dir)
    ap.add_argument("--resume", action="store_true",
                    help="keep --ckpt-dir and resume training from the "
                         "newest checkpoint")
    ap.add_argument("--target-ratio", type=float, default=0.5)
    ap.add_argument("--prune-to", type=float, default=0.85)
    ap.add_argument("--store-backend", default="packed",
                    choices=("packed", "hashed"),
                    help="serving store: 'packed' = the tier-partitioned "
                         "pack, 'hashed' = a ROBE-style pool fitted to the "
                         "trained table")
    ap.add_argument("--hash-ratio", type=float, default=100.0,
                    help="target fp32-table / pool ratio (--store-backend "
                         "hashed)")
    ap.add_argument("--serve-requests", type=int, default=None)
    ap.add_argument("--emit", default=None, metavar="PATH",
                    help="also write the bench_pipeline/v1 record here")
    ap.add_argument("--model", default="full", choices=("full", "smoke"),
                    help="full = the published widths, smoke = the "
                         "reduced test size")
    ap.add_argument("--max-ind-range", type=int, default=None,
                    help="cap on every field's rows (default "
                         f"{FULL_MAX_IND_RANGE:,} for full on one card, "
                         "none over two or more cards or for smoke)")
    ap.add_argument("--device", default=None,
                    help="torch device, or a comma-separated list of one a "
                         "--mesh shard; default cuda (raises when absent)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="enable the repro_torch.obs registry and write "
                         "metrics_snapshot/v1 JSONL here (a line every "
                         "--metrics-every train steps / served batches + "
                         "a final snapshot); docs/observability.md")
    ap.add_argument("--metrics-every", type=int, default=16,
                    help="snapshot cadence in ticks for --metrics-out (0 = "
                         "final snapshot only)")
    args = ap.parse_args(argv)
    if args.mesh < 1:
        ap.error("--mesh must be >= 1")
    check_device_arg(ap, args)
    return args


def config_from_args(args: argparse.Namespace) -> PipelineConfig:
    """The run's config; ``--model full`` caps every field at
    ``FULL_MAX_IND_RANGE`` rows unless the mesh spans two or more
    distinct cards (``launch.train``'s rule)."""
    cap = args.max_ind_range
    if (cap is None and args.model == "full"
            and card_count(args.device) < 2):
        cap = FULL_MAX_IND_RANGE
    overrides = dict(arch=args.arch, mesh=args.mesh, ckpt_dir=args.ckpt_dir,
                     resume=args.resume, target_ratio=args.target_ratio,
                     prune_to=args.prune_to,
                     store_backend=args.store_backend,
                     hash_ratio=args.hash_ratio, model=args.model,
                     max_ind_range=cap, device=args.device)
    for key, val in (("steps", args.steps), ("batch", args.batch),
                     ("serve_requests", args.serve_requests)):
        if val is not None:
            overrides[key] = val
    return (fast_config(**overrides) if args.fast
            else PipelineConfig(**overrides))


def main(argv=None, audit=None, fit_audit=None) -> dict:
    """The CLI; ``audit`` and ``fit_audit`` as in ``run_pipeline``.  The
    metrics sink is closed on every exit path (a failed verify's last
    window included)."""
    try:
        return _main(parse_args(argv), audit, fit_audit)
    finally:
        obs.close_sink()


def _main(args: argparse.Namespace, audit, fit_audit) -> dict:
    if args.metrics_out:
        obs.enable()
        obs.ensure_histograms(f"{p}_us" for p in SERVE_PHASES)
        obs.set_sink(obs.JsonlSink(args.metrics_out,
                                   every=args.metrics_every))
    rec = run_pipeline(config_from_args(args), audit=audit,
                       fit_audit=fit_audit)
    obs.flush()
    if args.emit:
        with open(args.emit, "w") as f:
            json.dump(rec, f, indent=1, sort_keys=True)
        print(f"wrote {args.emit}")
    failures = verify_failures(rec)
    if not failures:
        print(f"pipeline OK: {rec['compression_ratio']:.2%} of fp32 bytes, "
              f"{rec['fields_pruned']}/{rec['fields_total']} fields pruned, "
              f"AUC {rec['eval_auc_fp32']:.3f} -> "
              f"{rec['eval_auc_packed']:.3f}, steady "
              f"{rec['steady_qps']:.0f} qps ({rec['device_name']})")
    print(json.dumps(rec))
    if failures:
        raise SystemExit(f"pipeline verify FAILED: {failures}")
    losses = rec["train_losses"] + rec["finetune_losses"]
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"pipeline FAILED: non-finite loss in {losses}")
    return rec


if __name__ == "__main__":
    main()
