"""Training CLI: ``python -m repro_torch.launch.train --arch dlrm-rm2``.

Port of ``repro/launch/train.py``.  A field-based recsys arch runs the compressed
train step (the dequant_bag gather, the bag_grad scatter backward,
row-wise adagrad, Adam, the Eq. 5-8 fold, in-training Taylor/access
accumulation) under ``train.loop.run`` with atomic versioned
checkpoints.  Rerun the same command after a kill and it resumes at the
newest checkpoint in ``--ckpt-dir``.

``--model full`` (the default) trains dlrm-rm2 at its published widths
(26 fields x 64, MLPs 13-512-256-64 and 415-512-512-256-1).  On one card
every field is capped at ``--max-ind-range`` rows (default 24,000,000:
124,185,088 rows, the most one 80 GB card holds beside the dense table
gradient; its final checkpoint is about 34 GB).  Over two or more cards
the default is no cap: all 204,185,088 rows, nothing in ``reduced``.
``--model smoke`` trains the reduced size, the reference CLI's model.
The run is on the GPU unless ``--device cpu`` is given.

``--mesh N`` (N > 1) places the train state over an N-shard mesh
(``repro_torch.dist``, ``train.setup.place_train_state``): the table,
its adagrad accumulator, the priority and the access EMA a row shard a
shard, and the step runs its gather, scatter, adagrad, snap and EMAs a
shard at a time.  ``--device`` names the cards: one device holds every
shard (the reference's CPU mesh), and a comma-separated list of N
(``--device cuda:0,cuda:1,cuda:2,cuda:3 --mesh 4``) puts shard i on the
i-th; a listed card that is absent raises.  The table's rows must divide
N.  The step is the unsharded one bit for bit, on one card or several,
and a checkpoint is a mesh-1 checkpoint: a rerun may resume it at
another ``--mesh``.

The run first prints the arch and the elastic mesh over the devices
present (``launch.mesh.make_elastic_mesh``), as the reference's CLI does.
The last stdout line is a JSON record: arch, model, device,
device_name, devices (one a shard's device, as listed), batch, mesh,
steps_run, resumed_from, loss_first, loss_last, step_ms_p50 (to the end
of every card's work), kernel_launches (per kernel), rows, reduced,
stragglers, nan_skips, device_peak_bytes (the largest card's) and
device_peak_bytes_each (one a distinct device).

``--smoke``, and every arch that is not a field-based recsys arch
(bert4rec, pna and the five LMs) whatever the flags, runs its family
smoke instead (``configs.common``: three generic train steps with the
F-Quantization hook at the reduced size; recsys: a pack / unpack of the
table and a forward; GNN: a forward; LM: one decode step), prints
``smoke-train metrics: ...`` and, last, the metrics as JSON; it exits
non-zero when they are not finite.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile

import numpy as np
import torch

from repro_torch import configs
from repro_torch.kernels.dequant_bag import kernel as bag_kernel
from repro_torch.launch.mesh import (check_device_arg, device_count,
                                     device_list, make_elastic_mesh,
                                     mesh_from_args)
from repro_torch.train import loop as loop_lib
from repro_torch.train.setup import build_recsys_training

FULL_MAX_IND_RANGE = 24_000_000


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="Train a recsys model with the compressed train step, "
                    "or run an arch's family smoke.",
        epilog="bert4rec, pna and the LM archs run their family smoke "
               "only, as in the reference.")
    ap.add_argument("--arch", default="dlrm-rm2", choices=configs.names())
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--model", default="full", choices=("full", "smoke"),
                    help="full = the published widths, smoke = the "
                         "reduced test size")
    ap.add_argument("--max-ind-range", type=int, default=None,
                    help="cap on every field's rows (default "
                         f"{FULL_MAX_IND_RANGE:,} for full, none for smoke)")
    ap.add_argument("--device", default=None,
                    help="torch device, or a comma-separated list of one a "
                         "--mesh shard; default cuda (raises when absent)")
    ap.add_argument("--mesh", type=int, default=1,
                    help="place the train state over an N-shard 'model' "
                         "mesh (repro_torch.dist; every shard on --device, "
                         "or shard i on its i-th entry)")
    ap.add_argument("--smoke", action="store_true",
                    help="run the reduced-config family smoke (always, for "
                         "an arch that is not a field-based recsys arch)")
    args = ap.parse_args(argv)
    if args.mesh < 1:
        ap.error("--mesh must be >= 1")
    check_device_arg(ap, args)
    return args


def smoke(args: argparse.Namespace, arch) -> dict:
    """The family smoke's metrics; SystemExit when they are not finite."""
    metrics = arch.smoke(device_list(args.device)[0])
    metrics["arch"] = args.arch
    print("smoke-train metrics:", metrics, flush=True)
    if not metrics["finite"]:
        raise SystemExit("non-finite smoke metrics")
    return metrics


def run(args: argparse.Namespace) -> dict:
    arch = configs.get(args.arch)
    elastic = make_elastic_mesh(model_parallel=1)
    print(f"arch {arch.name} ({arch.family}); mesh {elastic.shape}; "
          f"devices {device_count()}", flush=True)
    if args.smoke or arch.family != "recsys" or arch.seq_model:
        return smoke(args, arch)
    device, mesh = mesh_from_args(args.device, args.mesh)
    cards = [device] if mesh is None else mesh.distinct_devices()
    cap = args.max_ind_range
    if cap is None and args.model == "full" and len(cards) < 2:
        cap = FULL_MAX_IND_RANGE
    setup = build_recsys_training(arch, batch=args.batch, device=device,
                                  model=args.model, lr=args.lr,
                                  max_ind_range=cap, mesh=mesh)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"arch {args.arch} ({args.model}): {setup.spec.total_rows:,} rows "
          f"x {setup.spec.dim} on {name}, mesh {args.mesh}", flush=True)
    cfg = loop_lib.LoopConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, log_every=max(args.steps // 5, 1))
    bag_kernel.reset_launches()
    result = loop_lib.run(
        setup.state, setup.step, setup.batch_fn, cfg,
        metrics_cb=lambda s, m: print(f"step {s}: loss "
                                      f"{float(m['loss']):.4f}", flush=True))
    losses = result.losses
    peaks = [torch.cuda.max_memory_allocated(d) if d.type == "cuda" else 0
             for d in cards]
    if losses and not math.isfinite(losses[-1]):
        raise SystemExit("training ended on a non-finite loss")
    return {
        "arch": args.arch, "model": args.model, "device": device.type,
        "device_name": name, "batch": args.batch, "mesh": args.mesh,
        "steps_run": len(losses), "resumed_from": result.resumed_from,
        "loss_first": losses[0] if losses else None,
        "loss_last": losses[-1] if losses else None,
        "step_ms_p50": (float(np.median(result.step_seconds)) * 1e3
                        if losses else None),
        "kernel_launches": {
            "dequant_bag": bag_kernel.total_launches(),
            "bag_grad": sum(bag_kernel.bag_grad_launches.values())},
        "rows": setup.spec.total_rows, "reduced": setup.reduced,
        "devices": [str(d) for d in (mesh.devices if mesh else [device])],
        "stragglers": result.stragglers, "nan_skips": result.nan_skips,
        "device_peak_bytes": max(peaks), "device_peak_bytes_each": peaks}


def main(argv=None) -> None:
    print(json.dumps(run(parse_args(argv))))


if __name__ == "__main__":
    main()
