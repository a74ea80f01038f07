"""Dry run: trace every (arch x shape x mesh) cell at full width on
``meta`` and record its per-device costs.

Port of ``repro/launch/dryrun.py``, with its CLI.  For every cell this
script:

  1. configures ``dist.ctx`` over the logical production mesh
     (``launch.mesh.make_production_mesh``: 16 x 16, or 2 x 16 x 16 with
     ``--mesh multi``), so the models' ``ctx.constrain`` calls are held to
     their tensors' ranks;
  2. builds the ``Cell`` (``configs.common``: ``fn``, ``meta`` arguments,
     ``PartitionSpec`` trees);
  3. runs ``fn`` on its arguments under ``launch.op_analysis.OpCounter``
     (``meta`` tensors: shapes only, nothing allocated, no GPU needed);
  4. writes one JSON record to ``results/dryrun/`` (``--results``), which
     ``benchmarks/roofline.py`` reads.

How each number of a record is counted:

  * ``memory.argument_bytes`` / ``output_bytes``: exact, per device, from
    the cell's specs over the mesh (each sharded dimension divided by the
    product of its axes, rounded up).  An argument the step never reads
    is left out, as ``jax.jit`` drops unused arguments (a serving cell's
    labels; the dense net of a retrieval cell; the decode cells'
    ``cache_len``, which the port's decode takes as a host int).
  * ``flops``, ``hbm_bytes``, ``memory.temp_bytes``: counted over the
    GLOBAL step, then divided by ``num_devices`` (an even split).  The
    reference reads one device's partitioned program instead, so where the
    mesh replicates work (a dense head at a batch sharded 16 ways over 256
    devices) its per-device numbers are larger by the replication.
    ``temp_bytes`` is the peak of the live bytes of the results made
    during the trace (the outputs included); ``peak_bytes`` is
    ``argument_bytes + temp_bytes``.
  * ``collective_bytes``: only the collectives the port's own code
    performs (``dist.mesh.psum``, ``dist.collectives``' combine,
    ``optim.grad_compress``' all-gather), each reporting its result bytes
    by kind; none runs inside a cell's step, so every record has 0.  The
    collectives XLA inserts to partition a step have no counterpart in a
    single controller, which places data itself, and are not counted.
  * ``lower_s``: the seconds to build and trace the cell;
    ``unknown_trip_whiles`` is always 0 (a Python loop is counted once an
    iteration); ``kernel_calls``: the hand-written kernels' ops reached
    (each reports its bound's bytes and operations, ``op_analysis``).

Where the cells depart from the reference's: a recsys serve cell runs
the port's fused serving path (``lookup_fused``, the tiered
``dequant_bag`` kernel's op) and xDeepFM's cells run the ``cin`` kernel's
op, where the reference's ``lowerable`` calls its plain ``lookup`` and
jnp ``cin_layer`` and so reaches no Pallas kernel.  Those ops report
their roofline bound's bytes, so such a cell's ``hbm_bytes`` is not
comparable with the reference's record (its argument and output bytes
still are).

The reference's keys with no counterpart are left out: ``compile_s``
(nothing is compiled), ``xla_flops_raw`` and ``xla_bytes_raw`` (XLA's own
cost analysis).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun              # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dlrm-rm2 \\
      --shape serve_p99 --results /tmp/d
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi  # 512
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from pathlib import Path

import torch

RESULTS_DIR = str(Path(__file__).resolve().parents[3] / "results"
                  / "dryrun")


def tree_bytes(tree, specs, mesh_shape: dict, read=None) -> int:
    """One device's bytes of the tensor leaves of ``tree`` placed by the
    aligned ``specs`` (only the leaves whose ids are in ``read``, when
    given)."""
    from repro_torch.dist import sharding as sh
    total = 0

    def add(_, leaf, spec):
        nonlocal total
        if isinstance(leaf, torch.Tensor) and (read is None
                                               or id(leaf) in read):
            shape = sh.shard_shape(tuple(leaf.shape), spec, mesh_shape)
            total += math.prod(shape) * leaf.element_size()

    sh.tree_map_with_path(add, tree, specs)
    return total


def run_cell(arch, shape: str, mesh, mesh_name: str, results_dir: str,
             variant: str = "baseline") -> dict:
    from repro_torch.dist import ctx
    from repro_torch.launch.op_analysis import OpCounter
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    ctx.configure(mesh, batch=batch_axes if len(batch_axes) > 1
                  else batch_axes[0], tp="model")
    try:
        t0 = time.time()
        cell = arch.lowerable(shape, mesh.axis_names, variant=variant)
        with OpCounter() as counter:
            out = cell.fn(*cell.args)
        t_lower = time.time() - t0
        arg_bytes = tree_bytes(cell.args, cell.in_specs, mesh.shape,
                               read=counter.read)
    finally:
        ctx.unconfigure()
    out_specs = (cell.out_specs(out) if callable(cell.out_specs)
                 else cell.out_specs)
    stats = counter.stats
    n = mesh.size
    temp = stats.peak_live_bytes / n
    rec = {
        "arch": arch.name,
        "shape": shape,
        "mesh": mesh_name,
        "variant": variant,
        "kind": cell.kind,
        "ok": True,
        "lower_s": round(t_lower, 2),
        # per device: the global step's counts over num_devices
        "flops": stats.flops / n,
        "hbm_bytes": stats.hbm_bytes / n,
        "collective_bytes": {k: v / n for k, v in stats.collective.items()},
        "collective_total": stats.collective_total() / n,
        "unknown_trip_whiles": stats.unknown_trip_whiles,
        "kernel_calls": dict(stats.kernel_calls),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": tree_bytes(out, out_specs, mesh.shape),
            "temp_bytes": temp,
            "peak_bytes": arg_bytes + temp,
        },
        "num_devices": n,
    }
    os.makedirs(results_dir, exist_ok=True)
    suffix = "" if variant == "baseline" else f"__{variant}"
    fname = f"{arch.name}__{shape}__{mesh_name}{suffix}.json"
    with open(os.path.join(results_dir, fname), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--variant", default="baseline",
                    choices=["baseline", "optimized"])
    ap.add_argument("--results", default=RESULTS_DIR)
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> tuple[list[dict], list[str]]:
    """Every selected cell: (records, failed cell tags)."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_production_mesh

    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("single", make_production_mesh(multi_pod=False)))
    if args.mesh in ("multi", "both"):
        meshes.append(("multi", make_production_mesh(multi_pod=True)))

    names = [args.arch] if args.arch else configs.names()
    records, failures = [], []
    for mesh_name, mesh in meshes:
        for name in names:
            arch = configs.get(name)
            shapes = ([args.shape] if args.shape in arch.cells() else []) \
                if args.shape else arch.cells()
            for shape in shapes:
                tag = f"{name} x {shape} x {mesh_name}"
                try:
                    rec = run_cell(arch, shape, mesh, mesh_name,
                                   args.results, args.variant)
                    records.append(rec)
                    print(f"[ok]   {tag}: trace {rec['lower_s']}s  "
                          f"peak/dev {rec['memory']['peak_bytes'] / 2**30:.2f}"
                          f" GiB  flops {rec['flops']:.3e}  "
                          f"coll {rec['collective_total'] / 2**30:.2f} GiB",
                          flush=True)
                except Exception as e:  # noqa: BLE001
                    failures.append(tag)
                    print(f"[FAIL] {tag}: {type(e).__name__}: {e}",
                          flush=True)
                    traceback.print_exc(limit=3)
    print(f"\n{len(failures)} failures" + (": " + "; ".join(failures)
                                           if failures else ""))
    return records, failures


def main(argv=None) -> int:
    _, failures = run(parse_args(argv))
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
