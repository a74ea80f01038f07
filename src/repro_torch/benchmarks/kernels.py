"""Kernel microbench: measured tilings and the fusion ladder, on the card.

    python -m repro_torch.benchmarks.kernels [--shapes 64:8:64:32,...]
        [--iters 2] [--seed-cache] [--emit PATH] [--device cpu]

Port of ``benchmarks/kernels.py``.  Times the serving kernels at swept
(B, K, D, H) shapes and builds ONE ``bench_kernel/v1`` record with, per
shape and kernel:

  * the analytic tiling and its time,
  * the measured best tiling of the autotune sweep and its time: the
    sweep always includes the analytic pick, so measured <= analytic by
    construction (``tools/check_bench_schema.py`` holds it),
  * a bytes-touched model (the reference's ``_bytes_*``) and the GB/s
    and fraction of the card's HBM rate it implies.

The ladder, as the reference's:

  dequant_bag_rowgrid   the (B, K)-grid oracle (``dequant_bag_rowgrid.cu``,
                        every slot read; its Hopper design has no tiling)
  dequant_bag           the tiled gather (``dequant_bag.cu``)
  bag_grad              the scatter-add backward (``bag_grad.cu``)
  unfused_bag_matmul    K = 1 dequant_bag a field, then ``torch.matmul``
  bag_matmul            the fused kernel (``bag_matmul.cu``)

Times are device time only (``kernels.autotune.time_us``: CUDA events
around back-to-back launches queued behind a device-side delay, the
minimum over ``--iters`` windows of window / launches), the inputs
L2-warm: with ``VOCAB = 512`` rows every row sits in the H100's 50 MB L2,
so the GB/s are L2-fed, not HBM-fed.  ``bag_grad`` times the kernel
alone (the slots grouped once beforehand, the output zeroed once: each
launch overwrites the same touched rows).  On the CPU (``--device cpu``)
the plain versions run, which have no tiling: each sweep has the
analytic pick as its only candidate, times are wall time and the record
says ``interpret: true``.

``--seed-cache`` writes each swept shape's measured best tiling into the
autotune cache (``REPRO_AUTOTUNE_CACHE``, default
``results/autotune.json``), the file the ops read at serve time.
``--emit PATH`` writes the record to PATH; nothing is written without it
(the repository root's ``BENCH_kernel.json`` is the JAX package's).
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch.kernels import autotune

# the H100 SXM's HBM3 rate, NVIDIA's data sheet: the record's
# peak_fraction is achieved bytes/s over it
HBM_BW = 3.35e12

# (b, k, d, h) swept by default: a serving-ish bag shape and a smaller
# awkward-D shape
DEFAULT_SHAPES = ((64, 8, 64, 32), (32, 4, 96, 16))
VOCAB = 512
TIMER = ("cuda events around back-to-back launches behind a device-side "
         "delay, min over windows of window / launches (device time only)")


def _case(b: int, k: int, d: int, h: int, device: torch.device,
          seed: int = 0):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    payload = torch.randint(-128, 127, (VOCAB, d), generator=gen,
                            device=device, dtype=torch.int8)
    scales = torch.rand(VOCAB, generator=gen, device=device) * 0.01
    idx = torch.randint(0, VOCAB, (b, k), generator=gen, device=device,
                        dtype=torch.int32)
    weights = torch.rand((b, k), generator=gen, device=device) + 0.1
    w3 = torch.randn((k, d, h), generator=gen, device=device) * 0.1
    g = torch.randn((b, d), generator=gen, device=device)
    return payload, scales, idx, weights, w3, g


def _bytes_dequant(b, k, d, itemsize):
    """HBM bytes one dequant-bag call touches: payload rows + gathered
    scale/weight/index words in, (B, D) fp32 out."""
    return b * k * (d * itemsize + 12) + b * d * 4


def _bytes_bag_grad(b, k, d):
    """Backward scatter: (B, D) fp32 grads + coeff/idx words in, one
    read-modify-write of every addressed table row."""
    return b * d * 4 + b * k * 8 + 2 * b * k * d * 4


def _bytes_bag_matmul(b, k, d, h, itemsize):
    """Fused kernel: payload rows + gathered words + the (K, D, H) weight
    block in, (B, H) fp32 out: no (B, K*D) intermediate."""
    return b * k * (d * itemsize + 12) + k * d * h * 4 + b * h * 4


def _bytes_unfused(b, k, d, h, itemsize):
    """The round trip the fusion deletes: dequant writes (B, K, D) fp32,
    the matmul reads it back."""
    return (_bytes_dequant(b, k, d, itemsize) - b * d * 4
            + 2 * b * k * d * 4 + k * d * h * 4 + b * h * 4)


def bench_shape(b: int, k: int, d: int, h: int, *, iters: int,
                seed_cache: bool, device: torch.device) -> list[dict]:
    from repro_torch.kernels.bag_matmul import kernel as bm_kernel
    from repro_torch.kernels.bag_matmul import ops as bm_ops
    from repro_torch.kernels.dequant_bag import kernel, ops

    payload, scales, idx, weights, w3, g = _case(b, k, d, h, device)
    itemsize = payload.element_size()
    on_card = device.type == "cuda"
    rows: list[dict] = []

    def entry(name, dtype, blocks_a, us_a, blocks_m, us_m, nbytes, hh=0):
        us = min(us_a, us_m)
        rows.append({
            "kernel": name, "dtype": dtype, "b": b, "k": k, "d": d,
            "h": hh,
            "block_analytic": list(blocks_a), "analytic_us": us_a,
            "block_measured": list(blocks_m), "measured_us": us_m,
            "speedup": us_a / us_m if us_m > 0 else 1.0,
            "bytes_moved": int(nbytes),
            "achieved_gbs": nbytes / us * 1e6 / 1e9 if us > 0 else 0.0,
            "peak_fraction": (nbytes / (us * 1e-6)) / HBM_BW
            if us > 0 else 0.0,
        })

    def tune(name, dtype, run, analytic, nbytes, hh=0, extra="", **shape):
        """Time every candidate, the analytic pick first (so best <=
        analytic); with ``seed_cache`` store the winner."""
        cands = autotune.candidate_tilings(name, analytic, device, **shape)
        res = autotune.sweep(run, cands, iters=iters, device=device)
        us_a = res["sweep"][0]["us"]
        if us_a is None:  # analytic pick failed to launch: best wins
            us_a = res["best_us"]
        entry(name, dtype, analytic, us_a, res["best"], res["best_us"],
              nbytes, hh)
        if seed_cache:
            autotune.store(name, dtype, b, k, d, *res["best"],
                           res["best_us"], extra=extra, device=device)

    def timed(fn):
        return autotune.time_us(fn, iters=iters, device=device)

    # -- the rowgrid oracle: every slot read, no tiling to sweep ---------
    us = timed(lambda: ops.dequant_bag_rowgrid(payload, scales, idx,
                                               weights))
    entry("dequant_bag_rowgrid", "int8", [1, d], us, [1, d], us,
          _bytes_dequant(b, k, d, itemsize))

    # -- the tiled gather ------------------------------------------------
    tune("dequant_bag", "int8",
         lambda bb, bd: lambda: ops.dequant_bag(payload, scales, idx,
                                                weights, tiling=(bb, bd)),
         kernel.dequant_bag_analytic(b, k, d, device),
         _bytes_dequant(b, k, d, itemsize), b=b, k=k, d=d)

    # -- the scatter backward: the kernel alone on the card --------------
    if on_card:
        coeff = ops.bag_grad_coeff(scales, idx, weights).contiguous()
        plan = kernel.plan_slots(idx)
        out = torch.zeros((VOCAB, d), dtype=torch.float32, device=device)

        def grad_run(bb, bd):
            return lambda: kernel.bag_grad_cuda(g, idx, coeff, out,
                                                plan=plan, tiling=(bb, bd))
    else:
        def grad_run(bb, bd):
            return lambda: ops.bag_grad(g, scales, idx, weights, VOCAB)
    tune("bag_grad", "float32", grad_run,
         kernel.bag_grad_analytic(d, device=device),
         _bytes_bag_grad(b, k, d), d=d)

    # -- fusion before / after -------------------------------------------
    w2 = w3.reshape(k * d, h)

    def unfused():
        # the serving path without bag_matmul: per-field K = 1 bags
        # (B*K, D) through the gather kernel, reshape, torch.matmul
        rows = ops.dequant_bag(payload, scales, idx.reshape(b * k, 1),
                               weights.reshape(b * k, 1))
        return torch.matmul(rows.reshape(b, k * d), w2)

    us_u = timed(unfused)
    entry("unfused_bag_matmul", "int8", [1, d], us_u, [1, d], us_u,
          _bytes_unfused(b, k, d, h, itemsize), hh=h)

    tune("bag_matmul", "int8",
         lambda bb, bh: lambda: bm_ops.bag_matmul(payload, scales, idx,
                                                  weights, w3,
                                                  tiling=(bb, bh)),
         bm_kernel.bag_matmul_analytic(b, h, device),
         _bytes_bag_matmul(b, k, d, h, itemsize), hh=h, extra=f"|h={h}",
         b=b, h=h)
    return rows


def run(shapes=DEFAULT_SHAPES, iters: int = 2, seed_cache: bool = False,
        device: str | torch.device | None = None) -> dict:
    """The ``bench_kernel/v1`` record over ``shapes`` on ``device``."""
    from repro_torch import resolve_device
    dev = resolve_device(device)
    sweep = []
    for b, k, d, h in shapes:
        sweep.extend(bench_shape(b, k, d, h, iters=iters,
                                 seed_cache=seed_cache, device=dev))
    return {
        "schema": "bench_kernel/v1",
        "benchmark": "kernels",
        "backend": autotune.backend_name(dev),
        "interpret": dev.type != "cuda",
        "cache_path": autotune.cache_path() if seed_cache else None,
        "hbm_peak_gbs": HBM_BW / 1e9,
        "timer": TIMER if dev.type == "cuda" else "wall time (plain versions)",
        "device": dev.type,
        "sweep": sweep,
    }


def parse_shapes(text: str | None) -> tuple:
    if not text:
        return DEFAULT_SHAPES
    shapes = tuple(tuple(int(x) for x in s.split(":"))
                   for s in text.split(","))
    if any(len(s) != 4 for s in shapes):
        raise SystemExit("--shapes entries must be b:k:d:h")
    return shapes


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", default=None,
                    help="comma-separated b:k:d:h quads, e.g. "
                         "64:8:64:32,32:4:96:16")
    ap.add_argument("--iters", type=int, default=2,
                    help="timed windows per candidate (min taken)")
    ap.add_argument("--seed-cache", action="store_true",
                    help="persist each shape's measured-best tiling into "
                         "the autotune cache (REPRO_AUTOTUNE_CACHE, default "
                         "results/autotune.json)")
    ap.add_argument("--emit", default=None, metavar="PATH",
                    help="write the bench_kernel/v1 record to PATH")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises when absent)")
    args = ap.parse_args(argv)

    rec = run(parse_shapes(args.shapes), iters=args.iters,
              seed_cache=args.seed_cache, device=args.device)
    for e in rec["sweep"]:
        print(f"{e['kernel']:>20} b={e['b']:<4} k={e['k']:<3} "
              f"d={e['d']:<4} h={e['h']:<4} "
              f"analytic {e['analytic_us']:9.2f}us "
              f"{tuple(e['block_analytic'])} -> measured "
              f"{e['measured_us']:9.2f}us {tuple(e['block_measured'])} "
              f"({e['speedup']:.2f}x)")
    if args.seed_cache:
        print(f"autotune cache seeded: {rec['cache_path']}")
    if args.emit:
        with open(args.emit, "w") as f:
            json.dump(rec, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.emit}")
    return rec


if __name__ == "__main__":
    main()
