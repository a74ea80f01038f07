"""Where the paper tables' time goes on one CUDA card: a training step of
each driver of ``repro_torch.benchmarks.common`` and the two Table 2
scoring passes, on the bench DLRM (10 fields, 184,320 x 16, batch 512).

    python3 scripts/paper_steps.py [--steps 200] [--out PATH]

Each driver (``train_fp32``, ``train_fquant`` at Table 3's planned
thresholds with stochastic rounding, ``train_mpe``, ``train_alpt``)
runs ``--steps`` steps after 20 of warm-up; a step's ms is the wall time
of the steps beyond the warm-up (the device synchronized before each
clock read) over their count.  Then ``torch.profiler`` records 20 steps
of each: the device time summed over the kernels it ran, the share of
the window's wall time it fills (the rest is the card waiting on the
host), kernel launches a step, and the five costliest kernels.  The
Table 2 passes (``taylor.fperm_scores`` and
``permutation.permutation_scores`` over 4 eval batches, 2 shuffles) are
timed the same way, 5 times each.  Prints the card's name and power
limit and one JSON line a piece; ``--out`` also writes the lines there.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def wall_ms(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def profile(torch, fn, n: int) -> dict:
    """Device time, busy share and launches of ``fn`` (``n`` steps)."""
    from torch.profiler import ProfilerActivity, profile as prof
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU,
                          ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    events = [e for e in p.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    dev = sum(e.device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.device_time_total)[:5]
    return {"device_ms_a_step": dev / n / 1e3,
            "wall_ms_a_step": wall / n / 1e3,
            "device_busy_share": dev / wall,
            "kernels_a_step": sum(e.count for e in events) / n,
            "top": [(e.key[:60], e.device_time_total / n / 1e3, e.count // n)
                    for e in top]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("paper_steps: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.benchmarks import common
    from repro_torch.core import permutation, taylor
    from repro_torch.core.qat_store import FQuantConfig
    from repro_torch.core.tiers import plan_thresholds_for_ratio

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    setup = common.make_setup(num_fields=10, important=5)
    spec = setup.model.spec
    _, warm = common.train_fquant(setup, FQuantConfig(), steps=100)
    fq = FQuantConfig(tiers=plan_thresholds_for_ratio(warm, spec.dim, 0.5))
    drivers = {
        "train_fp32": lambda n: common.train_fp32(setup, steps=n),
        "train_fquant": lambda n: common.train_fquant(setup, fq, steps=n),
        "train_mpe": lambda n: common.train_mpe(setup, steps=n),
        "train_alpt": lambda n: common.train_alpt(setup, steps=n),
    }
    lines = []
    for name, run in drivers.items():
        run(20)                                       # warm-up
        base = wall_ms(torch, lambda: run(20))
        full = wall_ms(torch, lambda: run(20 + args.steps))
        rec = {"piece": name, "steps": args.steps,
               "ms_a_step": (full - base) / args.steps,
               "profile_20_steps": profile(torch, lambda: run(20), 20)}
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    params = common.train_fp32(setup, steps=120)
    batches = [common.device_batch(setup.ds.batch(512, 4000 + i),
                                   setup.device) for i in range(4)]
    passes = {
        "fperm_scores": lambda: taylor.fperm_scores(
            setup.model.embed, setup.model.loss_from_emb, params, batches,
            order=1),
        "permutation_scores": lambda: permutation.permutation_scores(
            setup.model.embed, setup.model.loss_from_emb, params, batches,
            10, num_shuffles=2,
            generator=common.generator(setup.device, 0)),
    }
    for name, fn in passes.items():
        fn()
        times = [wall_ms(torch, fn) for _ in range(5)]
        rec = {"piece": name, "ms": times,
               "profile_1_pass": profile(torch, fn, 1)}
        lines.append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
