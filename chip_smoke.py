"""Drive the PyTorch port on one NVIDIA GPU: build, check, serve, train,
measure.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --trace trace.txt   # also profile 8 requests

Phases, each of which stops the run with a non-zero exit when it fails:

1. build: one ``nvcc`` per CUDA source of ``repro_torch`` (dequant_bag,
   bag_grad), all started together, for sm_90a into ``build/repro_torch/``;
2. kernel check: each kernel against its plain PyTorch version on the
   card, bit for bit (tolerance 0): dequant_bag for int8, bf16, fp16 and
   fp32 payloads; bag_grad at K = 1 and 8, with and without scales, 40%
   masked slots, heavy duplicates, B that no block divides, D = 64, 33
   and 200, B = 0;
3. serve: ``repro_torch.launch.serve`` at ``--model full`` — dlrm-rm2 at
   its published widths (26 fields, 204,185,088 rows x 64 packed at a 50%
   budget, MLPs 13-512-256-64 and 415-512-512-256-1), batch 512.  Launch
   counts are set to 0 just before and read just after; one request's
   embeddings must equal the plain ``lookup`` bit for bit, and its logits
   the same head run on the CPU within 1e-4 * max(1, |ref|) (GPU and CPU
   GEMMs reduce 512-long dot products in different orders);
4. measure serving: dequant_bag at the serving shapes (B*F = 13,312
   slots, K = 1, the served store's tiers), checked bit for bit against
   its plain version on those inputs, then timed beside it, its bound and
   a library call;
5. train: the compressed train step (``train.setup.build_recsys_training
   (model="full", max_ind_range=24_000_000)``: published widths, every
   field capped at 24M rows, 124,185,088 rows x 64) at batch 65,536 for
   9 steps.  Counts are set to 0 just before and read just after: each
   kernel must launch once a step; every loss must be finite; one step's
   embeddings must equal ``table[gidx]`` bit for bit.  Prints the step
   time, the per-stage device split (CUDA events) and the peak memory;
6. measure training: bag_grad on the real duplicate pattern of one
   training batch (1,703,936 slots, rows renumbered by rank so that the
   plain version's dense output fits beside the kernel's) bit for bit,
   then timed at the training shapes (the full 124,185,088-row output)
   beside the zero fill, its bound, the plain version and ``index_add_``;
7. resume: ``python -m repro_torch.launch.train --model smoke`` is killed
   after its first checkpoint and rerun; the rerun must resume from it.

Prints the card's name and power limit, the serve and train records, one
JSON ``kernels`` line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero without that line when there is no CUDA device, or when
the rest of the repository is missing.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# the train phase holds a 31.8 GB table and its 31.8 GB gradient; let the
# allocator grow segments instead of fragmenting the card
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12              # H100 SXM fp32 outside the tensor cores
TPU_KERNEL = ("src/repro/kernels/dequant_bag/kernel.py:172 "
              "dequant_bag_pallas")
SOURCE = "src/repro_torch/csrc/dequant_bag.cu"
TPU_BAG_GRAD = ("src/repro/kernels/dequant_bag/kernel.py:410 "
                "bag_grad_pallas")
SOURCE_BAG_GRAD = "src/repro_torch/csrc/bag_grad.cu"
REQUESTS = 16
TRAIN_STEPS = 9
MAX_IND_RANGE = 24_000_000


T0 = time.monotonic()


def log(msg: str) -> None:
    print(f"[{time.monotonic() - T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


def bits_equal(a, b) -> bool:
    import torch
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def check_kernels(torch, ops, ref) -> float:
    """Phase 2: dequant_bag against dequant_bag_ref on the card."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    worst = 0.0
    for dtype in (torch.int8, torch.bfloat16, torch.float16,
                  torch.float32):
        for d in (64, 33):
            v = 5000
            if dtype == torch.int8:
                payload = torch.randint(-128, 128, (v, d), generator=g,
                                        device=dev, dtype=torch.int8)
            else:
                payload = (torch.randn((v, d), generator=g, device=dev)
                           * 0.1).to(dtype)
            scales = torch.rand(v, generator=g, device=dev) * 0.01
            for b, k in ((1000, 1), (1000, 8), (7, 8), (13_312, 1)):
                idx = torch.randint(0, v, (b, k), generator=g, device=dev,
                                    dtype=torch.int32)
                w = torch.rand((b, k), generator=g, device=dev)
                w[torch.rand((b, k), generator=g, device=dev) < 0.4] = 0.0
                for s in ((scales, None) if dtype == torch.float32
                          else (scales,)):
                    got = ops.dequant_bag(payload, s, idx, w)
                    want = ref.dequant_bag_ref(payload, s, idx, w)
                    torch.cuda.synchronize()
                    err = float((got - want).abs().max())
                    worst = max(worst, err)
                    if not bits_equal(got, want):
                        raise SystemExit(
                            f"dequant_bag != plain: {dtype} D={d} B={b} "
                            f"K={k} scales={s is not None} max err {err}")
    log(f"kernel check: dequant_bag bit-equal to plain over 4 dtypes x "
        f"D in (64, 33) x (B, K) in 4 shapes (max abs err {worst})")
    return worst


def check_bag_grad(torch, ops, ref) -> float:
    """Phase 2: bag_grad against bag_grad_ref on the card."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    worst, n = 0.0, 0
    # (B, K, V): sparse rows at K = 1, K = 8 over many / few rows (heavy
    # duplicates), a B that no 8-warp block divides, and B = 0
    shapes = ((4096, 1, 1_000_000), (1001, 8, 5000), (1001, 8, 50),
              (37, 3, 7), (0, 4, 10))
    for d in (64, 33, 200):
        for b, k, v in shapes:
            grad = torch.randn((b, d), generator=g, device=dev)
            idx = torch.randint(0, v, (b, k), generator=g, device=dev,
                                dtype=torch.int32)
            scales = torch.rand(v, generator=g, device=dev) * 3
            w = torch.rand((b, k), generator=g, device=dev)
            masked = w.clone()
            masked[torch.rand((b, k), generator=g, device=dev) < 0.4] = 0.0
            for s in (None, scales):
                for wt in (None, w, masked):
                    got = ops.bag_grad(grad, s, idx, wt, v)
                    want = ref.bag_grad_ref(grad, s, idx, wt, v)
                    torch.cuda.synchronize()
                    if not bits_equal(got, want):
                        err = float((got - want).abs().max())
                        raise SystemExit(
                            f"bag_grad != plain: B={b} K={k} D={d} V={v} "
                            f"scales={s is not None} weights="
                            f"{'none' if wt is None else 'set'} err {err}")
                    if got.numel():
                        worst = max(worst, float((got - want).abs().max()))
                    n += 1
    log(f"kernel check: bag_grad bit-equal to plain in {n} cases (K 1-8, "
        f"scales on/off, 40% masked, duplicates, D 64/33/200, B=0; max abs "
        f"err {worst})")
    return worst


def time_launches(torch, fn, args_list, flush) -> float:
    """Mean ms of ``fn(*args)`` over ``args_list``, each launch timed by
    its own CUDA events with the 50 MB L2 flushed before it (a request's
    rows are cold: the next request draws other rows)."""
    fn(*args_list[0])
    pairs = []
    for args in args_list:
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(*args)
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / len(pairs)


def measure(torch, served, kernel, ref, launches, worst) -> list[dict]:
    """Phase 4: each tier's launch at the serving shapes."""
    import torch.nn.functional as F

    from repro_torch.core.packed_store import _split
    from repro_torch.models.embedding import globalize

    packed = served.packed
    dev = packed.payload32.device
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    tiers = (("int8", packed.payload8, packed.scale8),
             ("bfloat16", packed.payload16, packed.scale16),
             ("float32", packed.payload32, None))
    inputs = {name: [] for name, _, _ in tiers}
    live_slots = {name: 0 for name, _, _ in tiers}
    touched = {name: 0 for name, _, _ in tiers}
    n = 64
    for r in range(n):
        idx = served.make_request(1000 + r)["indices"].to(dev)
        tier, loc = _split(packed, globalize(idx, served.model.spec)
                           .reshape(-1, 1))
        for t, (name, payload, scales) in enumerate(tiers):
            w = (tier == t).to(torch.float32).contiguous()
            li = loc.clamp(0, payload.shape[0] - 1).to(torch.int32)
            inputs[name].append((payload, scales, li.contiguous(), w))
            live_slots[name] += int((w != 0).sum())
            touched[name] += int(torch.unique(li[w != 0]).numel())
    out = []
    for name, payload, scales in tiers:
        args = inputs[name]
        b, k = args[0][2].shape
        d = payload.shape[1]
        # Bytes the function must move: every weight, the index of each
        # live slot (w != 0), each distinct live row with its scale once,
        # and the output; flops: 3 per element of a live slot (2 unscaled).
        slots = live_slots[name] / n
        rows = touched[name] / n
        row_bytes = d * payload.element_size() + (4 if scales is not None
                                                  else 0)
        nbytes = b * k * 4 + slots * 4 + rows * row_bytes + b * d * 4
        flops = slots * d * (3 if scales is not None else 2)
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
        for a in args[:4]:            # the main path's own inputs
            got, want = kernel.dequant_bag_cuda(*a), ref.dequant_bag_ref(*a)
            if not bits_equal(got, want):
                raise SystemExit(f"dequant_bag[{name}] != plain on the "
                                 "served store")
            worst = max(worst, float((got - want).abs().max()))
        ms = time_launches(torch, kernel.dequant_bag_cuda, args, flush)
        plain_ms = time_launches(torch, ref.dequant_bag_ref, args, flush)
        library_ms = None
        if scales is None:
            def library(p, s, i, w):
                return F.embedding_bag(i, p, mode="sum",
                                       per_sample_weights=w)
            got = library(*args[0])
            if not torch.equal(got, kernel.dequant_bag_cuda(*args[0])):
                raise SystemExit("embedding_bag disagrees with the fp32 "
                                 "tier launch")
            library_ms = time_launches(torch, library, args, flush)
        out.append({
            "name": f"dequant_bag[{name}]", "route": "cuda",
            "source": SOURCE, "replaces": TPU_KERNEL,
            "launches": launches[name], "max_abs_err": worst,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
            >= flops / FP32_FLOPS else "operations",
            "library_ms": library_ms,
            "slots": b * k, "live_slots": slots, "distinct_live_rows": rows,
            "bytes": nbytes})
    return out


def serve_full(torch, serve, kernel, ps) -> tuple:
    """Phase 3: the main path at full width, with the counts around it."""
    from repro_torch.configs.common import RECSYS_SHAPES
    batch_size = RECSYS_SHAPES["serve_p99"]["batch"]
    argv = ["--model", "full", "--batch", str(batch_size), "--requests",
            str(REQUESTS)]
    kernel.reset_launches()
    served = serve.run(serve.parse_args(argv))
    launches = dict(kernel.launches)
    rec = served.record
    # the served store's tiers: int8, bf16 (strict_fp16 off) and fp32
    tiers = [launches[t] for t in ("int8", "bfloat16", "float32")]
    if min(tiers) <= 0 or rec["kernel_launches"] != sum(tiers):
        raise SystemExit(f"main path did not launch every kernel: "
                         f"{launches}, record {rec['kernel_launches']}")
    if rec["device"] != "cuda" or rec["packed_fp32_ratio"] > 0.55:
        raise SystemExit(f"unexpected serve record {rec}")

    from repro_torch.models.embedding import globalize
    dev = served.packed.payload32.device
    batch = {k: v.to(dev) for k, v in served.make_request(0).items()}
    with torch.inference_mode():
        gidx = globalize(batch["indices"], served.model.spec)
        emb = ps.lookup_fused(served.packed, gidx)
        plain = ps.lookup(served.packed, gidx)
        logits = served.model.head(served.params, emb, batch)
        cpu_params = {"net": {m: {layer: {p: x.cpu() for p, x in q.items()}
                                  for layer, q in net.items()}
                              for m, net in served.params["net"].items()}}
        ref_logits = served.model.head(
            cpu_params, plain.cpu(), {k: v.cpu() for k, v in batch.items()})
    torch.cuda.synchronize()
    if not bits_equal(emb, plain):
        raise SystemExit("served embeddings differ from the plain lookup")
    if logits.shape != (batch_size,) or not bool(
            torch.isfinite(logits).all()):
        raise SystemExit(f"bad logits {tuple(logits.shape)}")
    diff = (logits.cpu() - ref_logits).abs()
    if not bool((diff <= 1e-4 * ref_logits.abs().clamp_min(1.0)).all()):
        raise SystemExit(f"served logits off the CPU head by "
                         f"{float(diff.max())}")
    log(f"serve check: embeddings bit-equal to plain lookup, logits within "
        f"{float(diff.max()):.3g} of the CPU head")
    return served, launches


def train_full(torch, kernel, autodiff, setup_mod, arch) -> tuple:
    """Phase 5: the compressed train step at full width, with the counts
    around it.  Returns (record, one batch's (B, F) global rows, V)."""
    import numpy as np

    from repro_torch.configs.common import RECSYS_SHAPES
    dev = torch.device("cuda")
    batch = RECSYS_SHAPES["train_batch"]["batch"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = setup_mod.build_recsys_training(
        arch, batch=batch, device=dev, model="full",
        max_ind_range=MAX_IND_RANGE)
    batches = [tr.batch_fn(s) for s in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    state = tr.state
    vocab, dim = state.params["embed_table"].shape
    log(f"train setup: {vocab:,} rows x {dim}, batch {batch}, "
        f"{build_s:.1f}s; reduced: {tr.reduced}")

    losses, step_ms, stages = [], [], []
    kernel.reset_launches()
    for b in batches:
        marks = []

        def mark(stage, marks=marks):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((stage, e))

        torch.cuda.synchronize()
        t = time.perf_counter()
        mark("start")
        state, m = tr.step(state, b, mark=mark)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(m["loss"]))
        stages.append({name: a.elapsed_time(e) for (_, a), (name, e)
                       in zip(marks, marks[1:])})
    launches = {"dequant_bag": kernel.total_launches(),
                "bag_grad": kernel.bag_grad_launches["float32"]}
    peak = torch.cuda.max_memory_allocated()
    if launches != {"dequant_bag": TRAIN_STEPS, "bag_grad": TRAIN_STEPS}:
        raise SystemExit(f"train path did not launch each kernel once a "
                         f"step: {launches} over {TRAIN_STEPS} steps")
    if not all(np.isfinite(losses)):
        raise SystemExit(f"non-finite training loss: {losses}")

    gidx = tr.indices_fn(batches[0])
    table = state.params["embed_table"]
    with torch.no_grad():
        emb = autodiff.lookup_train(table, gidx)
    if not bits_equal(emb, table[gidx.to(torch.int64)]):
        raise SystemExit("training gather != table[gidx]")
    names = list(stages[-1])
    rec = {"train": {
        "arch": arch.name, "model": "full", "batch": batch,
        "steps": TRAIN_STEPS, "rows": vocab, "dim": dim,
        "reduced": tr.reduced, "losses": losses,
        "step_ms": step_ms, "step_ms_p50": float(np.median(step_ms[1:])),
        "stage_ms_p50": {n: float(np.median([st[n] for st in stages[1:]]))
                         for n in names},
        "kernel_launches": launches,
        "max_memory_allocated_bytes": peak,
        "device_name": torch.cuda.get_device_name(0), "setup_s": build_s}}
    log(f"train check: {TRAIN_STEPS} steps, losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, one launch of each kernel a step, gather "
        f"bit-equal to table[gidx]; peak {peak / 1e9:.2f} GB")
    return rec, gidx, vocab


def measure_bag_grad(torch, kernel, ref, gidx, vocab: int, flush,
                     worst: float) -> dict:
    """Phase 6: bag_grad on one training batch's slots."""
    dev = gidx.device
    n, d = gidx.numel(), 64
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    grad = torch.randn((n, d), generator=g, device=dev)
    idx = gidx.reshape(-1, 1).contiguous()
    coeff = torch.ones(idx.shape, dtype=torch.float32, device=dev)
    # the batch's duplicate pattern on a compact vocab: rows renumbered
    # by rank, so the plain version's dense output fits beside ours
    uniq, inv = torch.unique(idx.reshape(-1), return_inverse=True)
    u = uniq.numel()
    depth = int(torch.bincount(inv).max())
    cidx = inv.to(torch.int32).reshape(-1, 1).contiguous()
    got = kernel.bag_grad_cuda(grad, cidx, coeff, torch.zeros((u, d),
                                                               device=dev))
    want = ref.bag_grad_ref(grad, None, cidx, coeff, u)
    torch.cuda.synchronize()
    if not bits_equal(got, want):
        raise SystemExit("bag_grad != plain on a training batch's slots")
    worst = max(worst, float((got - want).abs().max()))
    del got, want, cidx, inv
    log(f"kernel check: bag_grad bit-equal to plain on one training "
        f"batch ({n:,} slots, {u:,} distinct rows, longest row {depth:,} "
        f"slots)")

    out = torch.zeros((vocab, d), device=dev)
    reps = [(grad, idx, coeff, out)] * 10
    ms = time_launches(torch, kernel.bag_grad_cuda, reps, flush)
    flat = idx.reshape(-1)
    sort_ms = time_launches(
        torch, lambda x: torch.sort(x, stable=True), [(flat,)] * 10, flush)
    zero_ms = time_launches(torch, lambda o: o.zero_(), [(out,)] * 5, flush)
    flat64 = flat.to(torch.int64)
    library_ms = time_launches(
        torch, lambda o: o.index_add_(0, flat64, coeff * grad),
        [(out,)] * 10, flush)
    out.zero_()
    kernel.bag_grad_cuda(grad, idx, coeff, out)
    t0 = time.perf_counter()
    plain = ref.bag_grad_ref(grad, None, idx, coeff, vocab)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not bits_equal(out[uniq], plain[uniq]):
        raise SystemExit("bag_grad != plain at the full training vocab")
    del plain
    # bytes the function must move: g, the indices and coefficients
    # once, and each distinct touched row written once; 2 flops a
    # column per slot
    nbytes = n * d * 4 + n * 4 + n * 4 + u * d * 4
    flops = 2 * n * d
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
    log(f"bag_grad at the training shapes: {ms:.4f} ms (sort {sort_ms:.4f}),"
        f" zero fill {zero_ms:.4f} ms, plain {plain_ms:.1f} ms, index_add_ "
        f"{library_ms:.4f} ms, bound {bound_ms:.5f} ms")
    return {
        "name": "bag_grad", "route": "cuda", "source": SOURCE_BAG_GRAD,
        "replaces": TPU_BAG_GRAD, "launches": None, "max_abs_err": worst,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
        >= flops / FP32_FLOPS else "operations",
        "library_ms": library_ms, "sort_ms": sort_ms,
        "zero_fill_ms": zero_ms, "zero_fill_bytes": vocab * d * 4,
        "slots": n, "distinct_rows": u, "longest_row": depth,
        "vocab": vocab, "bytes": nbytes}


def resume_smoke() -> dict:
    """Phase 7: kill the smoke trainer after its first checkpoint, rerun
    it, and check that it resumed there."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with tempfile.TemporaryDirectory() as ckpt:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--model",
               "smoke", "--steps", "200", "--batch", "256", "--ckpt-every",
               "5", "--ckpt-dir", ckpt]
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env,
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        try:
            deadline = time.monotonic() + 300
            while not any(os.path.exists(os.path.join(ckpt, e,
                                                      "manifest.json"))
                          for e in os.listdir(ckpt)):
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise SystemExit("smoke trainer wrote no checkpoint "
                                     f"(exit {proc.returncode})")
                time.sleep(0.05)
        finally:
            proc.kill()
            proc.wait()
        out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=600)
        if out.returncode != 0:
            raise SystemExit(f"resumed smoke trainer failed:\n{out.stderr}")
        rec = json.loads(out.stdout.strip().splitlines()[-1])
    resumed = rec["resumed_from"]
    if (resumed is None or not 5 <= resumed < 200
            or rec["steps_run"] != 200 - resumed
            or rec["kernel_launches"] != {"dequant_bag": rec["steps_run"],
                                          "bag_grad": rec["steps_run"]}
            or rec["device"] != "cuda"):
        raise SystemExit(f"smoke trainer did not resume: {rec}")
    log(f"resume check: killed after a checkpoint, resumed at step "
        f"{resumed}, ran {rec['steps_run']} steps, loss "
        f"{rec['loss_last']:.4f}")
    return rec


def trace(torch, serve, served, requests: int, path: str) -> None:
    """--trace: kernel time by name over served requests (the table goes
    to ``path``) and the device busy share (printed)."""
    from torch.profiler import ProfilerActivity, profile
    dev = served.packed.payload32.device
    batches = [{k: v.to(dev) for k, v in served.make_request(r).items()}
               for r in range(requests)]
    with torch.inference_mode():
        serve.serve_request(served.model, served.params, served.packed,
                            batches[0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for b in batches:
                serve.serve_request(served.model, served.params,
                                    served.packed, b)
                torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    ev = prof.key_averages()
    kernels = [e for e in ev
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    table = ev.table(sort_by="self_device_time_total", row_limit=30)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(table)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print(json.dumps({"trace": {
        "requests": requests, "wall_us": wall_us,
        "device_busy_us": busy_us, "device_busy_share": busy_us / wall_us,
        "top": [{"name": e.key[:80], "device_us": e.self_device_time_total,
                 "count": e.count} for e in top]}}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", metavar="PATH",
                    help="also profile 8 served requests; the kernel "
                         "table goes to PATH")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 1
    from repro_torch import configs
    from repro_torch.core import packed_store as ps
    from repro_torch.kernels import build
    from repro_torch.kernels.dequant_bag import autodiff, kernel, ops, ref
    from repro_torch.launch import serve
    from repro_torch.train import setup as setup_mod

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)

    t0 = time.perf_counter()
    paths = build.build_all(["dequant_bag", "bag_grad"])
    log(f"built {[p.name for p in paths]} ({time.perf_counter() - t0:.1f}s)")
    for path in paths:
        report = path.with_suffix(".log")
        if report.exists():
            log(report.read_text().strip())

    worst = check_kernels(torch, ops, ref)
    worst_grad = check_bag_grad(torch, ops, ref)
    served, launches = serve_full(torch, serve, kernel, ps)
    print(json.dumps(served.record), flush=True)
    kernels = measure(torch, served, kernel, ref, launches, worst)
    if args.trace:
        trace(torch, serve, served, 8, args.trace)
    del served
    torch.cuda.empty_cache()

    train_rec, gidx, vocab = train_full(torch, kernel, autodiff, setup_mod,
                                        configs.get("dlrm-rm2"))
    print(json.dumps(train_rec), flush=True)
    torch.cuda.empty_cache()
    train_launches = train_rec["train"]["kernel_launches"]
    for k in kernels:
        by_path = {"serve": k["launches"],
                   "train": (train_launches["dequant_bag"]
                             if k["name"] == "dequant_bag[float32]" else 0)}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    grad_entry = measure_bag_grad(torch, kernel, ref, gidx, vocab, flush,
                                  worst_grad)
    grad_entry["launches"] = train_launches["bag_grad"]
    grad_entry["launches_by_path"] = {"serve": 0,
                                      "train": train_launches["bag_grad"]}
    kernels.append(grad_entry)
    del flush, gidx
    torch.cuda.empty_cache()

    resume_smoke()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
