"""Drive the PyTorch port on one NVIDIA GPU: build, check, serve, measure.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --trace trace.txt   # also profile 8 requests

Phases, each of which stops the run with a non-zero exit when it fails:

1. build: ``nvcc`` compiles the CUDA source of ``repro_torch`` for
   sm_90a into ``build/repro_torch/``;
2. kernel check: each kernel against its plain PyTorch version on the
   card, bit for bit (tolerance 0);
3. serve: ``repro_torch.launch.serve`` at ``--model full`` — dlrm-rm2 at
   its published widths (26 fields, 204,185,088 rows x 64 packed at a 50%
   budget, MLPs 13-512-256-64 and 415-512-512-256-1), batch 512.  Launch
   counts are set to 0 just before and read just after; one request's
   embeddings must equal the plain ``lookup`` bit for bit, and its logits
   the same head run on the CPU within 1e-4 * max(1, |ref|) (GPU and CPU
   GEMMs reduce 512-long dot products in different orders);
4. measure: each kernel at the serving shapes (B*F = 13,312 slots, K = 1,
   the served store's tiers), checked bit for bit against its plain
   version on those inputs, then timed beside it, its bound and a
   library call.

Prints the card's name and power limit, the serve record, one JSON
``kernels`` line, and as the last line
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

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12              # H100 SXM fp32 outside the tensor cores
TPU_KERNEL = ("src/repro/kernels/dequant_bag/kernel.py:172 "
              "dequant_bag_pallas")
SOURCE = "src/repro_torch/csrc/dequant_bag.cu"
REQUESTS = 16


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


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
    for dtype in (torch.int8, torch.bfloat16, torch.float32):
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
    log(f"kernel check: dequant_bag bit-equal to plain over 3 dtypes x "
        f"D in (64, 33) x (B, K) in 4 shapes (max abs err {worst})")
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
    if min(launches.values()) <= 0 or rec["kernel_launches"] != sum(
            launches.values()):
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
    from repro_torch.core import packed_store as ps
    from repro_torch.kernels import build
    from repro_torch.kernels.dequant_bag import kernel, ops, ref
    from repro_torch.launch import serve

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)

    t0 = time.perf_counter()
    path = build.build("dequant_bag")
    log(f"built dequant_bag: {path.name} ({time.perf_counter() - t0:.1f}s)")
    report = path.with_suffix(".log")
    if report.exists():
        log(report.read_text().strip())

    worst = check_kernels(torch, ops, ref)
    served, launches = serve_full(torch, serve, kernel, ps)
    print(json.dumps(served.record), flush=True)
    kernels = measure(torch, served, kernel, ref, launches, worst)
    print(json.dumps({"kernels": kernels}), flush=True)
    if args.trace:
        trace(torch, serve, served, 8, args.trace)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
