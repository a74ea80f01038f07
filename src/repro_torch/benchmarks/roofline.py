"""Roofline: the measured kernel table, and the three-term dry-run model.

Port of ``benchmarks/roofline.py``.  Two ingest paths:

``kernel_table(path)`` / ``kernel_markdown(path)`` read a MEASURED
``bench_kernel/v1`` record (``benchmarks/kernels.py``): per swept shape,
achieved bytes/s against the card's HBM rate for the kernel ladder
(rowgrid oracle, tiled gather, scatter backward, unfused and fused
bag -> matmul), with the tuning, pipelining and fusion ratios.  The path
is required (the repository root's ``BENCH_kernel.json`` is the JAX
package's record).

``load`` / ``terms`` / ``table`` / ``markdown`` / ``run`` read dry-run
artifacts (``results/dryrun/*.json`` under the checkout) and derive, per
(arch x shape x mesh):

    compute term    = FLOPs / peak FLOP/s                [s]
    memory term     = bytes / HBM rate                   [s]
    collective term = collective bytes / NVLink rate     [s]

with the H100 SXM's data-sheet constants: 989.4 TFLOP/s dense bf16,
3.35 TB/s HBM3, 900 GB/s NVLink.  No port module writes dry-run records
yet (ROADMAP Queue 1 item 9, step 6), so ``run()`` returns ``[]`` until
one does, as the reference's does with no artifacts.
"""

from __future__ import annotations

import glob
import json
import os
from pathlib import Path

PEAK_FLOPS = 989.4e12        # H100 SXM dense bf16, data sheet
HBM_BW = 3.35e12             # H100 SXM HBM3 bytes/s, data sheet
NVLINK_BW = 900e9            # H100 SXM NVLink bytes/s, data sheet

RESULTS = str(Path(__file__).resolve().parents[3] / "results" / "dryrun")

# analytic params (total, active) per LM arch
LM_PARAMS = {
    "smollm-135m": (135e6, 135e6),
    "qwen3-8b": (8.2e9, 8.2e9),
    "deepseek-coder-33b": (33.3e9, 33.3e9),
    "mixtral-8x22b": (141e9, 39e9),
    "deepseek-v2-lite-16b": (15.7e9, 2.8e9),
}

LM_TOKENS = {
    "train_4k": 256 * 4096,
    "prefill_32k": 32 * 32768,
    "decode_32k": 128,          # one token per sequence
    "long_500k": 1,
}


def model_flops(arch: str, shape: str, kind: str) -> float | None:
    """Global useful FLOPs for the step (None where not meaningful)."""
    if arch in LM_PARAMS:
        total, active = LM_PARAMS[arch]
        toks = LM_TOKENS[shape]
        if kind == "train":
            return 6.0 * active * toks
        return 2.0 * active * toks
    return None


def load(results: str | None = None) -> list[dict]:
    rows = []
    for f in sorted(glob.glob(os.path.join(results or RESULTS, "*.json"))):
        with open(f) as fh:
            rows.append(json.load(fh))
    return rows


def terms(rec: dict) -> dict:
    compute = rec["flops"] / PEAK_FLOPS
    memory = rec["hbm_bytes"] / HBM_BW
    coll = rec["collective_total"] / NVLINK_BW
    dominant = max(("compute", compute), ("memory", memory),
                   ("collective", coll), key=lambda kv: kv[1])[0]
    mf = model_flops(rec["arch"], rec["shape"], rec["kind"])
    useful = None
    if mf:
        per_dev = mf / rec["num_devices"]
        useful = per_dev / max(rec["flops"], 1.0)
    bound = max(compute, memory, coll)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "variant": rec.get("variant") or "baseline",
        "kind": rec["kind"],
        "compute_s": compute, "memory_s": memory, "collective_s": coll,
        "dominant": dominant,
        "model_flops_ratio": useful,
        "roofline_fraction": compute / bound if bound else 0.0,
        "peak_gib": rec["memory"]["peak_bytes"] / 2 ** 30,
    }


def table(mesh: str = "single", variant: str = "baseline",
          results: str | None = None) -> list[dict]:
    return [terms(r) for r in load(results)
            if r["mesh"] == mesh
            and (r.get("variant") or "baseline") == variant]


def markdown(mesh: str = "single", results: str | None = None) -> str:
    rows = table(mesh, results=results)
    out = ["| arch | shape | compute s | memory s | collective s | "
           "dominant | useful/HLO | roofline frac | peak GiB |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        mfr = f"{r['model_flops_ratio']:.2f}" \
            if r["model_flops_ratio"] else "-"
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.2e} | "
            f"{r['memory_s']:.2e} | {r['collective_s']:.2e} | "
            f"{r['dominant']} | {mfr} | {r['roofline_fraction']:.2f} | "
            f"{r['peak_gib']:.2f} |")
    return "\n".join(out)


# display order of the kernel ladder: each rung removes a bottleneck of
# the one above it
_LADDER = ("dequant_bag_rowgrid", "dequant_bag", "bag_grad",
           "unfused_bag_matmul", "bag_matmul")


def kernel_table(path: str) -> list[dict]:
    """Measured kernel rows: achieved vs peak HBM bytes/s per shape.

    ``us`` is the best measured time (min of analytic pick and swept
    winner), ``achieved_gbs`` the bytes-touched model over that time,
    ``peak_fraction`` achieved over the record's HBM peak, ``vs_rowgrid``
    the speed-up over the rowgrid oracle at the same shape, and, for
    bag_matmul, ``vs_unfused`` the fusion's speed-up."""
    with open(path) as f:
        rec = json.load(f)
    if rec.get("schema") != "bench_kernel/v1":
        raise ValueError(f"{path}: not a bench_kernel/v1 record")
    by_shape: dict[tuple, dict[str, dict]] = {}
    for e in rec["sweep"]:
        by_shape.setdefault((e["b"], e["k"], e["d"]), {})[e["kernel"]] = e
    rows = []
    for (b, k, d), group in sorted(by_shape.items()):
        base = group.get("dequant_bag_rowgrid")
        unfused = group.get("unfused_bag_matmul")
        for kernel in _LADDER:
            e = group.get(kernel)
            if e is None:
                continue
            us = min(e["analytic_us"], e["measured_us"])
            row = {
                "kernel": kernel, "b": b, "k": k, "d": d, "h": e["h"],
                "backend": rec["backend"], "us": us,
                "achieved_gbs": e["achieved_gbs"],
                "peak_fraction": e["peak_fraction"],
                "block_measured": tuple(e["block_measured"]),
                "tune_speedup": e["speedup"],
            }
            if base is not None and kernel.startswith("dequant_bag"):
                row["vs_rowgrid"] = (
                    min(base["analytic_us"], base["measured_us"]) / us
                    if us > 0 else None)
            if unfused is not None and kernel == "bag_matmul":
                row["vs_unfused"] = (
                    min(unfused["analytic_us"], unfused["measured_us"])
                    / us if us > 0 else None)
            rows.append(row)
    return rows


def kernel_markdown(path: str) -> str:
    rows = kernel_table(path)
    out = ["| kernel | b | k | d | h | us | GB/s | peak frac | "
           "tune x | pipeline x | fusion x |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        pipe = f"{r['vs_rowgrid']:.2f}" if r.get("vs_rowgrid") else "-"
        fuse = f"{r['vs_unfused']:.2f}" if r.get("vs_unfused") else "-"
        out.append(
            f"| {r['kernel']} | {r['b']} | {r['k']} | {r['d']} | "
            f"{r['h'] or '-'} | {r['us']:.2f} | "
            f"{r['achieved_gbs']:.3f} | {r['peak_fraction']:.2e} | "
            f"{r['tune_speedup']:.2f} | {pipe} | {fuse} |")
    return "\n".join(out)


def run() -> list[dict]:
    rows = table("single")
    return [{"arch": r["arch"], "shape": r["shape"],
             "dominant": r["dominant"],
             "roofline_fraction": round(r["roofline_fraction"], 3)}
            for r in rows]


if __name__ == "__main__":
    print(markdown("single"))
    print()
    print(markdown("multi"))
