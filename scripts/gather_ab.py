"""Time builds of the dequant-bag and hashed-gather kernels against each
other on one CUDA card, at the shapes the port's paths give them.

    python3 scripts/gather_ab.py NAME=DIR ... [--reps 10] [--only SHAPE]

Each DIR holds a ``dequant_bag.cu`` and a ``hashed_gather.cu`` (and the
headers they include); both are compiled by ``nvcc`` with the port's
flags (``repro_torch.kernels.build.NVCC_FLAGS``) into
``build/gather_ab/`` and loaded with ``ctypes``.  Every build must
export ``dequant_bag_launch`` and ``hashed_gather_launch`` with the
signatures of ``src/repro_torch/csrc/``; a build that also exports the
one-launch entries (``dequant_bag_tiered_launch``,
``hashed_gather_ids_launch``) has them timed too (the tiered entry with
or without the shard windows of PR 25, read from its source, a whole
store either way).  To compare a commit
with its parent, unpack the parent's ``src/repro_torch/csrc`` into an
ignored directory (``git archive PARENT src/repro_torch/csrc | tar -x -C
build/parent``) and name both.

Shapes (inputs drawn from seed 0 on the card; the rows of large tables
are allocated uninitialised and only the rows the launches read are
filled):
- ``dlrm_serve_<tier>``: a dlrm-rm2 request's tier launch, 512 x 26
  uniform global ids over the served store's tiers (177,837,430 int8,
  8,992,843 bf16 and 17,354,815 fp32 rows of 64), K = 1, the other tiers'
  slots at weight 0; the tiered entry takes the request's ids once, and
  its time is set beside the sum of the three tier launches;
- ``train``: the training forward, one zipf(1.2) batch of 65,536 x 26
  (the ``CriteoSynth`` stream of ``train.setup`` at step 0) over the
  124,185,088 x 64 fp32 table, K = 1, unit weights, no scales;
- ``xdeepfm_d10_<tier>``: an xDeepFM request's tier launch, 512 x 39
  uniform ids over int8 / bf16 / fp32 tiers of D = 10 (the one-element
  path of the parent);
- ``hashed_request_<pool>``: a wide&deep hashed request, 20,480 uniform
  ids x C 4 x NH 2 over the 888,648 x 8 fp32 or 2,369,727 x 8 int8 pool
  (with scales), the plan from ``slot_plan``;
- ``hashed_fit``: the fit's forward, all 22,216,192 rows (ids 0..V-1) x
  C 4 x NH 2 over the fp32 pool (``--fit-pool`` rows), unit scales.

Every build's outputs must equal the first build's bit for bit.  Each
shape is timed in the order given and then in reverse (A B B A),
``--reps`` launches each time, each launch timed by its own CUDA events
with the L2 flushed before it.  Prints the card's name and power limit,
then one JSON line a shape: each build's mean ms over its launches (and
the one-launch entry's, where built), and the byte bound (each input
read once: indices and weights, each distinct live row with its scale,
the plan or ids, the output; at 3.35 TB/s).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
OUT_DIR = ROOT / "build" / "gather_ab"
DLRM_TIERS = (177_837_430, 8_992_843, 17_354_815)
XDEEPFM_TIERS = (60_000_000, 10_000_000, 16_709_150)
TRAIN_CAP = 24_000_000
HASH_V, HASH_POOL = 22_216_192, {"float32": 888_648, "int8": 2_369_727}
P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "dequant_bag_launch": [P, I, P, P, P, P, LL, I, LL, I, P],
    "dequant_bag_tiered_launch": [P, P, P, LL, P, I, P, LL, P, LL, P, I, P,
                                  P, LL, I, LL, P],
    "hashed_gather_launch": [P, I, P, P, P, P, LL, I, I, I, P],
    "hashed_gather_ids_launch": [P, I, P, P, I, P, P, LL, I, I, I, LL,
                                 ctypes.c_uint, I, P]}
# the tiered entry with a shard window a tier (a first row before each
# tier's row count), since PR 25; a whole store is the window (0, V_t)
WINDOWED_TIERED = [P, P, P, LL, LL, P, I, P, LL, LL, P, LL, LL, P, I, P, P,
                   LL, I, LL, P]
WINDOWED = set()    # ids of the loaded tiered entries that take windows
DTYPE_CODE = {"int8": 0, "bfloat16": 1, "float32": 2, "float16": 3}


def build(name: str, source: Path) -> dict:
    from repro_torch.kernels import build as kbuild
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(kbuild.NVCC_FLAGS).encode())
    path = OUT_DIR / f"{name}-{source.stem}-{digest.hexdigest()[:16]}.so"
    if not path.exists():
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-o",
                        str(path), str(source)], check=True, timeout=600,
                       capture_output=True)
    lib = ctypes.CDLL(str(path))
    windowed = b"long long first8" in source.read_bytes()
    fns = {}
    for fn, argtypes in SIGNATURES.items():
        if hasattr(lib, fn):
            f = getattr(lib, fn)
            if fn == "dequant_bag_tiered_launch" and windowed:
                argtypes = WINDOWED_TIERED
                WINDOWED.add(id(f))
            f.argtypes, f.restype = argtypes, ctypes.c_int
            fns[fn] = f
    return fns


def call(fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__}: cudaError {rc}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("builds", nargs="+", metavar="NAME=DIR")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--only", action="append", metavar="SHAPE",
                    help="shape name prefix to run (repeatable)")
    ap.add_argument("--fit-pool", type=int, default=HASH_POOL["float32"],
                    metavar="S", help="pool rows of the hashed_fit shape "
                    "(default the wide&deep fp32 pool's; a pool of a few "
                    "thousand rows stays in L1 and shows what the pool "
                    "reads cost)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("gather_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    builds = {}
    for spec in args.builds:
        name, path = spec.split("=", 1)
        fns = {}
        for src in ("dequant_bag", "hashed_gather"):
            fns.update(build(name, Path(path) / f"{src}.cu"))
        builds[name] = fns
    names = list(builds)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def timed(launch_of, entry: str, first_out) -> tuple:
        """Check each build that has ``entry`` against the first one's
        output (and ``first_out``, where given), then time it A B B A;
        ({build: mean ms}, the output)."""
        have = [n for n in names if entry in builds[n]]
        ref = None
        for n in have:
            out = launch_of(builds[n][entry])
            torch.cuda.synchronize()
            if ref is None:
                ref = out.clone()
            elif not torch.equal(out.view(torch.int32),
                                 ref.view(torch.int32)):
                raise SystemExit(f"{n}:{entry} != {have[0]}")
        if first_out is not None and ref is not None and not torch.equal(
                first_out.view(torch.int32), ref.view(torch.int32)):
            raise SystemExit(f"{entry} != the per-launch builds' output")
        times = {n: [] for n in have}
        for n in have + have[::-1]:
            pairs = []
            for _ in range(args.reps):
                flush.zero_()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                launch_of(builds[n][entry])
                e1.record()
                pairs.append((e0, e1))
            torch.cuda.synchronize()
            times[n] += [a.elapsed_time(b) for a, b in pairs]
        return {n: sum(t) / len(t) for n, t in times.items()}, ref

    def wanted(shape: str) -> bool:
        """``shape`` (or a group of shapes) is asked for by ``--only``."""
        return not args.only or any(shape.startswith(o) or o.startswith(shape)
                                    for o in args.only)

    def report(shape: str, nbytes: float, **fields) -> None:
        print(json.dumps({"shape": shape, "bytes": nbytes,
                          "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                          **fields, "order": names + names[::-1],
                          "launches_each": 2 * args.reps}), flush=True)

    def tiers_of(rows, d, half):
        """Uninitialised tier payloads and scales of ``rows`` rows of D,
        the global rows laid out tier after tier, with the indirect
        words."""
        dts = (torch.int8, half, torch.float32)
        payloads = [torch.empty((r, d), dtype=dt, device=dev)
                    for r, dt in zip(rows, dts)]
        scales = [torch.rand(r, generator=gen, device=dev) * 0.01
                  for r in rows[:2]]
        indirect = torch.cat([
            (t << 28) | torch.arange(r, dtype=torch.int32, device=dev)
            for t, r in enumerate(rows)])
        return payloads, scales, indirect

    def fill(payload, rows) -> None:
        if payload.dtype == torch.int8:
            payload[rows] = torch.randint(-128, 128, (rows.numel(),
                                                      payload.shape[1]),
                                          generator=gen, device=dev,
                                          dtype=torch.int8)
        else:
            payload[rows] = (torch.randn((rows.numel(), payload.shape[1]),
                                         generator=gen, device=dev)
                             * 0.1).to(payload.dtype)

    def request(prefix, rows, d, fields, half=torch.bfloat16):
        """Each tier's single-tier launch on one request's uniform ids,
        and (where built) the tiered entry on the ids."""
        payloads, scales, indirect = tiers_of(rows, d, half)
        ids = torch.randint(0, indirect.shape[0], (512 * fields, 1),
                            generator=gen, device=dev)
        code = indirect[ids]
        tier, loc = code >> 28, (code & ((1 << 28) - 1)).to(torch.int32)
        out = torch.empty((ids.shape[0], d), device=dev)
        total = {n: 0.0 for n in names}
        composed = torch.zeros_like(out)
        for t, name in enumerate(("int8", str(half).removeprefix("torch."),
                                  "float32")):
            w = (tier == t).to(torch.float32).contiguous()
            li = loc.clamp(0, rows[t] - 1).contiguous()
            fill(payloads[t], li[w != 0].to(torch.int64))
            s = scales[t] if t < 2 else None
            itemsize = payloads[t].element_size()
            vec = 16 // itemsize if (d * itemsize) % 16 == 0 else 1

            def launch(fn, t=t, w=w, li=li, s=s, vec=vec):
                call(fn, payloads[t].data_ptr(), DTYPE_CODE[name],
                     None if s is None else s.data_ptr(), li.data_ptr(),
                     w.data_ptr(), out.data_ptr(), ids.shape[0], 1, d, vec,
                     stream)
                return out
            ms, got = timed(launch, "dequant_bag_launch", None)
            composed += got
            live = int((w != 0).sum())
            distinct = int(torch.unique(li[w != 0]).numel())
            nbytes = (ids.shape[0] * 8 + live * 4 + distinct
                      * (d * itemsize + (4 if s is not None else 0))
                      + ids.shape[0] * d * 4)
            report(f"{prefix}_{name}", nbytes, ms=ms, slots=ids.shape[0],
                   live_slots=live, distinct_live_rows=distinct)
            for n in names:
                total[n] += ms[n]

        half_code = DTYPE_CODE[str(half).removeprefix("torch.")]
        tail = (ids.data_ptr(), 1, None, out.data_ptr(), ids.shape[0], 1, d,
                stream)

        def tiered(fn):
            if id(fn) in WINDOWED:     # the whole store: windows (0, V_t)
                call(fn, indirect.data_ptr(), payloads[0].data_ptr(),
                     scales[0].data_ptr(), 0, rows[0], payloads[1].data_ptr(),
                     half_code, scales[1].data_ptr(), 0, rows[1],
                     payloads[2].data_ptr(), 0, rows[2], *tail)
            else:
                call(fn, indirect.data_ptr(), payloads[0].data_ptr(),
                     scales[0].data_ptr(), rows[0], payloads[1].data_ptr(),
                     half_code, scales[1].data_ptr(), rows[1],
                     payloads[2].data_ptr(), rows[2], *tail)
            return out
        if any("dequant_bag_tiered_launch" in builds[n] for n in names):
            ms, _ = timed(tiered, "dequant_bag_tiered_launch", composed)
            distinct = torch.unique(ids)
            tiers_of_distinct = indirect[distinct] >> 28
            sizes = (d + 4, d * 2 + 4, d * 4)
            nbytes = (ids.shape[0] * 8 + distinct.numel() * 4
                      + sum(int((tiers_of_distinct == t).sum()) * sizes[t]
                            for t in range(3)) + ids.shape[0] * d * 4)
            report(f"{prefix}_tiered", nbytes, tiered_ms=ms,
                   three_tier_launches_ms=total, slots=ids.shape[0])
        del payloads, scales, indirect
        torch.cuda.empty_cache()

    if wanted("dlrm_serve"):
        request("dlrm_serve", DLRM_TIERS, 64, 26)
    if wanted("xdeepfm_d10"):
        request("xdeepfm_d10", XDEEPFM_TIERS, 10, 39)

    if wanted("train"):
        from repro_torch import configs
        from repro_torch.data.criteo import CriteoConfig, CriteoSynth
        from repro_torch.models.embedding import FieldSpec, globalize
        cards = tuple(min(int(c), TRAIN_CAP) for c in
                      configs.get("dlrm-rm2").cfg.cardinalities)
        spec = FieldSpec(cards, 64)
        ds = CriteoSynth(CriteoConfig(num_fields=len(cards),
                                      cardinalities=cards,
                                      important_fields=len(cards) // 2))
        idx = globalize(torch.from_numpy(ds.batch(65_536, 0)["indices"])
                        .to(dev), spec).reshape(-1, 1).to(torch.int32)
        table = torch.empty((spec.total_rows, 64), device=dev)
        distinct = torch.unique(idx).to(torch.int64)
        fill(table, distinct)
        w = torch.ones(idx.shape, device=dev)
        out = torch.empty((idx.shape[0], 64), device=dev)

        def train(fn):
            call(fn, table.data_ptr(), 2, None, idx.data_ptr(),
                 w.data_ptr(), out.data_ptr(), idx.shape[0], 1, 64, 4,
                 stream)
            return out
        ms, _ = timed(train, "dequant_bag_launch", None)
        nbytes = (idx.numel() * 8 + distinct.numel() * 256
                  + idx.shape[0] * 256)
        report("train", nbytes, ms=ms, slots=idx.numel(),
               distinct_rows=distinct.numel(), rows=spec.total_rows)
        del table, out, idx
        torch.cuda.empty_cache()

    if wanted("hashed"):
        from repro_torch.kernels.hashed_gather.ops import slot_plan
        from repro_torch.kernels.hashed_gather.ref import salt
        for shape, pool_name in (("hashed_request_float32", "float32"),
                                 ("hashed_request_int8", "int8"),
                                 ("hashed_fit", "float32")):
            if not wanted(shape):
                continue
            s = args.fit_pool if shape == "hashed_fit" else HASH_POOL[
                pool_name]
            pool = (torch.randn((s, 8), generator=gen, device=dev) * 0.1
                    if pool_name == "float32" else
                    torch.randint(-128, 128, (s, 8), generator=gen,
                                  device=dev, dtype=torch.int8))
            fit = shape == "hashed_fit"
            scales = (None if fit else
                      torch.rand(s, generator=gen, device=dev) * 0.01)
            ids = (torch.arange(HASH_V, dtype=torch.int32, device=dev)
                   .reshape(-1, 1) if fit else
                   torch.randint(0, HASH_V, (20_480, 1), generator=gen,
                                 device=dev))
            slots, coeff = slot_plan(ids, None, num_chunks=4, num_hashes=2,
                                     num_slots=s)
            out = torch.empty((ids.shape[0], 32), device=dev)
            code = DTYPE_CODE[pool_name]

            def plan(fn):
                call(fn, pool.data_ptr(), code,
                     None if scales is None else scales.data_ptr(),
                     slots.data_ptr(), coeff.data_ptr(), out.data_ptr(),
                     ids.shape[0], 4, 2, 8, stream)
                return out

            def by_ids(fn):
                call(fn, pool.data_ptr(), code,
                     None if scales is None else scales.data_ptr(),
                     ids.data_ptr(), int(ids.dtype == torch.int64), None,
                     out.data_ptr(), ids.shape[0], 1, 4, 2, s, salt(0), 8,
                     stream)
                return out
            ms, got = timed(plan, "hashed_gather_launch", None)
            rows = (s if fit else
                    int(torch.unique(slots[coeff != 0]).numel()))
            row_bytes = rows * (8 * pool.element_size()
                                + (0 if scales is None else 4))
            out_bytes = out.numel() * 4
            fields = {"ms": ms, "bags": ids.shape[0], "pool_rows": s,
                      "plan_bound_ms": (slots.numel() * 8 + row_bytes
                                        + out_bytes) / HBM_BYTES_PER_S
                      * 1e3}
            if any("hashed_gather_ids_launch" in builds[n] for n in names):
                fields["ids_ms"], _ = timed(by_ids,
                                            "hashed_gather_ids_launch", got)
            report(shape, ids.numel() * ids.element_size() + row_bytes
                   + out_bytes, **fields)
            del pool, slots, coeff, out, ids
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
