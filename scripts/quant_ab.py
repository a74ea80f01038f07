"""Time builds of the row-wise quantizer's C entry against each other on
one CUDA card, at the shapes the port's packs give it.

    python3 scripts/quant_ab.py NAME=path/to/rowwise_quant.cu ... \\
        [--shape 3653765x64 --shape 4194304x10] [--reps 10]

Each source is compiled by ``nvcc`` with the port's flags
(``repro_torch.kernels.build.NVCC_FLAGS``) into ``build/quant_ab/`` and
loaded with ``ctypes``; every source must export ``rowwise_quant_launch``
with the signature of ``src/repro_torch/csrc/rowwise_quant.cu``.  To
compare a commit with its parent, unpack the parent's
``src/repro_torch/csrc/rowwise_quant.cu`` into an ignored directory and
name both.

The default shapes are the int8 rows of the first build chunk of the
dlrm-rm2 pack (3,653,765 x 64, the vector path) and a full 4,194,304-row
chunk of the xdeepfm pack (D = 10, the scalar path).  The rows are drawn
from a seed on the card (normal, each row scaled by a factor in [1e-3,
10)); a row's time does not depend on its finite values.  Round to
nearest, narrow mode, dividing scale: what the packs run.  Every source's
codes and scales must equal the first source's, bit for bit.  Each shape
is timed in the order given and then in reverse (A B B A), ``--reps``
launches each time, each launch timed by its own CUDA events with the L2
flushed before it.  Prints the card's name and power limit, then one JSON
line a shape: each source's mean ms over its launches, and the byte bound
(4 bytes read and 1 written an element, 4 bytes of scale a row, at 3.35
TB/s).
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
OUT_DIR = ROOT / "build" / "quant_ab"


def build(name: str, source: Path) -> ctypes.CDLL:
    from repro_torch.kernels import build as kbuild
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(kbuild.NVCC_FLAGS).encode())
    path = OUT_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    if not path.exists():
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-o",
                        str(path), str(source)], check=True, timeout=600)
    fn = ctypes.CDLL(str(path)).rowwise_quant_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, ll, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="+", metavar="NAME=PATH")
    ap.add_argument("--shape", action="append", metavar="VxD")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("quant_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    named = [s.split("=", 1) for s in args.sources]
    fns = {name: build(name, Path(path)) for name, path in named}
    names = [name for name, _ in named]
    shapes = [tuple(int(n) for n in s.split("x"))
              for s in (args.shape or ["3653765x64", "4194304x10"])]

    dev = torch.device("cuda")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for v, d in shapes:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        x = torch.randn((v, d), generator=gen, device=dev) * (
            torch.rand((v, 1), generator=gen, device=dev) * 10 + 1e-3)
        q = torch.empty((v, d), dtype=torch.int8, device=dev)
        sc = torch.empty((v, 1), dtype=torch.float32, device=dev)

        def launch(name):
            rc = fns[name](x.data_ptr(), None, q.data_ptr(), sc.data_ptr(),
                           v, d, 0, 0, stream)
            if rc != 0:
                raise RuntimeError(f"{name}: cudaError {rc}")

        first = None
        for name in names:
            launch(name)
            torch.cuda.synchronize()
            if first is None:
                first = (q.clone(), sc.clone())
            elif not (torch.equal(q, first[0]) and torch.equal(
                    sc.view(torch.int32), first[1].view(torch.int32))):
                raise SystemExit(f"{name} != {names[0]} at V={v}, D={d}")
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            pairs = []
            for _ in range(args.reps):
                flush.zero_()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                launch(name)
                e1.record()
                pairs.append((e0, e1))
            torch.cuda.synchronize()
            times[name] += [a.elapsed_time(b) for a, b in pairs]
        nbytes = v * d * 5 + v * 4
        print(json.dumps({
            "V": v, "D": d, "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "ms": {n: sum(t) / len(t) for n, t in times.items()},
            "order": names + names[::-1], "launches_each": 2 * args.reps}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
