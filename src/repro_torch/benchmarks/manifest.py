"""The committed benchmark records, as one manifest.

Port of ``benchmarks/manifest.py``: the same basenames and schema tags,
with the port's commands.  ``repro_torch.benchmarks.run --emit PATH``
dispatches on the output file's basename through this table, so the
records it can write are the ones ``tools/check_bench_schema.py
--committed`` validates.  Records whose module is not ported yet keep
their entry; the runner names the ROADMAP item it waits for.
"""

from __future__ import annotations

import os

# basename -> (schema tag, command that writes it)
COMMITTED_BENCH: dict[str, tuple[str, str]] = {
    "BENCH_qps.json": (
        "bench_qps/v1",
        "python -m repro_torch.benchmarks.run --emit BENCH_qps.json"),
    "BENCH_hier.json": (
        "bench_hier/v1",
        "python -m repro_torch.benchmarks.hier --emit BENCH_hier.json"),
    "BENCH_pipeline.json": (
        "bench_pipeline/v1",
        "python -m repro_torch.benchmarks.run --emit BENCH_pipeline.json"),
    "BENCH_kernel.json": (
        "bench_kernel/v1",
        "python -m repro_torch.benchmarks.kernels --emit BENCH_kernel.json"),
    "BENCH_fleet.json": (
        "bench_fleet/v1",
        "python -m repro_torch.launch.fleet --emit BENCH_fleet.json"),
    "BENCH_hash.json": (
        "bench_hash/v1",
        "python -m repro_torch.benchmarks.hashed --emit BENCH_hash.json"),
}


def expected_schema(path: str) -> str | None:
    """The schema tag of a committed record's path (None if it is not one)."""
    entry = COMMITTED_BENCH.get(os.path.basename(path))
    return entry[0] if entry else None
