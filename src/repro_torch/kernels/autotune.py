"""Measured autotune cache for the CUDA kernels' tilings.

Port of ``repro/kernels/autotune.py``.  Each tiled CUDA entry takes a
tiling, two ints ``(block_b, block_d)``: bags a block, and columns or
outputs a block (each kernel's ``kernel.py`` says what they mean for
it); ``(0, 0)`` is the kernel's analytic rule.  This module is the
measured layer over that rule: a timing sweep over candidate tilings per
``(backend, kernel, dtype, B, K, D)`` key, persisted to a versioned JSON
cache so that serving processes never pay the sweep.

Contract, as the reference's:

  * The serving path only ever **reads** the cache (``lookup_cached``,
    through the ops' ``resolve_tiling``): an explicit tiling argument
    first, then a cache hit, then the analytic pick.  Runtime never
    times kernels inline.
  * Sweeps run out of band (``python -m repro_torch.benchmarks.kernels
    --seed-cache``) on the target card and write through ``store``.
  * Cache location: the ``REPRO_AUTOTUNE_CACHE`` environment variable,
    else ``results/autotune.json`` relative to the working directory; an
    empty value disables the cache.  ``set_cache_path`` points this
    process at a file (the serve CLI's ``--autotune-cache``).
  * Invalidation: a file whose ``schema`` is not ``autotune_cache/v1``,
    that does not parse, or whose entry is malformed reads as empty (the
    analytic pick, never an error).  The key's backend is the card's
    name (``torch.cuda.get_device_name``), so an entry measured on
    another card, on a TPU or in interpret mode is a miss, not a stale
    hit.

Only tilings that sum every output element in the same order are
candidates (each kernel's ``candidate_tilings``), so a cache entry can
never change a result, only a time.

Timing (``time_us``) on CUDA times the device only: CUDA events around a
run of back-to-back launches queued behind a device-side delay
(``torch.cuda._sleep``, doubled until the host's dispatch of the run
fits in half of it), so that no host dispatch falls inside the window,
and the minimum over the repeats of (window / launches).  The
reference's min-of-N wall time with a host sync would time launch
latency on request-sized kernels of ~10 us.  On the CPU the plain
versions have no tiling: ``time_us`` is wall time there and a sweep's
only candidate is the analytic pick.

The in-memory copy reloads when the file's mtime or path changes, so a
sweep seeded by another process is picked up without a restart; a cache
read costs a launch one ``stat`` and a dict lookup.
"""

from __future__ import annotations

import functools
import json
import os
import time
from typing import Callable

import torch

CACHE_SCHEMA = "autotune_cache/v1"
DEFAULT_CACHE_PATH = os.path.join("results", "autotune.json")

_ENV = "REPRO_AUTOTUNE_CACHE"
# the launches a timed window holds, and the device-side delay (cycles)
# queued before them so that the host enqueues them all before the first
# runs
WINDOW_LAUNCHES = 20
SLEEP_CYCLES = 10_000_000
MAX_SLEEP_CYCLES = 1 << 31
# cache hits served to launches by ``resolve_tiling``, by kernel, since
# import (a run can show that its path read the cache)
hits: dict[str, int] = {}


def set_cache_path(path: str | None) -> None:
    """Point this process's cache at ``path`` (``""`` disables it, ``None``
    goes back to the default): it sets ``REPRO_AUTOTUNE_CACHE``, so a
    child process reads the same file."""
    if path is None:
        os.environ.pop(_ENV, None)
    else:
        os.environ[_ENV] = path


def cache_path() -> str | None:
    """Resolved cache file path; None when the cache is disabled."""
    p = os.environ.get(_ENV)
    if p is None:
        return DEFAULT_CACHE_PATH
    return p or None  # empty string disables


def backend_name(device: str | torch.device | None = None) -> str:
    """Cache-key backend: the card's name (``NVIDIA H100 80GB HBM3``), or
    ``cpu`` where the plain versions run (they have no tiling: a CPU
    entry is never served to a card)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and torch.cuda.is_available():
        return _card_name(torch.cuda.current_device() if dev.index is None
                          else dev.index)
    return "cpu"


@functools.cache
def _card_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def cache_key(kernel: str, dtype: str, b: int, k: int, d: int,
              extra: str = "", device: str | torch.device | None = None
              ) -> str:
    return (f"{backend_name(device)}|{kernel}|{dtype}"
            f"|b={int(b)}|k={int(k)}|d={int(d)}{extra}")


# --------------------------------------------------------------------- I/O

# (path, mtime_ns) -> entries dict; one stat() per lookup, one read per
# file change
_loaded: dict = {"path": None, "mtime": None, "entries": {}}


def _read_entries(path: str) -> dict:
    try:
        with open(path) as f:
            doc = json.load(f)
        if not isinstance(doc, dict) or doc.get("schema") != CACHE_SCHEMA:
            return {}
        entries = doc.get("entries")
        return entries if isinstance(entries, dict) else {}
    except (OSError, ValueError):
        # missing, unreadable or corrupt cache: behave as empty
        return {}


def _entries() -> dict:
    path = cache_path()
    if path is None:
        return {}
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        mtime = None
    if _loaded["path"] != path or _loaded["mtime"] != mtime:
        _loaded["entries"] = _read_entries(path) if mtime is not None else {}
        _loaded["path"] = path
        _loaded["mtime"] = mtime
    return _loaded["entries"]


def lookup_cached(kernel: str, dtype: str, b: int, k: int, d: int,
                  extra: str = "", device: str | torch.device | None = None
                  ) -> tuple[int, int] | None:
    """(block_b, block_d) for the key, or None on miss/malformed entry."""
    e = _entries().get(cache_key(kernel, dtype, b, k, d, extra, device))
    if not isinstance(e, dict):
        return None
    bb, bd = e.get("block_b"), e.get("block_d")
    if (isinstance(bb, int) and isinstance(bd, int)
            and not isinstance(bb, bool) and not isinstance(bd, bool)
            and bb >= 1 and bd >= 1):
        return bb, bd
    return None


def store(kernel: str, dtype: str, b: int, k: int, d: int,
          block_b: int, block_d: int, us: float, extra: str = "",
          device: str | torch.device | None = None) -> str | None:
    """Write one measured entry through to the cache file (atomic
    replace, other entries preserved).  Returns the path written."""
    path = cache_path()
    if path is None:
        return None
    entries = dict(_read_entries(path))
    entries[cache_key(kernel, dtype, b, k, d, extra, device)] = {
        "block_b": int(block_b), "block_d": int(block_d),
        "us": float(us),
    }
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"schema": CACHE_SCHEMA, "entries": entries}, f,
                  indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    _loaded["mtime"] = None  # force reload on next lookup
    return path


def resolve_tiling(kernel: str, dtype: str, b: int, k: int, d: int,
                   tiling: tuple[int, int] | None = None, extra: str = "",
                   device: str | torch.device | None = None,
                   valid: Callable[[tuple[int, int]], bool] | None = None
                   ) -> tuple[int, int]:
    """The tiling a launch takes, in the reference's ``resolve_block_sizes``
    order: an explicit ``tiling``, then a cache hit for the key (unless
    ``valid`` says the launch cannot take it: the key leaves out what the
    kernel's build also depends on), then ``(0, 0)``, the kernel's
    analytic pick."""
    if tiling is not None:
        bb, bd = (int(x) for x in tiling)
        if bb < 0 or bd < 0:
            raise ValueError(f"tiling must be two ints >= 0, got {tiling}")
        return bb, bd
    cached = lookup_cached(kernel, dtype, b, k, d, extra, device)
    if cached is None or (valid is not None and not valid(cached)):
        return (0, 0)
    hits[kernel] = hits.get(kernel, 0) + 1
    return cached


# ----------------------------------------------------------------- sweeps


def time_us(fn: Callable[[], object], iters: int = 3, warmup: int = 1,
            device: str | torch.device | None = None) -> float:
    """Microseconds a call of ``fn``.

    On CUDA: CUDA events around ``WINDOW_LAUNCHES`` back-to-back calls,
    queued behind a device-side delay so that the host's dispatch of
    every call lands before the first one runs; the minimum over
    ``iters`` windows of (window / calls), device time only.  A window
    whose dispatch took the host longer than half the delay ran on the
    device is taken again behind twice the delay, so a slow host (or a
    call heavy on the host) cannot put its own time in the window.  On
    the CPU: the minimum wall time of ``iters`` calls."""
    dev = torch.device("cuda" if device is None else device)
    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        best = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t0) * 1e6)
        return best
    with torch.cuda.device(dev):
        torch.cuda.synchronize(dev)
        best, cycles = float("inf"), SLEEP_CYCLES
        for _ in range(iters):
            while True:
                pre, start, end = (torch.cuda.Event(enable_timing=True)
                                   for _ in range(3))
                pre.record()
                torch.cuda._sleep(cycles)
                start.record()
                t0 = time.perf_counter()
                for _ in range(WINDOW_LAUNCHES):
                    fn()
                host_ms = (time.perf_counter() - t0) * 1e3
                end.record()
                end.synchronize()
                if (host_ms < 0.5 * pre.elapsed_time(start)
                        or cycles >= MAX_SLEEP_CYCLES):
                    break
                cycles *= 2
            best = min(best, start.elapsed_time(end) * 1e3 / WINDOW_LAUNCHES)
    return best


def sweep(run: Callable[[int, int], Callable[[], object]],
          candidates: list[tuple[int, int]], iters: int = 3,
          device: str | torch.device | None = None) -> dict:
    """Time ``run(block_b, block_d)()`` for every candidate tiling.

    Returns ``{"best": (bb, bd), "best_us": t, "sweep": [...]}`` with
    one ``{"block_b", "block_d", "us"}`` row per candidate.  Candidates
    that fail to build or launch are recorded with ``us: None`` and
    excluded from ``best`` (a tiling the card rejects must never win);
    raises when every candidate fails.
    """
    rows = []
    best, best_us = None, float("inf")
    for bb, bd in candidates:
        try:
            us = time_us(run(bb, bd), iters=iters, device=device)
        except Exception:
            rows.append({"block_b": bb, "block_d": bd, "us": None})
            continue
        rows.append({"block_b": bb, "block_d": bd, "us": us})
        if us < best_us:
            best, best_us = (bb, bd), us
    if best is None:
        raise RuntimeError("autotune sweep: every candidate failed")
    return {"best": best, "best_us": best_us, "sweep": rows}


def candidate_tilings(kernel: str, analytic: tuple[int, int],
                      device: str | torch.device | None = None, **shape
                      ) -> list[tuple[int, int]]:
    """The result-invariant candidate tilings of ``kernel``
    (``dequant_bag``, ``bag_grad``, ``bag_matmul``, ``hashed_gather``) at
    ``shape``, the analytic pick first, at most 12.  On the CPU the plain
    versions have no tiling: the analytic pick alone."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return [tuple(analytic)]
    from repro_torch.kernels.bag_matmul import kernel as bm
    from repro_torch.kernels.dequant_bag import kernel as db
    from repro_torch.kernels.hashed_gather import kernel as hg
    built = {"dequant_bag": db.dequant_bag_tilings,
             "bag_grad": db.bag_grad_tilings,
             "bag_matmul": bm.bag_matmul_tilings,
             "hashed_gather": hg.hashed_gather_tilings}[kernel](**shape)
    rest = sorted(set(built) - {tuple(analytic)})
    return [tuple(analytic)] + rest[:11]
