"""The CUDA hashed-gather kernel bound to PyTorch.

``hashed_gather_cuda`` (``csrc/hashed_gather.cu``) replaces
``repro/kernels/hashed_gather/kernel.py::hashed_gather_pallas``: it takes
the slot plan.  ``hashed_gather_ids_cuda`` (the same source) takes the
bag ids and hashes the plan in registers, ``slot_plan`` and the gather
in one launch.  The library is built at first call (``kernels.build``)
and loaded with ``ctypes``; a launch goes on PyTorch's current stream
and does not synchronise.  ``launches`` counts this process's launches
by pool dtype (each is its own instantiation of the kernel), the ids
entry's under ``ids_<dtype>``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dequant_bag.kernel import _check
from repro_torch.kernels.hashed_gather.ref import salt

_DTYPE_CODE = {torch.int8: 0, torch.float32: 2}

launches = {"int8": 0, "float32": 0, "ids_int8": 0, "ids_float32": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def total_launches() -> int:
    return sum(launches.values())


@functools.cache
def _launcher():
    fn = build.load("hashed_gather").hashed_gather_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, i, p, p, p, p, ll, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


# Either entry's tiling (block_b, block_d): bags a block and columns a
# thread, 4 or 8 (a (bag, chunk) takes ceil(Z / block_d) threads; a block
# at most 256 threads, rounded up to a warp).  (0, 0) is the analytic
# pick: 8 columns a thread (4 where Z <= 4) and as many bags as 256
# threads hold.  One thread owns each output column's chain over t in
# order, so every tiling is bit-equal.
THREADS = 256


def _most_bags(num_chunks: int, z: int, cols: int) -> int:
    return THREADS // (num_chunks * -(-z // cols))


def hashed_gather_analytic(num_chunks: int, z: int,
                           device: torch.device | None = None
                           ) -> tuple[int, int]:
    """Either entry's analytic tiling at (C, Z): on CUDA the kernel's own
    rule (``hashed_gather_tiling``), elsewhere its mirror."""
    if device is not None and torch.device(device).type == "cuda":
        from repro_torch.kernels.dequant_bag.kernel import _tiling_query
        with torch.cuda.device(device):
            return _tiling_query("hashed_gather", "hashed_gather_tiling",
                                 ctypes.c_int(num_chunks), ctypes.c_int(z))
    cols = 4 if z <= 4 else 8
    return _most_bags(num_chunks, z, cols), cols


def hashed_gather_tilings(num_chunks: int, z: int
                          ) -> list[tuple[int, int]]:
    """The built tilings: 4 or 8 columns a thread, with the most bags a
    block holds, half and a quarter of them."""
    out = []
    for cols in (4, 8):
        most = _most_bags(num_chunks, z, cols)
        out += [(bb, cols) for bb in sorted({most, most // 2, most // 4})
                if bb >= 1]
    return out


def hashed_gather_tiling_ok(tiling: tuple[int, int], num_chunks: int,
                            z: int) -> bool:
    """Whether ``tiling`` is (0, 0) or built at (C, Z)."""
    bb, cols = tiling
    if (bb, cols) == (0, 0):
        return True
    return cols in (4, 8) and 1 <= bb <= _most_bags(num_chunks, z, cols)


def _check_pool(fn: str, pool: torch.Tensor, scales: torch.Tensor | None
                ) -> None:
    dev = pool.device
    if dev.type != "cuda":
        raise ValueError(f"{fn} needs CUDA tensors, got {dev}")
    if pool.dtype not in _DTYPE_CODE:
        raise TypeError(f"pool must be float32 or int8, got {pool.dtype}")
    _check("pool", pool, pool.dtype, 2, dev)
    if scales is not None:
        _check("scales", scales, torch.float32, 1, dev)
        if scales.shape[0] != pool.shape[0]:
            raise ValueError(f"scales has {scales.shape[0]} rows, pool "
                             f"{pool.shape[0]}")


def hashed_gather_cuda(pool: torch.Tensor, scales: torch.Tensor | None,
                       slots: torch.Tensor, coeff: torch.Tensor, *,
                       num_chunks: int, tiling: tuple[int, int] = (0, 0)
                       ) -> torch.Tensor:
    """Launch the kernel: pool (S, Z) fp32|int8, scales (S,) fp32 or None
    (unit scales), slots (B, C*T) int32 in [0, S), coeff (B, C*T) fp32
    -> (B, C*Z) fp32, at ``tiling`` ((0, 0): the analytic pick).  All on
    one CUDA device and contiguous; raises otherwise."""
    _check_pool("hashed_gather_cuda", pool, scales)
    dev = pool.device
    _check("slots", slots, torch.int32, 2, dev)
    _check("coeff", coeff, torch.float32, 2, dev)
    if coeff.shape != slots.shape:
        raise ValueError(f"coeff {tuple(coeff.shape)} != slots "
                         f"{tuple(slots.shape)}")
    if num_chunks < 1 or slots.shape[1] % num_chunks:
        raise ValueError(f"{slots.shape[1]} slot columns do not split into "
                         f"{num_chunks} chunks")
    b = slots.shape[0]
    z = pool.shape[1]
    t = slots.shape[1] // num_chunks
    out = torch.empty((b, num_chunks * z), dtype=torch.float32, device=dev)
    if b == 0 or z == 0:
        return out
    launch = _launcher()
    with torch.cuda.device(dev):
        rc = launch(pool.data_ptr(), _DTYPE_CODE[pool.dtype],
                    None if scales is None else scales.data_ptr(),
                    slots.data_ptr(), coeff.data_ptr(), out.data_ptr(),
                    b, num_chunks, t, z, int(tiling[0]), int(tiling[1]),
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hashed_gather launch failed: cudaError {rc} "
                           f"(B={b}, C={num_chunks}, T={t}, Z={z}, "
                           f"{pool.dtype})")
    launches[str(pool.dtype).removeprefix("torch.")] += 1
    return out


@functools.cache
def _ids_launcher():
    fn = build.load("hashed_gather").hashed_gather_ids_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, i, p, p, i, p, p, ll, i, i, i, ll, ctypes.c_uint, i, i,
                   i, p]
    fn.restype = ctypes.c_int
    return fn


def hashed_gather_ids_cuda(pool: torch.Tensor, scales: torch.Tensor | None,
                           ids: torch.Tensor, weights: torch.Tensor | None,
                           *, num_chunks: int, num_hashes: int,
                           seed: int = 0, tiling: tuple[int, int] = (0, 0)
                           ) -> torch.Tensor:
    """Launch the ids entry: pool (S, Z) fp32|int8, scales (S,) fp32 or
    None (unit scales), ids (B, K) int32 or int64 (their low 32 bits are
    hashed), weights (B, K) fp32 or None (ones) -> (B, C*Z) fp32, what
    ``hashed_gather_cuda`` gives on ``slot_plan(ids, weights, ...)`` with
    ``num_slots = S``, at ``tiling`` (as ``hashed_gather_cuda``'s).  All on
    one CUDA device and contiguous; raises otherwise."""
    _check_pool("hashed_gather_ids_cuda", pool, scales)
    dev = pool.device
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"ids must be int32 or int64, got {ids.dtype}")
    _check("ids", ids, ids.dtype, 2, dev)
    if weights is not None:
        _check("weights", weights, torch.float32, 2, dev)
        if weights.shape != ids.shape:
            raise ValueError(f"weights {tuple(weights.shape)} != ids "
                             f"{tuple(ids.shape)}")
    if num_chunks < 1 or num_hashes < 1:
        raise ValueError(f"num_chunks {num_chunks} and num_hashes "
                         f"{num_hashes} must be positive")
    b, k = ids.shape
    s, z = pool.shape
    out = torch.empty((b, num_chunks * z), dtype=torch.float32, device=dev)
    if b == 0 or z == 0:
        return out
    with torch.cuda.device(dev):
        rc = _ids_launcher()(
            pool.data_ptr(), _DTYPE_CODE[pool.dtype],
            None if scales is None else scales.data_ptr(), ids.data_ptr(),
            int(ids.dtype == torch.int64),
            None if weights is None else weights.data_ptr(), out.data_ptr(),
            b, k, num_chunks, num_hashes, s, salt(seed), z, int(tiling[0]),
            int(tiling[1]), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hashed_gather_ids launch failed: cudaError {rc} "
                           f"(B={b}, K={k}, C={num_chunks}, NH={num_hashes}, "
                           f"S={s}, Z={z}, {pool.dtype})")
    launches["ids_" + str(pool.dtype).removeprefix("torch.")] += 1
    return out
