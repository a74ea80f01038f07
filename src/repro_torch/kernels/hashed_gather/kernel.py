"""The CUDA hashed-gather kernel bound to PyTorch.

``hashed_gather_cuda`` (``csrc/hashed_gather.cu``) replaces
``repro/kernels/hashed_gather/kernel.py::hashed_gather_pallas``.  The
library is built at first call (``kernels.build``) and loaded with
``ctypes``; a launch goes on PyTorch's current stream and does not
synchronise.  ``launches`` counts this process's launches by pool dtype
(each is its own instantiation of the kernel).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dequant_bag.kernel import _check

_DTYPE_CODE = {torch.int8: 0, torch.float32: 2}

launches = {"int8": 0, "float32": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def total_launches() -> int:
    return sum(launches.values())


@functools.cache
def _launcher():
    fn = build.load("hashed_gather").hashed_gather_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, i, p, p, p, p, ll, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def hashed_gather_cuda(pool: torch.Tensor, scales: torch.Tensor | None,
                       slots: torch.Tensor, coeff: torch.Tensor, *,
                       num_chunks: int) -> torch.Tensor:
    """Launch the kernel: pool (S, Z) fp32|int8, scales (S,) fp32 or None
    (unit scales), slots (B, C*T) int32 in [0, S), coeff (B, C*T) fp32
    -> (B, C*Z) fp32.  All on one CUDA device and contiguous; raises
    otherwise."""
    dev = pool.device
    if dev.type != "cuda":
        raise ValueError(f"hashed_gather_cuda needs CUDA tensors, got {dev}")
    if pool.dtype not in _DTYPE_CODE:
        raise TypeError(f"pool must be float32 or int8, got {pool.dtype}")
    _check("pool", pool, pool.dtype, 2, dev)
    _check("slots", slots, torch.int32, 2, dev)
    _check("coeff", coeff, torch.float32, 2, dev)
    if scales is not None:
        _check("scales", scales, torch.float32, 1, dev)
        if scales.shape[0] != pool.shape[0]:
            raise ValueError(f"scales has {scales.shape[0]} rows, pool "
                             f"{pool.shape[0]}")
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
                    b, num_chunks, t, z,
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hashed_gather launch failed: cudaError {rc} "
                           f"(B={b}, C={num_chunks}, T={t}, Z={z}, "
                           f"{pool.dtype})")
    launches[str(pool.dtype).removeprefix("torch.")] += 1
    return out
