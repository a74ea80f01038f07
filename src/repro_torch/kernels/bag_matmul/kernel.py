"""The CUDA fused bag -> first-matmul kernel bound to PyTorch.

``bag_matmul_cuda`` (``csrc/bag_matmul.cu``) replaces
``repro/kernels/bag_matmul/kernel.py::bag_matmul_pallas``.  The library
is built at first call (``kernels.build``) and loaded with ``ctypes``; a
launch goes on PyTorch's current stream and does not synchronise.
``launches`` counts this process's launches by payload dtype (each dtype
is its own instantiation), so a run can show that its path went through
the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dequant_bag.kernel import _DTYPE_CODE, _check

MAX_DIM = 384            # the kernel's shared-memory row tile

launches = {str(dt).removeprefix("torch."): 0 for dt in _DTYPE_CODE}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def total_launches() -> int:
    return sum(launches.values())


@functools.cache
def _launcher():
    fn = build.load("bag_matmul").bag_matmul_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, i, p, p, p, p, p, ll, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def bag_matmul_cuda(payload: torch.Tensor, scales: torch.Tensor | None,
                    indices: torch.Tensor, weights: torch.Tensor,
                    w3: torch.Tensor, *, scale_after: bool = False
                    ) -> torch.Tensor:
    """Launch the kernel: payload (V, D) int8|bf16|fp16|fp32, scales (V,)
    fp32 or None, indices (B, K) int32 in [0, V), weights (B, K) fp32, w3
    (K, D, H) fp32 -> (B, H) fp32.  All on one CUDA device and
    contiguous, D <= 384; raises otherwise."""
    dev = payload.device
    if dev.type != "cuda":
        raise ValueError(f"bag_matmul_cuda needs CUDA tensors, got {dev}")
    if payload.dtype not in _DTYPE_CODE:
        raise TypeError("payload must be int8, bfloat16, float16 or "
                        f"float32, got {payload.dtype}")
    _check("payload", payload, payload.dtype, 2, dev)
    _check("indices", indices, torch.int32, 2, dev)
    _check("weights", weights, torch.float32, 2, dev)
    _check("w3", w3, torch.float32, 3, dev)
    b, k = indices.shape
    d = payload.shape[1]
    if weights.shape != indices.shape:
        raise ValueError(f"weights {tuple(weights.shape)} != indices "
                         f"{tuple(indices.shape)}")
    if w3.shape[:2] != (k, d):
        raise ValueError(f"w3 {tuple(w3.shape)} does not match K={k}, D={d}")
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"bag_matmul_cuda takes 1 <= D <= {MAX_DIM}, "
                         f"got {d}")
    if scales is not None:
        _check("scales", scales, torch.float32, 1, dev)
        if scales.shape[0] != payload.shape[0]:
            raise ValueError(f"scales has {scales.shape[0]} rows, payload "
                             f"{payload.shape[0]}")
    h = w3.shape[2]
    out = torch.empty((b, h), dtype=torch.float32, device=dev)
    if b == 0 or h == 0:
        return out
    launch = _launcher()
    with torch.cuda.device(dev):
        rc = launch(
            payload.data_ptr(), _DTYPE_CODE[payload.dtype],
            None if scales is None else scales.data_ptr(),
            indices.data_ptr(), weights.data_ptr(), w3.data_ptr(),
            out.data_ptr(), b, k, d, h, int(bool(scale_after)),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bag_matmul launch failed: cudaError {rc} "
                           f"(B={b}, K={k}, D={d}, H={h}, {payload.dtype})")
    launches[str(payload.dtype).removeprefix("torch.")] += 1
    return out
