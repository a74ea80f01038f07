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
    fn.argtypes = [p, i, p, p, p, p, p, ll, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


# The tiling (block_b, block_h): bags and outputs a block, 32 x 64 (2 x 4
# outputs a thread) or 32 x 32 (2 x 2); (0, 0) is the analytic pick (32 x
# 64 unless that grid leaves SMs without a block).  One thread owns each
# output and its whole (k, d) reduction, so both are bit-equal.
TILE_B = 32
H100_SMS = 132          # the plain versions' stand-in for the card's SMs


def bag_matmul_analytic(b: int, h: int, device: torch.device | None = None
                        ) -> tuple[int, int]:
    """The analytic tiling at (B, H): on CUDA the kernel's own rule for
    ``device`` (``bag_matmul_tiling``), elsewhere its mirror for an H100's
    132 SMs."""
    if device is not None and torch.device(device).type == "cuda":
        from repro_torch.kernels.dequant_bag.kernel import _tiling_query
        with torch.cuda.device(device):
            return _tiling_query("bag_matmul", "bag_matmul_tiling",
                                 ctypes.c_longlong(b), ctypes.c_int(h))
    wide = -(-b // TILE_B) * -(-h // 64)
    return TILE_B, 64 if wide >= H100_SMS else 32


def bag_matmul_tilings(b: int = 0, h: int = 0) -> list[tuple[int, int]]:
    """The built tilings."""
    return [(TILE_B, 64), (TILE_B, 32)]


def bag_matmul_cuda(payload: torch.Tensor, scales: torch.Tensor | None,
                    indices: torch.Tensor, weights: torch.Tensor,
                    w3: torch.Tensor, *, scale_after: bool = False,
                    tiling: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Launch the kernel: payload (V, D) int8|bf16|fp16|fp32, scales (V,)
    fp32 or None, indices (B, K) int32 in [0, V), weights (B, K) fp32, w3
    (K, D, H) fp32 -> (B, H) fp32, at ``tiling`` ((0, 0): the analytic
    pick; an unbuilt tiling raises).  All on one CUDA device and
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
            int(tiling[0]), int(tiling[1]),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bag_matmul launch failed: cudaError {rc} "
                           f"(B={b}, K={k}, D={d}, H={h}, {payload.dtype}, "
                           f"tiling {tuple(tiling)})")
    launches[str(payload.dtype).removeprefix("torch.")] += 1
    return out
