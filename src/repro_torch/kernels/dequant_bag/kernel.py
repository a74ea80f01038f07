"""The CUDA dequant-bag kernels bound to PyTorch.

``dequant_bag_cuda`` (``csrc/dequant_bag.cu``) replaces
``repro/kernels/dequant_bag/kernel.py::dequant_bag_pallas``;
``bag_grad_cuda`` (``csrc/bag_grad.cu``) replaces ``bag_grad_pallas``,
its scatter-add backward.  Each library is built at first call
(``kernels.build``) and loaded with ``ctypes``; a launch goes on
PyTorch's current stream and does not synchronise.  ``launches`` counts
the dequant-bag launches this process made, by payload dtype (each dtype
is its own instantiation of the kernel), and ``bag_grad_launches`` the
backward's, so a run can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DTYPE_CODE = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2,
               torch.float16: 3}

launches = {str(dt).removeprefix("torch."): 0 for dt in _DTYPE_CODE}
bag_grad_launches = {"float32": 0}


def reset_launches() -> None:
    for counts in (launches, bag_grad_launches):
        for key in counts:
            counts[key] = 0


def total_launches() -> int:
    return sum(launches.values())


@functools.cache
def _launcher():
    fn = build.load("dequant_bag").dequant_bag_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, i, p, p, p, p, ll, i, ll, i, p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, dtype, ndim: int,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype or t.dim() != ndim:
        raise TypeError(f"{name} must be a {ndim}-d {dtype} tensor, got "
                        f"{t.dim()}-d {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def dequant_bag_cuda(payload: torch.Tensor, scales: torch.Tensor | None,
                     indices: torch.Tensor, weights: torch.Tensor
                     ) -> torch.Tensor:
    """Launch the kernel: payload (V, D) int8|bf16|fp16|fp32, scales (V,) fp32
    or None, indices (B, K) int32 in [0, V), weights (B, K) fp32 -> (B, D)
    fp32.  All on one CUDA device and contiguous; raises otherwise."""
    dev = payload.device
    if dev.type != "cuda":
        raise ValueError(f"dequant_bag_cuda needs CUDA tensors, got {dev}")
    if payload.dtype not in _DTYPE_CODE:
        raise TypeError("payload must be int8, bfloat16, float16 or "
                        "float32, got "
                        f"{payload.dtype}")
    _check("payload", payload, payload.dtype, 2, dev)
    _check("indices", indices, torch.int32, 2, dev)
    _check("weights", weights, torch.float32, 2, dev)
    if weights.shape != indices.shape:
        raise ValueError(f"weights {tuple(weights.shape)} != indices "
                         f"{tuple(indices.shape)}")
    if scales is not None:
        _check("scales", scales, torch.float32, 1, dev)
        if scales.shape[0] != payload.shape[0]:
            raise ValueError(f"scales has {scales.shape[0]} rows, payload "
                             f"{payload.shape[0]}")
    b, k = indices.shape
    d = payload.shape[1]
    out = torch.empty((b, d), dtype=torch.float32, device=dev)
    if b == 0 or d == 0:
        return out
    itemsize = payload.element_size()
    vec = 16 // itemsize if ((d * itemsize) % 16 == 0
                             and payload.data_ptr() % 16 == 0) else 1
    launch = _launcher()
    with torch.cuda.device(dev):
        rc = launch(
            payload.data_ptr(), _DTYPE_CODE[payload.dtype],
            None if scales is None else scales.data_ptr(),
            indices.data_ptr(), weights.data_ptr(), out.data_ptr(),
            b, k, d, vec, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dequant_bag launch failed: cudaError {rc} "
                           f"(B={b}, K={k}, D={d}, {payload.dtype})")
    launches[str(payload.dtype).removeprefix("torch.")] += 1
    return out


@functools.cache
def _grad_launcher():
    fn = build.load("bag_grad").bag_grad_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, p, ll, i, ll, i, p]
    fn.restype = ctypes.c_int
    return fn


def bag_grad_cuda(g: torch.Tensor, indices: torch.Tensor,
                  coeff: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Launch the scatter-add backward into ``out`` and return it.

    g (B, D) fp32, indices (B, K) int32 in [0, V), coeff (B, K) fp32,
    out (V, D) fp32 and zero on entry (the caller's zero fill, the
    reference's aliased zeros operand): every touched row of ``out`` is
    overwritten with its (b, k)-ordered FMA sum.  All on one CUDA device
    and contiguous; raises otherwise.  The slots are grouped by row with
    one stable sort here; the kernel does the accumulation.
    """
    dev = g.device
    if dev.type != "cuda":
        raise ValueError(f"bag_grad_cuda needs CUDA tensors, got {dev}")
    _check("g", g, torch.float32, 2, dev)
    _check("indices", indices, torch.int32, 2, dev)
    _check("coeff", coeff, torch.float32, 2, dev)
    _check("out", out, torch.float32, 2, dev)
    if coeff.shape != indices.shape or indices.shape[0] != g.shape[0]:
        raise ValueError(f"indices {tuple(indices.shape)}, coeff "
                         f"{tuple(coeff.shape)} and g {tuple(g.shape)} "
                         "disagree")
    if out.shape[1] != g.shape[1]:
        raise ValueError(f"out has {out.shape[1]} columns, g {g.shape[1]}")
    b, k = indices.shape
    d = g.shape[1]
    n = b * k
    if n == 0 or d == 0:
        return out
    rows, slots = torch.sort(indices.reshape(-1), stable=True)
    vec = next(v for v in (4, 2, 1)
               if d % v == 0 and (v < 4 or d >= 128)
               and g.data_ptr() % (4 * v) == 0
               and out.data_ptr() % (4 * v) == 0)
    launch = _grad_launcher()
    with torch.cuda.device(dev):
        rc = launch(g.data_ptr(), rows.data_ptr(), slots.data_ptr(),
                    coeff.data_ptr(), out.data_ptr(), n, k, d, vec,
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bag_grad launch failed: cudaError {rc} "
                           f"(B={b}, K={k}, D={d}, V={out.shape[0]})")
    bag_grad_launches["float32"] += 1
    return out
