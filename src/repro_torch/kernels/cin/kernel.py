"""The CUDA CIN-layer kernel bound to PyTorch.

``cin_layer_cuda`` (``csrc/cin.cu``) replaces
``repro/kernels/cin/kernel.py::cin_layer_pallas``.  The library is built
at first call (``kernels.build``) and loaded with ``ctypes``; a launch
goes on PyTorch's current stream and does not synchronise.  ``launches``
counts this process's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dequant_bag.kernel import _check

MAX_DIM = 128            # one (sample, d) pair per thread of a block

launches = {"float32": 0}


def reset_launches() -> None:
    launches["float32"] = 0


def total_launches() -> int:
    return launches["float32"]


@functools.cache
def _launcher():
    fn = build.load("cin").cin_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, ll, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def cin_layer_cuda(w: torch.Tensor, x_k: torch.Tensor, x_0: torch.Tensor
                   ) -> torch.Tensor:
    """Launch the kernel: w (O, H, M), x_k (B, H, D), x_0 (B, M, D), fp32,
    on one CUDA device and contiguous, D <= 128 -> (B, O, D) fp32;
    raises otherwise."""
    dev = x_k.device
    if dev.type != "cuda":
        raise ValueError(f"cin_layer_cuda needs CUDA tensors, got {dev}")
    _check("w", w, torch.float32, 3, dev)
    _check("x_k", x_k, torch.float32, 3, dev)
    _check("x_0", x_0, torch.float32, 3, dev)
    o, h, m = w.shape
    b, _, d = x_k.shape
    if x_k.shape[1] != h or x_0.shape != (b, m, d):
        raise ValueError(f"w {tuple(w.shape)}, x_k {tuple(x_k.shape)} and "
                         f"x_0 {tuple(x_0.shape)} disagree")
    if not 1 <= d <= MAX_DIM or m < 1:
        raise ValueError(f"cin_layer_cuda takes 1 <= D <= {MAX_DIM} and "
                         f"M >= 1, got D={d}, M={m}")
    out = torch.empty((b, o, d), dtype=torch.float32, device=dev)
    if b == 0 or o == 0:
        return out
    launch = _launcher()
    with torch.cuda.device(dev):
        rc = launch(w.data_ptr(), x_k.data_ptr(), x_0.data_ptr(),
                    out.data_ptr(), b, o, h, m, d,
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cin launch failed: cudaError {rc} "
                           f"(B={b}, O={o}, H={h}, M={m}, D={d})")
    launches["float32"] += 1
    return out
