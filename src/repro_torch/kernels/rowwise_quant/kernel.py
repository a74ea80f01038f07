"""The CUDA row-wise int8 quantizer bound to PyTorch.

``quantize_rowwise_cuda`` (``csrc/rowwise_quant.cu``) replaces
``repro/kernels/rowwise_quant/kernel.py::quantize_rowwise_pallas``.  The
library is built at first call (``kernels.build``) and loaded with
``ctypes``; a launch goes on PyTorch's current stream and does not
synchronise.  ``launches`` counts this process's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dequant_bag.kernel import _check

_MODE_CODE = {"narrow": 0, "full": 1}

launches = {"float32": 0}


def reset_launches() -> None:
    launches["float32"] = 0


def total_launches() -> int:
    return launches["float32"]


@functools.cache
def _launcher():
    fn = build.load("rowwise_quant").rowwise_quant_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, ll, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def quantize_rowwise_cuda(x: torch.Tensor, noise: torch.Tensor | None = None,
                          mode: str = "narrow", *, reciprocal: bool = False
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel: x (V, D) fp32 [+ noise (V, D) fp32], D >= 1, on
    one CUDA device and contiguous -> (q int8 (V, D), scale fp32 (V, 1));
    raises otherwise."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"quantize_rowwise_cuda needs CUDA tensors, got "
                         f"{dev}")
    if mode not in _MODE_CODE:
        raise ValueError(f"mode must be 'narrow' or 'full', got {mode!r}")
    _check("x", x, torch.float32, 2, dev)
    if noise is not None:
        _check("noise", noise, torch.float32, 2, dev)
        if noise.shape != x.shape:
            raise ValueError(f"noise {tuple(noise.shape)} != x "
                             f"{tuple(x.shape)}")
    v, d = x.shape
    if d < 1:
        raise ValueError("quantize_rowwise_cuda needs D >= 1")
    q = torch.empty((v, d), dtype=torch.int8, device=dev)
    scale = torch.empty((v, 1), dtype=torch.float32, device=dev)
    if v == 0:
        return q, scale
    launch = _launcher()
    with torch.cuda.device(dev):
        rc = launch(x.data_ptr(), None if noise is None else noise.data_ptr(),
                    q.data_ptr(), scale.data_ptr(), v, d, _MODE_CODE[mode],
                    int(reciprocal), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rowwise_quant launch failed: cudaError {rc} "
                           f"(V={v}, D={d}, {mode})")
    launches["float32"] += 1
    return q, scale
