"""Int8 gradient compression with error feedback (beyond the paper).

Port of ``repro/optim/grad_compress.py``.  SHARK's row-wise quantizer
(Eq. 5-6) compresses the wire format of the data-parallel gradient
exchange: each shard quantizes its gradient in 256-element blocks to int8
with one fp32 scale a block (``kernels.rowwise_quant``: ``rowwise_quant.cu``
on a CUDA tensor, its plain version on a CPU one), every shard's payload
and scales are all-gathered (~0.26x the bytes of an fp32 all-reduce), and
each device dequantizes and sums them.  The quantization error is fed
into the next step's gradient (error feedback; Karimireddy et al. 2019).

``error_feedback_allreduce`` is the single-controller form of the
reference's ``shard_map`` body: it takes one gradient and one residual a
shard of a ``dist.Mesh`` and returns the mean and the new residual a
shard.  Each device holding a shard receives every shard's payload
(copied there: the all-gather) and sums the W dequantized payloads in
shard order, the reference's ``all_gather`` then ``.sum(axis=0)``.

``compress_int8`` / ``decompress_int8`` compute what the reference's
eager calls compute: the scale divides by 127, a dequantized element is
the rounded product ``q * s``.  ``error_feedback_allreduce`` computes what
XLA makes of the reference's jitted ``shard_map`` body: the scale
multiplies by fp32(1/127) (``reciprocal=True``), the new residual is
``fma(-q, s, corrected)`` and the sum over shards a chain of
``fma(q_w, s_w, acc)`` from ``q_0 * s_0`` (XLA fuses them).  An fma is
taken in float64 (the product of an int8 and an fp32 is exact there),
as the port's plain versions emulate their kernels' FMAs.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import op_counter
from repro_torch.core import rowwise_quant as rq
from repro_torch.dist.mesh import Mesh, check_mesh
from repro_torch.kernels.rowwise_quant.ops import quantize_rowwise

_BLOCK = 256


def _pad_to_blocks(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % _BLOCK
    if pad:
        flat = torch.cat([flat, torch.zeros((pad,), dtype=flat.dtype,
                                            device=flat.device)])
    return flat.reshape(-1, _BLOCK), pad


def compress_int8(g: torch.Tensor, *, reciprocal: bool = False
                  ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """g -> (int8 blocks (N, 256), scales (N, 1) fp32, pad)."""
    blocks, pad = _pad_to_blocks(g.to(torch.float32))
    q, scale = quantize_rowwise(blocks.contiguous(), reciprocal=reciprocal)
    return q, scale, pad


def decompress_int8(q: torch.Tensor, scale: torch.Tensor, pad: int,
                    shape) -> torch.Tensor:
    deq = rq.dequantize_rowwise(q, scale).reshape(-1)
    if pad:
        deq = deq[:-pad]
    return deq.reshape(shape)


def error_feedback_allreduce(grads: Sequence[torch.Tensor],
                             residuals: Sequence[torch.Tensor], mesh: Mesh,
                             axis: str = "model"
                             ) -> tuple[list[torch.Tensor],
                                        list[torch.Tensor]]:
    """Compressed mean all-reduce of one gradient a shard of ``mesh``.

    ``grads[i]`` and ``residuals[i]`` live on ``mesh.devices[i]``.
    Returns (the mean a shard, on its device; the new residual a shard,
    ``corrected - dequant(quant(corrected))``).  Shards on one device
    share that device's mean.
    """
    w = check_mesh(mesh, axis)
    if len(grads) != w or len(residuals) != w:
        raise ValueError(f"{len(grads)} gradients / {len(residuals)} "
                         f"residuals for a mesh of {w}")
    shape = grads[0].shape
    payloads, new_res = [], []
    for g, r in zip(grads, residuals):
        corrected = g + r
        q, scale, pad = compress_int8(corrected, reciprocal=True)
        prod = _product64(q, scale, pad)
        new_res.append((corrected.to(torch.float64).reshape(-1) - prod)
                       .to(torch.float32).reshape(shape))
        payloads.append((q, scale))

    # all-gather: every shard's int8 payload and scales on each device
    q0, s0 = payloads[0]
    op_counter.report_collective(
        "all-gather", w * w * (q0.numel() * q0.element_size()
                               + s0.numel() * s0.element_size()))
    means = {}
    for dev in mesh.distinct_devices():
        acc = None
        for q, scale in payloads:
            prod = _product64(q.to(dev), scale.to(dev), pad)
            acc = (prod if acc is None else acc.to(torch.float64) + prod
                   ).to(torch.float32)
        means[dev] = acc.reshape(shape) / w
    return [means[d] for d in mesh.devices], new_res


def _product64(q: torch.Tensor, scale: torch.Tensor, pad: int
               ) -> torch.Tensor:
    """``q * scale`` exact in float64, flat, without the pad."""
    prod = (q.to(torch.float64) * scale.to(torch.float64)).reshape(-1)
    return prod[:-pad] if pad else prod
