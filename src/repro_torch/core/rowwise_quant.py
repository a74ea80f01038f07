"""Row-wise quantization / dequantization (SHARK Eq. 5-6).

Port of ``repro/core/rowwise_quant.py``:

    scale = max(max_abs(row), 1e-12) / denom                    (Eq. 6)
    e_q   = clip(round(e / scale), I_min, I_max)                (Eq. 5)
    e_dq  = scale * e_q

with ``denom = I_max`` ("narrow", the system default: idempotent, so the
packed store equals the snapped values exactly) or ``(I_max - I_min)/2``
("full", the literal Eq. 6).  The 2-byte tier normalises each row by its
max-abs and stores it in bf16 (IEEE fp16 with ``strict_fp16``).  Every op
is elementwise or a per-row max in fp32 and rounds half to even, so the
results are bit-identical to the reference.

The division by ``denom`` is IEEE on every device (``denominator``).
``reciprocal=True`` computes the scale as the reference's jitted train
step does: under ``jit`` XLA folds the division by the constant
``denom`` into a multiply by its fp32 reciprocal, which differs from the
division in the last bit for some rows.  The serving path (``pack``,
eager in the reference) divides.

Stochastic rounding (``draw=``, the training path) rounds up where a
uniform draw falls below the fraction, so E[sr(x)] = x.  The uniforms
come from a *draw source*: a ``torch.Generator`` (drawn on its device),
or any callable ``shape -> fp32 tensor of uniforms in [0, 1)``, through
which a test feeds the reference's ``jax.random.uniform`` draws.
"""

from __future__ import annotations

from typing import Callable, Literal, Union

import torch

_EPS = 1e-12

Uniform = Callable[[tuple], torch.Tensor]
Draw = Union[torch.Generator, Uniform]


def uniform_source(draw: Draw) -> Uniform:
    """A draw source as a callable ``shape -> uniforms in [0, 1)``."""
    if isinstance(draw, torch.Generator):
        return lambda shape: torch.rand(shape, generator=draw,
                                        device=draw.device)
    return draw


def meta_uniform(shape: tuple) -> torch.Tensor:
    """The draw source of a step traced on ``meta`` (a dry run): uniforms
    of ``shape`` with no values, where no generator can live."""
    return torch.empty(shape, dtype=torch.float32, device="meta")


def stochastic_round(x: torch.Tensor, draw: Draw) -> torch.Tensor:
    """Unbiased rounding: floor(x) + (u < frac(x)), u from ``draw``."""
    lo = torch.floor(x)
    u = uniform_source(draw)(tuple(x.shape)).to(x.device, x.dtype)
    return lo + (u < (x - lo)).to(x.dtype)


def int_range(bits: int) -> tuple[int, int]:
    """[I_min, I_max] for a signed b-bit integer type (paper Sec 3.2)."""
    return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1


def rowwise_scale(e: torch.Tensor, bits: int = 8,
                  mode: Literal["full", "narrow"] = "narrow", *,
                  reciprocal: bool = False) -> torch.Tensor:
    """Per-row scale, Eq. 6.  e: (..., D) -> scale: (..., 1) fp32."""
    imin, imax = int_range(bits)
    max_abs = e.abs().amax(dim=-1, keepdim=True).clamp_min(_EPS)
    denom = float(imax - imin) / 2.0 if mode == "full" else float(imax)
    if reciprocal:
        one = torch.ones((), dtype=torch.float32, device=e.device)
        return max_abs * (one / denom)
    return max_abs / denominator(denom, e.device)


def denominator(denom: float, device) -> torch.Tensor:
    """``denom`` as a 0-d fp32 tensor on ``device``, for an IEEE division.

    Divided by a Python number, a CUDA tensor is multiplied by the
    number's fp32 reciprocal instead (PyTorch's CUDA ``div`` takes that
    shortcut for a host scalar divisor), which differs from the division
    in the last bit for some rows; a tensor divisor is divided on every
    device.
    """
    return torch.full((), denom, dtype=torch.float32, device=device)


def quantize_rowwise(e: torch.Tensor, bits: int = 8, *,
                     draw: Draw | None = None,
                     mode: Literal["full", "narrow"] = "narrow",
                     reciprocal: bool = False
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise quantization: stochastic rounding with uniforms from
    ``draw`` when given, else round-to-nearest.

    Returns (q, scale): q int8 (int32 for widths above 8 bits), scale fp32
    of shape e.shape[:-1] + (1,).
    """
    imin, imax = int_range(bits)
    scale = rowwise_scale(e, bits, mode,
                          reciprocal=reciprocal).to(torch.float32)
    x = e.to(torch.float32) / scale
    r = torch.round(x) if draw is None else stochastic_round(x, draw)
    r = r.clamp_(imin, imax)
    return r.to(torch.int8 if bits <= 8 else torch.int32), scale


def dequantize_rowwise(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Eq. 5 second line: e_dq = scale * e_q."""
    return q.to(torch.float32) * scale


def fake_quant_rowwise(e: torch.Tensor, bits: int = 8, *,
                       draw: Draw | None = None,
                       mode: Literal["full", "narrow"] = "narrow",
                       reciprocal: bool = False) -> torch.Tensor:
    """Quantize-dequantize round trip in value space (QAT 'snap')."""
    return dequantize_rowwise(*quantize_rowwise(
        e, bits, draw=draw, mode=mode, reciprocal=reciprocal))


def half_scale(e: torch.Tensor) -> torch.Tensor:
    """Row-wise scale for the 2-byte tier: normalise rows to [-1, 1]."""
    return e.abs().amax(dim=-1, keepdim=True).clamp_min(_EPS).to(
        torch.float32)


def quantize_half(e: torch.Tensor, *, strict_fp16: bool = False,
                  scaled: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """2-byte tier (paper 'fp16'; bf16 unless strict_fp16)."""
    dtype = torch.float16 if strict_fp16 else torch.bfloat16
    if scaled:
        scale = half_scale(e)
        return (e.to(torch.float32) / scale).to(dtype), scale
    ones = torch.ones(e.shape[:-1] + (1,), dtype=torch.float32,
                      device=e.device)
    return e.to(dtype), ones


def dequantize_half(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def fake_quant_half(e: torch.Tensor, *, strict_fp16: bool = False,
                    scaled: bool = True) -> torch.Tensor:
    q, scale = quantize_half(e, strict_fp16=strict_fp16, scaled=scaled)
    return dequantize_half(q, scale)
