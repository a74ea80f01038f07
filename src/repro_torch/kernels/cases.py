"""Adversarial inputs for the card checks of ``bag_grad``, ``bag_matmul``,
``cin`` and ``rowwise_quant``.

``chip_smoke.py`` (phase 2) and ``tests/test_torch_cuda.py`` hold the
kernels to their plain versions on these, bit for bit.  The inputs are
drawn from a ``torch.Generator`` on the given device, so both callers see
the same numbers; nothing here launches a kernel.

``bag_grad_cases`` aims at the scatter's schedule: one row holding every
slot; runs of exactly ``heavy`` slots (the longest a group of lanes
walks) and one either side, and of 16 * ``heavy`` (the longest that is not
listed first) and one more; a long run with zero coefficients and a NaN
cotangent under them (the zeros must be skipped); D in {1, 8, 10, 64,
128} with ``g`` and ``out`` a float off 16-byte alignment.
``bag_matmul_cases`` covers B in {1, 31, 512, 513}, K in {1, 39, 40}, D
in {1, 10, 32, 384} and H in {1, 63, 400, 1024}, and all-dead fields
with a NaN in ``w3`` under a dead slot (every slot is multiplied, so the
NaN reaches its column).
``cin_cases`` aims at the CIN kernel's 200 (o) x 40 (n) tiles and
32-deep k chunks: O of 17 (one partial o tile), 200 (one full tile), 201
(a second tile of one row) and 400 (two full tiles); a sample's columns
split across n tiles (D = 6, as 40 is no multiple of 6, and D = 128,
which spans four tiles; D = 10 divides 40, so its samples never
straddle); H * M of 72 (9 x 8), 1,521 and 7,800 (ragged last chunks);
H = M = 1; W one float off 16-byte alignment at H * M = 72 (a multiple
of 4, so only the pointer sends it to the shifted W reads); and a NaN in
W (its output channel NaN in both).
``quant_cases`` aims at the quantizer's vector, scalar and wide-row
paths: D in {64, 32, 10, 8, 3, 68, 133} at V = 1001 (no block's rows
divide it), each with an all-zero row (the 1e-12 floor), a row of exact
.5 multiples of its scale (half to even), and NaN, inf and all -inf rows
beside finite rows of the same warp step; and x or noise one float off
16-byte alignment (views a caller can pass), which take the scalar path.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class GradCase(NamedTuple):
    name: str
    g: torch.Tensor          # (B, D) fp32
    indices: torch.Tensor    # (B, K) int32
    coeff: torch.Tensor      # (B, K) fp32
    vocab: int
    out: torch.Tensor        # (vocab, D) fp32 zeros, maybe misaligned


def _off_aligned(shape, device) -> torch.Tensor:
    """Zeros of ``shape``, contiguous, one float past 16-byte alignment."""
    n = math.prod(shape)
    return torch.zeros(n + 1, device=device)[1:].view(shape)


def _runs(lengths, k: int, gen, device) -> torch.Tensor:
    """(B, K) int32 indices in which row r holds ``lengths[r]`` slots, the
    slots of all rows shuffled together; B * K = sum(lengths)."""
    rows = torch.repeat_interleave(
        torch.arange(len(lengths), device=device),
        torch.tensor(lengths, device=device))
    perm = torch.randperm(rows.numel(), generator=gen, device=device)
    return rows[perm].to(torch.int32).reshape(-1, k)


def bag_grad_cases(device, heavy: int) -> list[GradCase]:
    gen = torch.Generator(device=device)
    gen.manual_seed(16)
    cases = []

    def add(name, idx, d, vocab, coeff=None, misaligned=False):
        b, k = idx.shape
        g = torch.randn((b, d), generator=gen, device=device)
        if misaligned:
            g = _off_aligned((b, d), device).copy_(g)
        if coeff is None:
            coeff = torch.rand((b, k), generator=gen, device=device) + 0.5
        out = (_off_aligned((vocab, d), device) if misaligned else
               torch.zeros((vocab, d), device=device))
        cases.append(GradCase(name, g, idx, coeff, vocab, out))

    # one row holds all 65,536 slots
    add("one_row", torch.full((65_536, 1), 3, dtype=torch.int32,
                              device=device), 64, 7,
        coeff=torch.ones((65_536, 1), device=device))
    # runs at the group / block boundary and at the front-list boundary,
    # among short ones
    big = 16 * heavy
    lengths = [heavy - 1, heavy, heavy + 1, big, big + 1, 1, 2, 3, 31, 32,
               33, 64]
    lengths.append(sum(lengths) % 2 or 2)           # an even slot count
    for d in (64, 8):
        add(f"threshold_d{d}", _runs(lengths, 2, gen, device), d,
            len(lengths))
    # a long run with 30% zero coefficients; one bag's cotangent is NaN
    # and both its coefficients are zero
    idx = _runs([3000, 500, 7, 1, 300], 2, gen, device)
    b = idx.shape[0]
    coeff = torch.rand((b, 2), generator=gen, device=device) + 0.5
    coeff[torch.rand((b, 2), generator=gen, device=device) < 0.3] = 0.0
    hot = int(torch.nonzero(idx[:, 0] == 0)[0])
    coeff[hot] = 0.0
    add("zeros_nan", idx, 64, 5, coeff=coeff)
    cases[-1].g[hot] = float("nan")
    # widths, with g and out off 16-byte alignment
    for d in (1, 8, 10, 64, 128):
        lengths = [1000, heavy + 1, heavy] + [1 + i % 7 for i in range(400)]
        lengths.append(sum(lengths) % 2)
        add(f"misaligned_d{d}", _runs([x for x in lengths if x], 2, gen,
                                      device), d, len(lengths),
            misaligned=True)
    return cases


class MatmulCase(NamedTuple):
    name: str
    payload: torch.Tensor     # (V, D)
    scales: torch.Tensor      # (V,) fp32
    indices: torch.Tensor     # (B, K) int32
    weights: torch.Tensor     # (B, K) fp32
    w3: torch.Tensor          # (K, D, H) fp32


# (B, K, D, H): every B, K, D and H of the docstring at least twice
MATMUL_SHAPES = ((1, 1, 1, 1), (31, 39, 10, 63), (512, 40, 32, 1024),
                 (513, 39, 10, 400), (513, 1, 384, 1024), (31, 40, 384, 1),
                 (1, 39, 32, 400), (512, 1, 1, 63))


def _payload(dtype, v, d, gen, device) -> torch.Tensor:
    if dtype == torch.int8:
        return torch.randint(-128, 128, (v, d), generator=gen, device=device,
                             dtype=torch.int8)
    return (torch.randn((v, d), generator=gen, device=device) * 0.1
            ).to(dtype)


def bag_matmul_cases(device, dtype) -> list[MatmulCase]:
    gen = torch.Generator(device=device)
    gen.manual_seed(17)
    v = 999
    cases = []
    for b, k, d, h in MATMUL_SHAPES:
        idx = torch.randint(0, v, (b, k), generator=gen, device=device,
                            dtype=torch.int32)
        w = torch.rand((b, k), generator=gen, device=device)
        w[torch.rand((b, k), generator=gen, device=device) < 0.3] = 0.0
        cases.append(MatmulCase(
            f"b{b}_k{k}_d{d}_h{h}", _payload(dtype, v, d, gen, device),
            torch.rand(v, generator=gen, device=device) * 0.01, idx, w,
            torch.randn((k, d, h), generator=gen, device=device)))
    # fields 2 and 5 dead in every bag; a NaN in w3 under field 5
    b, k, d, h = 64, 8, 10, 70
    idx = torch.randint(0, v, (b, k), generator=gen, device=device,
                        dtype=torch.int32)
    w = torch.rand((b, k), generator=gen, device=device) + 0.5
    w[:, 2] = w[:, 5] = 0.0
    w3 = torch.randn((k, d, h), generator=gen, device=device)
    w3[5, 3, 7] = float("nan")
    cases.append(MatmulCase("dead_fields_nan_w3",
                            _payload(dtype, v, d, gen, device),
                            torch.rand(v, generator=gen, device=device)
                            * 0.01, idx, w, w3))
    return cases


class CinCase(NamedTuple):
    name: str
    w: torch.Tensor           # (O, H, M) fp32
    xk: torch.Tensor          # (B, H, D) fp32
    x0: torch.Tensor          # (B, M, D) fp32


# (B, O, H, M, D)
CIN_SHAPES = ((13, 17, 9, 8, 6),        # O < a tile, K = 72, D = 6 straddles
              (70, 200, 39, 39, 10),    # 700 columns: a last n tile of 20
              (3, 17, 200, 39, 10),     # K = 7,800: a last chunk of 24
              (5, 3, 1, 1, 128),        # H = M = 1, D = 128
              (3, 200, 1, 1, 10),       # H = M = 1, O = 200
              (2, 70, 20, 39, 128),     # D = 128: a sample over four tiles
              (7, 201, 9, 8, 10),       # a second o tile of one row
              (5, 400, 39, 39, 6))      # two full o tiles, K = 1,521
CIN_CASE_NAMES = tuple(f"b{b}_o{o}_h{h}_m{m}_d{d}"
                       for b, o, h, m, d in CIN_SHAPES) + ("w_off_k72",
                                                           "nan_w")


def cin_cases(device) -> list[CinCase]:
    gen = torch.Generator(device=device)
    gen.manual_seed(18)
    cases = []

    def add(name, b, o, h, m, d):
        w = torch.randn((o, h, m), generator=gen, device=device) / (
            h * m) ** 0.5
        xk = torch.randn((b, h, d), generator=gen, device=device)
        x0 = torch.randn((b, m, d), generator=gen, device=device)
        cases.append(CinCase(name, w, xk, x0))

    for b, o, h, m, d in CIN_SHAPES:
        add(f"b{b}_o{o}_h{h}_m{m}_d{d}", b, o, h, m, d)
    # K = 72 is a multiple of 4, but W lies one float off alignment
    add("w_off_k72", 9, 200, 9, 8, 10)
    w = cases[-1].w
    cases[-1] = cases[-1]._replace(w=_off(w))
    # a NaN in W: output channel 5 is NaN for every (b, d)
    add("nan_w", 6, 200, 39, 39, 10)
    cases[-1].w[5, 3, 7] = float("nan")
    return cases


class QuantCase(NamedTuple):
    name: str
    x: torch.Tensor           # (V, D) fp32, maybe off alignment
    noise: torch.Tensor       # (V, D) fp32 uniforms, maybe off alignment


QUANT_DIMS = (64, 32, 10, 8, 3, 68, 133)
QUANT_OFF_DIMS = (64, 8)
QUANT_CASE_NAMES = (tuple(f"d{d}" for d in QUANT_DIMS)
                    + tuple(f"{what}_off_d{d}" for d in QUANT_OFF_DIMS
                            for what in ("x", "noise")))


def _quant_rows(v: int, d: int, gen, device) -> torch.Tensor:
    x = torch.randn((v, d), generator=gen, device=device) * (
        torch.rand((v, 1), generator=gen, device=device) * 10 + 1e-3)
    x[1] = 0.0                            # the 1e-12 floor
    half = (torch.arange(d, device=device) % 9 - 4).float() + 0.5
    x[2] = half * 0.25                    # exact .5 multiples of 0.25
    x[2, 0] = 127 * 0.25
    # non-finite rows beside finite rows of the same warp step
    x[5, d // 2] = float("nan")
    x[6, d - 1] = float("inf")
    x[9] = -float("inf")
    x[10, 0] = float("nan")
    x[10, d - 1] = -float("inf")
    return x


def _off(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t``, contiguous, one float past 16-byte alignment."""
    return _off_aligned(t.shape, t.device).copy_(t)


def quant_cases(device) -> list[QuantCase]:
    gen = torch.Generator(device=device)
    gen.manual_seed(19)
    v = 1001
    cases = []
    for d in QUANT_DIMS:
        x = _quant_rows(v, d, gen, device)
        noise = torch.rand((v, d), generator=gen, device=device)
        cases.append(QuantCase(f"d{d}", x, noise))
    for d in QUANT_OFF_DIMS:
        x = _quant_rows(v, d, gen, device)
        noise = torch.rand((v, d), generator=gen, device=device)
        cases.append(QuantCase(f"x_off_d{d}", _off(x), noise))
        cases.append(QuantCase(f"noise_off_d{d}", x, _off(noise)))
    return cases

