"""Adversarial inputs for the card checks of ``bag_grad`` and ``bag_matmul``.

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
"""

from __future__ import annotations

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
    n = shape[0] * shape[1]
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
