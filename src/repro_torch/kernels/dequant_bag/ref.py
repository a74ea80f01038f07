"""Plain PyTorch version of the fused dequant embedding-bag.

The kernel (``kernel.py``) is held to this bit for bit, so it follows the
kernel's contract rather than the shortest expression: it loops over k in
order, skips zero-weight slots, and accumulates

    acc = fma(row * scale, weight, acc)

that is, the scale product rounded on its own and the weight product and
the sum rounded once together.  That is what the reference kernel
computes where its tests run it (Pallas interpret mode: XLA on the CPU
fuses its ``out += (row * s) * w`` into that FMA), and the CUDA kernel
writes the same FMA explicitly.  Torch has no fp32 FMA op, so
``fma_f32`` computes one exactly in float64.  Runs on any device; the CPU
tests use it and ``chip_smoke.py`` compares the kernel with it on the
card.

``bag_grad_ref`` is the plain version of the scatter-add backward
(``csrc/bag_grad.cu``): each row's gradient is the FMA chain of its
slots' ``coeff * g[b]`` in (b, k) order, as the reference kernel
accumulates it.

``dequant_bag_rowgrid_ref`` and ``bag_grad_rowgrid_ref`` are the plain
versions of the (B, K)-grid tiling oracles (``csrc/dequant_bag_rowgrid.cu``,
``csrc/bag_grad_rowgrid.cu``), whatever schedule the kernels run on the
card.  They compute the same FMA chains with one difference each kernel
keeps from the reference: the dequant oracle reads
every slot, zero weights included, so a NaN or inf row in a zero-weight
slot turns its bag to NaN where the tiled kernel skips it; the scatter
oracle skips ``c == 0`` slots as the tiled kernel does.
"""

from __future__ import annotations

import torch


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """fp32 ``a * b + c`` with one rounding, exactly.

    ``a * b`` of two fp32 values is exact in float64 (48 of 53 bits).  The
    float64 sum is made round-to-odd (its rounding error, from TwoSum,
    sets the last bit), and a round-to-odd float64 rounds to the
    correctly rounded fp32 because 53 >= 2 * 24 + 2.
    """
    p = a.double() * b.double()
    q = c.double()
    s = p + q
    bb = s - p
    err = (p - (s - bb)) + (q - bb)
    sb = s.view(torch.int64)
    inexact = (err != 0) & ((sb & 1) == 0) & torch.isfinite(s)
    toward = torch.where((err > 0) == (s > 0), 1, -1)
    return torch.where(inexact, sb + toward, sb).view(torch.float64).float()


def dequant_bag_ref(payload: torch.Tensor, scales: torch.Tensor | None,
                    indices: torch.Tensor, weights: torch.Tensor
                    ) -> torch.Tensor:
    """payload (V, D) int8|bf16|fp16|fp32, scales (V,) fp32 or None (unit
    scales), indices (B, K) in [0, V), weights (B, K) fp32 -> (B, D) fp32:

        out[b] = sum_k (f32(payload[i_bk]) * scale[i_bk]) * w_bk

    summed over k in order as ``fma(row * s, w, acc)``, skipping slots
    with w_bk == 0.
    """
    b, k = indices.shape
    idx = indices.to(torch.int64)
    w = weights.to(torch.float32)
    acc = torch.zeros((b, payload.shape[1]), dtype=torch.float32,
                      device=payload.device)
    for kk in range(k):
        rows = payload[idx[:, kk]].to(torch.float32)
        if scales is not None:
            rows = rows * scales[idx[:, kk]][:, None]
        wk = w[:, kk][:, None]
        acc = torch.where(wk != 0, fma_f32(rows, wk.expand_as(rows), acc),
                          acc)
    return acc


def bag_grad_coeff(scales: torch.Tensor | None, indices: torch.Tensor,
                   weights: torch.Tensor | None) -> torch.Tensor:
    """Per-slot coefficient ``w * scale[idx]``, rounded to fp32: (B, K).

    The reference computes it outside its kernel (``kernel.py:429-432``);
    ``weights=None`` means unit weights, ``scales=None`` unit scales.
    """
    coeff = (torch.ones(indices.shape, dtype=torch.float32,
                        device=indices.device)
             if weights is None else weights.to(torch.float32))
    if scales is not None:
        coeff = coeff * scales[indices.to(torch.int64)]
    return coeff


def bag_grad_ref(g: torch.Tensor, scales: torch.Tensor | None,
                 indices: torch.Tensor, weights: torch.Tensor | None,
                 vocab: int, out: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """g (B, D) fp32, indices (B, K) in [0, vocab) -> dtable (vocab, D):

        dtable[i] = fma(c_n, g[b_n], ... fma(c_1, g[b_1], 0))

    over the slots (b, k) with idx[b, k] == i in lexicographic order,
    where c = ``bag_grad_coeff`` and slots with c == 0 are skipped; rows
    no slot touches stay zero.  ``out`` (vocab, D) fp32, when given, is
    accumulated onto in place: each chain starts from ``out[i]`` instead of
    0, and untouched rows keep their values.

    Vectorised by depth: live slots are stably sorted by row, each gets
    its rank within its row, and one FMA step per rank updates every row
    that has a slot of that rank (the rows of one rank are distinct).
    The loop runs as many times as the longest row's slot count.
    """
    b, k = indices.shape
    d = g.shape[1]
    if out is None:
        out = torch.zeros((vocab, d), dtype=torch.float32, device=g.device)
    coeff = bag_grad_coeff(scales, indices, weights).reshape(-1)
    live = torch.nonzero(coeff != 0).reshape(-1)
    if live.numel() == 0:
        return out
    rows, order = torch.sort(indices.reshape(-1)[live].to(torch.int64),
                             stable=True)
    slot = live[order]                       # (b, k) order within a row
    pos = torch.arange(rows.numel(), device=g.device)
    head = torch.ones_like(rows, dtype=torch.bool)
    head[1:] = rows[1:] != rows[:-1]
    rank = pos - torch.cummax(torch.where(head, pos, 0), 0).values
    by_rank = torch.sort(rank, stable=True).indices
    rows, slot = rows[by_rank], slot[by_rank]
    c = coeff[slot][:, None]
    gb = g.to(torch.float32)
    s = 0
    for n in torch.bincount(rank).tolist():
        r, sl = rows[s:s + n], slot[s:s + n]
        out[r] = fma_f32(c[s:s + n], gb[sl // k], out[r])
        s += n
    return out


def dequant_bag_rowgrid_ref(payload: torch.Tensor,
                            scales: torch.Tensor | None,
                            indices: torch.Tensor, weights: torch.Tensor
                            ) -> torch.Tensor:
    """The (B, K)-grid oracle of ``dequant_bag_ref``
    (``repro/kernels/dequant_bag/kernel.py:213-261``): the same
    ``acc = fma(row * s, w, acc)`` over k in order, but every slot is
    read, zero weights included.  On finite rows it equals
    ``dequant_bag_ref`` bit for bit (``x * 0`` adds a zero to a sum that
    is never -0); a NaN or inf row in a zero-weight slot makes its bag
    NaN."""
    b, k = indices.shape
    idx = indices.to(torch.int64)
    w = weights.to(torch.float32)
    acc = torch.zeros((b, payload.shape[1]), dtype=torch.float32,
                      device=payload.device)
    for kk in range(k):
        rows = payload[idx[:, kk]].to(torch.float32)
        if scales is not None:
            rows = rows * scales[idx[:, kk]][:, None]
        acc = fma_f32(rows, w[:, kk][:, None].expand_as(rows), acc)
    return acc


def bag_grad_rowgrid_ref(g: torch.Tensor, scales: torch.Tensor | None,
                         indices: torch.Tensor,
                         weights: torch.Tensor | None, vocab: int
                         ) -> torch.Tensor:
    """The (B, K)-grid oracle of ``bag_grad_ref``
    (``repro/kernels/dequant_bag/kernel.py:439-500``), transcribed: one
    read-modify-write ``out[i] = fma(c, g[b], out[i])`` per slot in (b, k)
    order, ``c = w * scale[idx]``, slots with ``c == 0`` skipped.

    The serial walk is batched into runs of consecutive live slots whose
    rows are distinct (a run ends where a row repeats), so each run is one
    vectorised step and each row still takes its slots in (b, k) order.
    The runs are found on the host, one Python step per live slot.  It
    equals ``bag_grad_ref``, which groups the same chains by row instead.
    """
    b, k = indices.shape
    out = torch.zeros((vocab, g.shape[1]), dtype=torch.float32,
                      device=g.device)
    coeff = bag_grad_coeff(scales, indices, weights).reshape(-1)
    live = torch.nonzero(coeff != 0).reshape(-1)
    rows = indices.reshape(-1).to(torch.int64)[live]
    cuts, seen = [0], set()
    for j, r in enumerate(rows.tolist()):
        if r in seen:
            cuts.append(j)
            seen = set()
        seen.add(r)
    cuts.append(live.numel())
    gb = g.to(torch.float32)
    for a, e in zip(cuts[:-1], cuts[1:]):
        if a == e:
            continue
        sl, r = live[a:e], rows[a:e]
        out[r] = fma_f32(coeff[sl][:, None], gb[sl // k], out[r])
    return out
