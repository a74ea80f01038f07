"""Hand-written collectives over the port's ``Mesh``.

Port of ``repro/dist/collectives.py``.  ``split_kv_decode_attention`` is
the distributed decode hot path: the KV cache is split along the sequence
axis (shard ``i`` owns slots ``[i S/n, (i + 1) S/n)``), every shard
attends its own slots with a local max, denominator and weighted-V sum,
and the partial softmaxes are combined with the flash-attention rule
across shards:

    out = sum_i exp(m_i - m) num_i / sum_i exp(m_i - m) l_i,  m = max_i m_i

which is the full softmax over the valid cache prefix.  The reference
runs it under ``shard_map`` with a ``pmax`` and two ``psum``; the single
controller loops over the shards, takes the max and the two sums in
shard order 0..n-1 (``dist.mesh.psum``) and leaves the result on the
mesh's first device.  On one card (``make_mesh(n)``) the shards are views
of one cache along S; with ``make_mesh(n, devices=...)`` shard ``i``'s
slots live on ``devices[i]`` (``shard_sequence``).  Its products are
plain ``torch.einsum``, as the reference computes them outside any
Pallas kernel.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.dist.mesh import Mesh, check_mesh, psum
from repro_torch.core import op_counter

NEG_INF = -1e30


def shard_sequence(mesh: Mesh, x: torch.Tensor, axis: str = "model"
                   ) -> list[torch.Tensor]:
    """``x`` (B, S, ...) split into ``n`` equal blocks along S, block ``i``
    on ``mesh.devices[i]`` (a view where it is already there)."""
    n = check_mesh(mesh, axis)
    s = x.shape[1]
    if s % n:
        raise ValueError(f"cache length {s} not divisible by {axis}={n}")
    s_loc = s // n
    return [x[:, i * s_loc:(i + 1) * s_loc].to(mesh.devices[i])
            for i in range(n)]


def split_kv_decode_attention(mesh: Mesh, q: torch.Tensor, k, v,
                              cache_len: int, scale: float,
                              axis: str = "model") -> torch.Tensor:
    """Split-KV single-token decode attention.

    q: (B, H, D) current query; k, v: (B, S, H, D) caches (or their ``n``
    shards along S, as ``shard_sequence`` gives them); cache_len: slots
    at positions > cache_len are masked.  Returns (B, H, D) in q's dtype
    on ``mesh.device``.
    """
    n = check_mesh(mesh, axis)
    ks = k if isinstance(k, Sequence) else shard_sequence(mesh, k, axis)
    vs = v if isinstance(v, Sequence) else shard_sequence(mesh, v, axis)
    if len(ks) != n or len(vs) != n:
        raise ValueError(f"{len(ks)} / {len(vs)} cache shards for a mesh "
                         f"of {n}")
    if len({x.shape[1] for x in ks}) != 1:
        raise ValueError("cache shards differ in length")

    parts = []
    for i in range(n):
        dev = ks[i].device
        s_loc = ks[i].shape[1]
        pos = i * s_loc + torch.arange(s_loc, device=dev)
        sc = torch.einsum("bhd,bkhd->bhk", q.to(dev, torch.float32),
                          ks[i].to(torch.float32)) * scale
        valid = (pos <= cache_len)[None, None, :]
        sc = torch.where(valid, sc, NEG_INF)
        m = sc.amax(dim=-1)                            # (B, H) local max
        p = torch.where(valid, torch.exp(sc - m[..., None]), 0.0)
        num = torch.einsum("bhk,bkhd->bhd", p, vs[i].to(torch.float32))
        parts.append((m, p.sum(dim=-1), num))

    # pmax: the shards' maxima on the first device, sent back to each
    m_glob = parts[0][0].to(mesh.device)
    for m, _, _ in parts[1:]:
        m_glob = torch.maximum(m_glob, m.to(mesh.device))
    op_counter.report_collective(
        "all-reduce", n * m_glob.numel() * m_glob.element_size())
    corr = [torch.exp(m - m_glob.to(m.device)) for m, _, _ in parts]
    num = psum((nm * c[..., None] for (_, _, nm), c in zip(parts, corr)),
               mesh)
    den = psum((l * c for (_, l, _), c in zip(parts, corr)), mesh)
    return (num / den[..., None]).to(q.dtype)
