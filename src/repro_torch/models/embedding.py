"""Embedding substrate: field-stacked tables.

Port of ``repro/models/embedding.py`` (the parts serving and training
need).  All feature fields of a model share ONE physical (sum_f V_f, D)
table; field-local indices are shifted by per-field offsets, so
F-Quantization's priority and tier state is global across fields (one
score per row).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class FieldSpec(NamedTuple):
    """Static metadata for a stacked multi-field embedding.

    ``total_rows`` is padded up to a multiple of ``pad_to``; the pad rows
    sit after the last field and are never indexed.
    """
    cardinalities: tuple[int, ...]   # V_f per field
    dim: int
    pad_to: int = 512

    @property
    def num_fields(self) -> int:
        return len(self.cardinalities)

    @property
    def total_rows(self) -> int:
        raw = int(sum(self.cardinalities))
        return -(-raw // self.pad_to) * self.pad_to

    def offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.cardinalities)[:-1]]
                              ).astype(np.int32)

    def table_bytes(self, bytes_per_elem: int = 4) -> list[int]:
        """Bytes of each field's table (F-Permutation's memory account)."""
        return [int(v) * self.dim * bytes_per_elem
                for v in self.cardinalities]


def globalize(indices: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Field-local (B, F) indices -> global row ids in the stacked table."""
    offsets = torch.from_numpy(spec.offsets()).to(indices.device)
    return indices + offsets[None, :]


def init_table(gen: torch.Generator, spec: FieldSpec,
               device: torch.device, scale: float = 0.01,
               chunk_rows: int = 1 << 22) -> torch.Tensor:
    """A (total_rows, D) fp32 N(0, scale^2) table, drawn in place.

    Filled chunk by chunk from ``gen`` (a generator on ``device``), so no
    temporary the size of the table exists: at 124M x 64 the table alone
    is 31.8 GB.  The reference draws it with ``jax.random``, which torch
    cannot reproduce; tests carry tables across with ``convert.py``.
    """
    table = torch.empty((spec.total_rows, spec.dim), dtype=torch.float32,
                        device=device)
    for r0 in range(0, spec.total_rows, chunk_rows):
        table[r0:r0 + chunk_rows].normal_(generator=gen).mul_(scale)
    return table


def field_lookup(table: torch.Tensor, indices: torch.Tensor,
                 spec: FieldSpec, field_mask: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """(B, F) field-local indices -> (B, F, D) embeddings.

    ``field_mask`` (F,) zeroes pruned fields (F-Permutation masking).
    """
    emb = table[globalize(indices, spec).to(torch.int64)]
    if field_mask is not None:
        emb = emb * field_mask.to(emb.device, emb.dtype)[None, :, None]
    return emb


def table_rows(spec: FieldSpec, seed: int, device: torch.device,
               scale: float = 0.01):
    """``rows(r0, r1)``: rows [r0, r1) of a random N(0, scale^2) table.

    Each call draws from a generator seeded by (seed, r0), so the table
    is a function of the seed and of the chunk boundaries, and is never
    held whole.  The reference draws its table with ``jax.random``,
    which torch cannot reproduce; tests carry it across with
    ``convert.py`` instead.
    """
    def rows(r0: int, r1: int) -> torch.Tensor:
        g = torch.Generator(device=device)
        g.manual_seed(seed * 1_000_003 + r0)
        return torch.randn((r1 - r0, spec.dim), generator=g,
                           device=device) * scale
    return rows
