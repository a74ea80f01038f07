"""The flat packed embedding-store backend.

Port of ``repro/store/api.py::PackedBackend`` (``mesh=None`` only): the
``QATStore`` (table + Eq. 7 priority) is authoritative and ``packed`` is
its serving pack, both on one device.  The reference keeps a host pack
and places a device copy; the port packs on the device and serves that
pack directly.  The ``EmbeddingStore`` protocol, the registry and the
hier and hashed backends come with later slices (ROADMAP Queue 1 items 4
and 8); so do the shadow re-tier (``begin_retier``, ``prewarm_retier``,
item 6) and the mesh (item 7).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import packed_store as ps
from repro_torch.core.priority import PriorityConfig, serve_fold
from repro_torch.core.qat_store import FQuantConfig, QATStore, current_tiers
from repro_torch.core.tiers import tier_crossings
from repro_torch.serve import cache as C


class PackedBackend:
    """Flat tier-partitioned store on one device."""

    def __init__(self, store: QATStore, cfg: FQuantConfig, *, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "the packed backend's mesh placement is not ported yet "
                "(ROADMAP Queue 1 item 7, distributed)")
        self.store = store
        self.cfg = cfg
        self.packed = ps.pack(store, cfg)

    @property
    def device(self) -> torch.device:
        return self.packed.indirect.device

    def nbytes(self) -> int:
        return int(self.packed.nbytes())

    # -- serving surface -----------------------------------------------

    def lookup_fn(self) -> Callable:
        return ps.lookup_fused

    def bag_matmul_fn(self) -> Callable:
        return ps.bag_matmul

    def build_cache(self, cache_rows: int) -> C.HotRowCache:
        return C.build_cache(self.packed, self.store.priority, cache_rows,
                             self.lookup_fn())

    # -- adaptation ----------------------------------------------------

    def fold_priority(self, indices: torch.Tensor, pcfg: PriorityConfig,
                      valid: torch.Tensor | None = None) -> None:
        """The eager Eq. 7 fold (``priority.serve_fold``), as the
        reference's eager ``serve_update`` computes it."""
        self.store = self.store._replace(
            priority=serve_fold(self.store.priority, indices, pcfg,
                                valid=valid))

    def prewarm_retier(self, chunk_rows: int) -> None:
        raise NotImplementedError(
            "shadow re-tiers are not ported yet (ROADMAP Queue 1 item 6)")

    def begin_retier(self, chunk_rows: int):
        raise NotImplementedError(
            "shadow re-tiers are not ported yet (ROADMAP Queue 1 item 6)")

    def retier(self) -> dict:
        """Synchronous delta re-tier of the rows whose tier crossed."""
        old = ps.packed_tiers(self.packed)
        new = current_tiers(self.store, self.cfg)
        changed, _ = tier_crossings(old, new)
        n = int(changed.numel())
        if n:
            self.packed = ps.repack_delta(self.packed, self.store, self.cfg,
                                          changed)
        return {"rows_moved": n, "changed": bool(n)}
