"""Row-sharded chunk pool for the ROBE-style ``HashedStore``.

Port of ``repro/dist/hashed.py``.  ``shard_hashed`` row-shards the (S, Z)
pool and its per-slot scales over the mesh's axis (at the reference's
stride ``ceil(S / n)``; the last shard owns fewer rows instead of pad
rows, which the hash family never addresses), and the lookups run the
scheme of ``dist.packed``:

  1. the indices hash to GLOBAL pool slots once (``slot_plan``: the hash
     family is stateless, so no slot table is exchanged),
  2. each shard runs the ``hashed_gather`` kernel's plan entry over its
     rows, with the coefficients of the slots it does not own zeroed (the
     kernel skips them, so each pool row is read by one shard),
  3. ``psum`` adds the (B, D) partials in shard order.

A materialised row sums T = K * NH chunk draws that may lie in different
shards, so the sharded row is the unsharded one only up to the rounding
of the partial sums (one fp32 rounding a shard a chunk).  With two draws a
chunk (one id, two hashes: the serving default) and sign coefficients
each chunk is one rounding of the two draws' sum in either order, so
there the sharded rows keep the unsharded bits.

``sharded_hashed_lookup_train`` is the differentiable twin
(``ShardedHashedTrain``): the pool stays whole on the mesh's first device
(the reference places only the recsys table), each shard's window goes to
its device for the plan entry forward, and backward ``bag_grad`` a shard
on its device gives that shard's rows of the one (S, Z) pool gradient, so
each pool row's chain is the unsharded one bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.dist.mesh import Mesh, check_mesh, psum
from repro_torch.dist.packed import (_on, shard_window, spread_rows,
                                     train_windows)
from repro_torch.kernels.dequant_bag.ops import stand_in
from repro_torch.kernels.hashed_gather.ops import hashed_gather, slot_plan


class ShardedHashed:
    """A ``HashedStore`` with its pool row-sharded over a ``Mesh``:
    ``pools[i]`` / ``scales[i]`` shard ``i``'s rows (global rows
    ``windows[i][0]`` on; views on the pool's device, copies on others),
    the priority replicated on the mesh's first device."""

    def __init__(self, pools, scales, windows, priority, num_slots: int,
                 mesh: Mesh):
        self.pools = tuple(pools)
        self.scales = tuple(scales)
        self.windows = tuple(windows)
        self.priority = priority
        self.mesh = mesh
        self._num_slots = int(num_slots)

    @property
    def num_slots(self) -> int:
        return self._num_slots

    def nbytes(self) -> int:
        quantized = self.pools[0].dtype != torch.float32
        return int(sum(p.numel() * p.element_size()
                       + (s.numel() * s.element_size() if quantized else 0)
                       for p, s in zip(self.pools, self.scales)))


def shard_hashed(hs, mesh: Mesh, axis: str = "model") -> ShardedHashed:
    """The pool and its scales row-sharded over ``axis``; the priority
    vector stays whole (the serve fold and the cache ranking read it)."""
    n = check_mesh(mesh, axis)
    s = hs.pool.shape[0]
    windows = [shard_window(s, n, i) for i in range(n)]
    pools = [hs.pool[f:f + c].to(d) for (f, c), d in zip(windows,
                                                         mesh.devices)]
    scales = [hs.pool_scale[f:f + c].to(d)
              for (f, c), d in zip(windows, mesh.devices)]
    return ShardedHashed(pools, scales, windows,
                         hs.priority.to(mesh.device), s, mesh)


def _local_coeff(slots: torch.Tensor, coeff: torch.Tensor, first: int,
                 rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Global slots -> (local slots, int32; coefficients with other shards'
    entries zeroed).  The zero coefficient makes the kernels skip the
    slot's chunk; its local slot is spread over the shard
    (``dist.packed.spread_rows``), not clamped to an edge row."""
    glob = slots.to(torch.int64)
    loc = glob - first
    mine = (loc >= 0) & (loc < rows)
    return (spread_rows(loc, mine, glob, rows),
            torch.where(mine, coeff, 0.0).contiguous())


def sharded_hashed_lookup(hs: ShardedHashed, cfg, indices: torch.Tensor, *,
                          mesh: Mesh | None = None, axis: str = "model"
                          ) -> torch.Tensor:
    """Distributed hashed materialisation: int (...,) -> fp32 (..., D) on
    the mesh's first device; ``hs`` placed by ``shard_hashed``.  One
    ``hashed_gather`` plan-entry launch a shard."""
    if mesh is not None and check_mesh(mesh, axis) != hs.mesh.size:
        raise ValueError(f"pool sharded {hs.mesh.size} ways, mesh "
                         f"{mesh.size}")
    idx = torch.as_tensor(indices)
    flat = idx.reshape(-1, 1)
    slots, coeff = slot_plan(flat, None, num_chunks=cfg.num_chunks,
                             num_hashes=cfg.num_hashes,
                             num_slots=cfg.num_slots, seed=cfg.seed)
    sl, co = {}, {}

    def parts():
        for pool, scale, (first, rows) in zip(hs.pools, hs.scales,
                                              hs.windows):
            dev = pool.device
            lc, cm = _local_coeff(_on(slots, dev, sl), _on(coeff, dev, co),
                                  first, rows)
            pool, scale = stand_in(pool, scale)
            yield hashed_gather(pool, scale, lc, cm,
                                num_chunks=cfg.num_chunks)
    return psum(parts(), hs.mesh).reshape(*idx.shape, cfg.dim)


def _window(pool: torch.Tensor, first: int, rows: int, dev: torch.device
            ) -> torch.Tensor:
    """Shard rows ``[first, first + rows)`` of the whole pool on ``dev``:
    a view on the pool's device, a copy on another."""
    return pool[first:first + rows].to(dev)


class ShardedHashedTrain(torch.autograd.Function):
    """pool (S, Z) fp32, held whole on the mesh's first device (the
    reference keeps the hashed state replicated), slots / coeff (B, C*T)
    -> (B, C*Z): the plan entry a shard forward on the shard's device, over
    its window of the pool (``_window``) with other shards' coefficients
    zeroed, summed in shard order; backward ``bag_grad`` a shard on its
    device on the (B*C, T) reshape, as ``HashedTrain``'s, each shard's
    rows copied into the one (S, Z) pool gradient.  The coefficients get
    no gradient (the training gather's are the plan's signs)."""

    @staticmethod
    def forward(ctx, pool, slots, coeff, num_chunks, windows, mesh):
        sl, co, local = {}, {}, []
        for (f, r), dev in zip(windows, mesh.devices):
            local.append(_local_coeff(_on(slots, dev, sl), _on(coeff, dev, co),
                                      f, r))
        parts = (hashed_gather(stand_in(_window(pool, f, r, dev), None)[0],
                               None, lc, cm, num_chunks=num_chunks)
                 for (f, r), dev, (lc, cm) in zip(windows, mesh.devices,
                                                  local))
        ctx.local = local
        ctx.windows = windows
        ctx.num_chunks = num_chunks
        ctx.shape = pool.shape
        return psum(parts, mesh)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels.dequant_bag.ops import bag_grad
        nc = ctx.num_chunks
        g = g.to(torch.float32).contiguous()
        b, z = g.shape[0], ctx.shape[1]
        g2 = g.reshape(b * nc, z)
        grad = torch.zeros(ctx.shape, dtype=torch.float32, device=g.device)
        gs = {}
        for (f, r), (lc, cm) in zip(ctx.windows, ctx.local):
            t = lc.shape[1] // nc
            if r:
                grad[f:f + r] = bag_grad(_on(g2, lc.device, gs), None,
                                         lc.reshape(b * nc, t),
                                         cm.reshape(b * nc, t), r)
        return grad, None, None, None, None, None


def sharded_hashed_lookup_train(pool: torch.Tensor, indices: torch.Tensor,
                                *, num_chunks: int, num_hashes: int,
                                num_slots: int, seed: int = 0, mesh: Mesh,
                                axis: str = "model") -> torch.Tensor:
    """Differentiable row-sharded hashed gather over the fp32 training
    pool: int (...,) -> fp32 (..., D).  ``num_slots`` is the global pool
    size; the pool's rows need not divide the axis (the last shard owns
    fewer)."""
    windows = train_windows(pool.shape[0], mesh, axis, divide=False)
    flat = indices.reshape(-1, 1)
    slots, coeff = slot_plan(flat, None, num_chunks=num_chunks,
                             num_hashes=num_hashes, num_slots=num_slots,
                             seed=seed)
    out = ShardedHashedTrain.apply(pool, slots, coeff, num_chunks, windows,
                                   mesh)
    return out.reshape(*indices.shape, out.shape[-1])


__all__ = [
    "ShardedHashed",
    "shard_hashed",
    "sharded_hashed_lookup",
    "sharded_hashed_lookup_train",
]
