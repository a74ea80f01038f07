"""``HashedStore``: ROBE-style compositional embedding storage.

Port of ``repro/store/hashed.py``.  No row is stored: row ``r`` is
materialised on the fly from a shared ``(S, Z)`` chunk pool,

    row[r, c*Z:(c+1)*Z] = sum_j  sign_j(r, c) * pool[h_j(r, c)]

with ``num_hashes`` uint32-hash draws per chunk (arXiv:2207.10731), so
the memory is fixed by the pool size and does not grow with the
vocabulary: compression is ``V*D / (S*Z)``.  The serving gather is the
``hashed_gather`` kernel's ids entry (one launch per lookup, the slot
plan hashed in registers); ``quantize_pool`` is
the SHARK-rowwise x hashing combined mode (the pool snapped to int8 with
per-slot scales by the ``rowwise_quant`` kernel, dividing form, as the
reference's eager ``quantize_pool`` divides by 127).  The Eq. 7 priority
stays per row (V,): it cannot re-tier shared pool slots, but it picks
the hot-row fp32 cache in front of the hash path.

``fit_pool_from_table`` seeds a pool from a dense table by least
squares.  Materialisation is linear in the pool (A = ``fwd``), so the
pool solves ``A^T A p = A^T x`` by conjugate gradients from the
scatter-mean seed.  ``fwd`` is ``hashed_gather_ids`` over every row id
with unit scales (the slot plan hashed in registers, not read from
memory; bit-equal to the reference's ``(chunks * signs).sum(-2)``: at K
= 1 every product is exact); ``adj`` is ``bag_grad`` on the (V*C, NH)
plan with the signs as coefficients, which sums each pool row's
contributions in the reference's ``segment_sum`` (v, c, j) order,
deterministically (no float atomics).  Unlike the reference, ``fwd``
and ``adj`` run over row chunks when the whole plan would be large
(``fit_chunk_rows``): each chunk is hashed on its own and ``adj``
scatters chunk after chunk onto one (S, Z) result (``bag_grad(out=)``
continues each pool row's chain), so a chunked fit equals a one-chunk
fit bit for bit, and no array of V * C * NH entries is built beside the
table.  The CG vectors stay fp32, as in the reference; its dot products
reduce in another order than XLA's, so the fitted pool meets the
reference's within a tolerance, not bit for bit.

``init_hashed`` draws the pool from a ``torch.Generator``: the same
distribution as the reference's ``jax.random`` draw, not the same
numbers.  ``gather_rows_host`` materialises through the kernel on the
pool's device and returns numpy (the reference runs its jnp oracle).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.dequant_bag.ops import bag_grad, plan_slots
from repro_torch.kernels.hashed_gather.ops import hashed_gather_ids
from repro_torch.kernels.hashed_gather.ref import hash_slots
from repro_torch.kernels.rowwise_quant.ops import quantize_rowwise


class HashedConfig(NamedTuple):
    """Static shape and hash parameters, carried beside the arrays."""
    vocab: int
    dim: int
    chunk_dim: int = 8       # Z: pool row width; must divide dim
    num_slots: int = 2048    # S: pool rows
    num_hashes: int = 2      # draws combined per chunk
    pool_bits: int = 32      # 32 = fp32 pool; 8 = int8 + per-slot scale
    seed: int = 0

    @property
    def num_chunks(self) -> int:
        if self.dim % self.chunk_dim:
            raise ValueError(f"chunk_dim {self.chunk_dim} must divide "
                             f"dim {self.dim}")
        return self.dim // self.chunk_dim

    def pool_nbytes(self) -> int:
        per_elem = 1 if self.pool_bits == 8 else 4
        scale = self.num_slots * 4 if self.pool_bits == 8 else 0
        return self.num_slots * self.chunk_dim * per_elem + scale

    def compression_ratio(self) -> float:
        """fp32 table bytes / pool bytes (>= 1 means compressed)."""
        return (self.vocab * self.dim * 4) / max(self.pool_nbytes(), 1)


def plan_pool_slots(vocab: int, dim: int, chunk_dim: int,
                    target_ratio: float, pool_bits: int = 32) -> int:
    """Pool rows S hitting a target fp32-bytes / pool-bytes ratio."""
    per_slot = chunk_dim + 4 if pool_bits == 8 else chunk_dim * 4
    s = int(round(vocab * dim * 4 / (max(target_ratio, 1e-9) * per_slot)))
    return max(s, 1)


class HashedStore(NamedTuple):
    """pool (S, Z) fp32 or int8; pool_scale (S,) fp32 per-slot dequant
    scale (ones for fp32 pools, so ``pool * scale`` is exact); priority
    (V,) the Eq. 7 EMA that picks the hot-row cache."""
    pool: torch.Tensor
    pool_scale: torch.Tensor
    priority: torch.Tensor

    @property
    def num_slots(self) -> int:
        return self.pool.shape[0]

    @property
    def chunk_dim(self) -> int:
        return self.pool.shape[1]

    def nbytes(self) -> int:
        """Serving bytes: the pool and, for a quantized pool, its scales
        (the priority EMA is bookkeeping, as in ``PackedStore.nbytes``)."""
        scale = (0 if self.pool.dtype == torch.float32 else
                 self.pool_scale.numel() * self.pool_scale.element_size())
        return self.pool.numel() * self.pool.element_size() + scale


def _priority(priority, vocab: int, device) -> torch.Tensor:
    if priority is None:
        return torch.zeros((vocab,), dtype=torch.float32, device=device)
    return priority.to(device=device, dtype=torch.float32)


def init_hashed(cfg: HashedConfig, seed: int | None = None,
                priority: torch.Tensor | None = None,
                device: str | torch.device = "cpu") -> HashedStore:
    """Fresh fp32 pool ~ N(0, 0.05 / sqrt(num_hashes)): materialised rows
    then match a 0.05-std dense init in variance."""
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed if seed is None else seed)
    std = 0.05 / float(cfg.num_hashes) ** 0.5
    pool = std * torch.randn((cfg.num_slots, cfg.chunk_dim), generator=gen,
                             device=device)
    return HashedStore(
        pool=pool,
        pool_scale=torch.ones((cfg.num_slots,), dtype=torch.float32,
                              device=device),
        priority=_priority(priority, cfg.vocab, device))


CG_ITERS = 12      # the reference's default: 1 + CG_ITERS fwd and
                   # 2 + CG_ITERS adj passes over the rows a fit
# A fit plans all its rows in one chunk while the plan has at most this
# many slots (V * C * NH; 16 B of plan and grouping a slot, ~4.3 GB here),
# and otherwise in chunks of FIT_CHUNK_ROWS rows: dlrm-rm2's 124,185,088
# rows x 8 chunks x 2 hashes would need ~32 GB of plan beside the table.
FIT_PLAN_SLOTS = 1 << 28
FIT_CHUNK_ROWS = 1 << 22


def fit_chunk_rows(cfg: HashedConfig) -> int:
    """Rows a chunk of ``fit_pool_from_table`` holds: every row when the
    whole plan has at most ``FIT_PLAN_SLOTS`` slots, else
    ``FIT_CHUNK_ROWS``."""
    if cfg.vocab * cfg.num_chunks * cfg.num_hashes <= FIT_PLAN_SLOTS:
        return max(cfg.vocab, 1)
    return FIT_CHUNK_ROWS


def fit_pool_from_table(table: torch.Tensor, cfg: HashedConfig,
                        priority: torch.Tensor | None = None,
                        cg_iters: int = CG_ITERS,
                        audit=None) -> HashedStore:
    """Least-squares fit of an fp32 pool to ``table`` (V, D), on the
    table's device (a placed ``dist.packed.RowShards`` table: its mesh's
    first device, each chunk read from the shards that own its rows, so
    the fit equals the whole table's bit for bit and no device holds the
    whole): ``cg_iters`` conjugate-gradient steps on the normal
    equations from the scatter-mean seed (already exact when draws never
    collide).  The residual at high compression is the hashing scheme's
    own loss, not the solver's.

    ``fwd`` and ``adj`` run over row chunks of ``fit_chunk_rows(cfg)``
    rows, each chunk's slots hashed for that chunk alone: ``adj``
    scatters chunk after chunk onto one (S, Z) result with
    ``bag_grad(out=)``, each pool row's chain continuing where the last
    chunk left it, so the fit equals a one-chunk fit bit for bit.  A
    one-chunk fit groups its slots once (``plan_slots``); a chunked one
    hashes and groups each chunk again in each ``adj`` (nothing of size
    V * C * NH is kept).  ``audit(r0, r1, g, bags, signs, before, after)``,
    when given, sees each chunk's scatter in the first ``adj`` (of the
    table): its rows, cotangent (n * C, Z), plan (n * C, NH), and the
    (S, Z) result before (a copy) and after it.
    """
    v, d = table.shape
    c, z, nh, s = cfg.num_chunks, cfg.chunk_dim, cfg.num_hashes, cfg.num_slots
    dev = table.device
    step = fit_chunk_rows(cfg)
    bounds = [(r0, min(v, r0 + step)) for r0 in range(0, v, step)]

    def plan(r0, r1):    # the chunk's (n * C, NH) bags and signs
        ids = torch.arange(r0, r1, dtype=torch.int32, device=dev)
        slots, signs = hash_slots(ids, num_chunks=c, num_hashes=nh,
                                  num_slots=s, seed=cfg.seed)
        return slots.reshape(-1, nh), signs.reshape(-1, nh)

    kept = None
    if len(bounds) == 1:      # group the slots once a fit
        bags, bag_signs = plan(0, v)
        kept = (bags, bag_signs, plan_slots(bags))

    def fwd(p, r0, r1):  # A on rows [r0, r1): pool -> (n, D)
        rows = torch.arange(r0, r1, dtype=torch.int32,
                            device=dev).reshape(-1, 1)
        return hashed_gather_ids(p, None, rows, num_chunks=c,
                                 num_hashes=nh, seed=cfg.seed)

    def adj(rows_of, check=None):   # A^T: (V, D) cotangent -> (S, Z)
        out = torch.zeros((s, z), dtype=torch.float32, device=dev)
        for r0, r1 in bounds:
            bags, bag_signs, grouping = kept or (*plan(r0, r1), None)
            g = rows_of(r0, r1).reshape(-1, z)
            before = None if check is None else out.clone()
            bag_grad(g, None, bags, bag_signs, s, plan=grouping, out=out)
            if check is not None:
                check(r0, r1, g, bags, bag_signs, before, out)
            del g, bags, bag_signs
        return out

    def vdot(a, b):
        return torch.dot(a.reshape(-1), b.reshape(-1))

    counts = torch.zeros((s,), dtype=torch.float32, device=dev)
    for r0, r1 in bounds:
        counts += torch.bincount(
            (kept[0] if kept else plan(r0, r1)[0]).reshape(-1)
            .to(torch.int64), minlength=s).to(torch.float32)
    b = adj(lambda r0, r1: table[r0:r1].to(torch.float32), check=audit)
    pool = b / counts.clamp_min(1.0)[:, None]      # scatter-mean seed
    if cg_iters > 0:
        def gram(p):
            return adj(lambda r0, r1: fwd(p, r0, r1))
        r = b - gram(pool)
        p_dir = r
        rs = vdot(r, r)
        for _ in range(cg_iters):
            gp = gram(p_dir)
            alpha = rs / vdot(p_dir, gp).clamp_min(1e-30)
            pool = pool + alpha * p_dir
            r = r - alpha * gp
            rs_new = vdot(r, r)
            p_dir = r + (rs_new / rs.clamp_min(1e-30)) * p_dir
            rs = rs_new
    return HashedStore(
        pool=pool,
        pool_scale=torch.ones((cfg.num_slots,), dtype=torch.float32,
                              device=dev),
        priority=_priority(priority, v, dev))


def fit_residual(hs: HashedStore, cfg: HashedConfig,
                 table: torch.Tensor) -> float:
    """``||fwd(pool) - table|| / ||table||`` over every row, in row chunks
    of ``table`` (a tensor or a placed ``RowShards``; the pool read back
    through the serving gather; 1 for a zero pool)."""
    num = torch.zeros((), dtype=torch.float64, device=table.device)
    den = torch.zeros((), dtype=torch.float64, device=table.device)
    for r0 in range(0, table.shape[0], FIT_CHUNK_ROWS):
        rows = table[r0:r0 + FIT_CHUNK_ROWS].to(torch.float64)
        ids = torch.arange(r0, r0 + rows.shape[0], dtype=torch.int32,
                           device=table.device)
        num += ((hashed_lookup(hs, cfg, ids) - rows) ** 2).sum()
        den += (rows ** 2).sum()
    return float(num.sqrt() / den.sqrt())


def quantize_pool(hs: HashedStore) -> HashedStore:
    """SHARK-rowwise x hashing combined mode: the pool snapped to int8
    with per-slot scales (Eq. 5-6 round-to-nearest on pool rows), through
    the ``rowwise_quant`` kernel in its dividing form."""
    q, scale = quantize_rowwise(hs.pool.to(torch.float32), mode="narrow",
                                reciprocal=False)
    return hs._replace(pool=q, pool_scale=scale.reshape(-1))


def pool_f32(hs: HashedStore) -> torch.Tensor:
    """Dequantized pool view (exact for fp32 pools: the scale is ones)."""
    return hs.pool.to(torch.float32) * hs.pool_scale[:, None]


def hashed_bag_lookup(hs: HashedStore, cfg: HashedConfig,
                      indices: torch.Tensor,
                      weights: torch.Tensor | None = None) -> torch.Tensor:
    """Bag-sum lookup: indices (B, K) [+ weights (B, K)] -> (B, D) fp32,
    materialised by one ``hashed_gather_ids`` (zero weights skip their
    slots)."""
    return hashed_gather_ids(hs.pool, hs.pool_scale, indices, weights,
                             num_chunks=cfg.num_chunks,
                             num_hashes=cfg.num_hashes, seed=cfg.seed)


def hashed_lookup(hs: HashedStore, cfg: HashedConfig,
                  indices: torch.Tensor) -> torch.Tensor:
    """Per-index materialisation: int (...,) -> fp32 (..., D), the K = 1
    bag (the serving gather)."""
    out = hashed_bag_lookup(hs, cfg, indices.reshape(-1, 1))
    return out.reshape(*indices.shape, cfg.dim)


def gather_rows_host(hs: HashedStore, cfg: HashedConfig, ids):
    """fp32 rows ``ids`` materialised from the pool through the serving
    gather on the pool's device (the ids entry), returned on the host as
    numpy (cache rebuilds, oracles)."""
    idx = torch.as_tensor(np.asarray(ids, np.int64).reshape(-1),
                          device=hs.pool.device).to(torch.int32)
    return hashed_lookup(hs, cfg, idx).cpu().numpy()


def hashed_state_tree(hs: HashedStore, cfg: HashedConfig) -> dict:
    """Checkpointable manifest payload (``hashed_store/v1``)."""
    return {"kind": "hashed_store/v1", "config": dict(cfg._asdict()),
            "pool": hs.pool, "pool_scale": hs.pool_scale,
            "priority": hs.priority}
