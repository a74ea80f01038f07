"""Shadow-store re-tiering: a copy-on-write repack off the request path.

Port of ``repro/serve/shadow.py``.  The synchronous
re-tier (``packed_store.repack_delta``) stalls the request that runs it
for the whole rebuild.  ``ShadowRepack`` splits it into a shadow
generation built in bounded chunks while requests keep reading the live
store, then swapped in with one pointer flip (``serve.online``):

    begin    snapshot the fold state (``QATStore`` is an immutable
             NamedTuple and the fold returns a new priority tensor, so
             keeping the reference is the snapshot) and freeze the mover
             set against it
    chunk    each step quantizes at most a row budget of movers
             (row-wise, so chunking changes no byte) into per-tier
             blocks; the live store is never written
    verify   (optional) the finished shadow must be bit-identical to a
             fresh ``pack`` at the snapshot fold state
    swap     one pointer flip; the shadow already lives on the device
    discard  any time before the swap: drop the shadow, the live store
             is untouched

Everything runs on the store's device: the mover set, the chunks and the
finished store stay there, and the table is the snapshot's own tensor
(the reference copies it to the host, 2.84 GB a build for full-width
wide&deep).  Bit-identity at every chunk boundary: after ``pos`` movers
the shadow materializes to ``repack_delta(live, snapshot, cfg,
movers[:pos])`` through ``unpack``, and the finished shadow equals
``pack(snapshot)`` through ``unpack``; its leaves equal the reference's.

``ShadowMigrate`` is the hierarchical store's twin (``store.hier``): the
same plan, builders and commit as the synchronous ``HierStore.migrate``,
on a chunked schedule: the level builds (hot, warm, then cold ids when the
cold set changes) in bounded row chunks, then one cold shard a step into
a hidden tmp dir (``manifest.ShardWriter``), then staged.  ``commit``
publishes the cold generation and runs ``HierStore.commit_retier``, the
one mutation point the synchronous path uses too; ``discard`` removes the
unpublished tmp dir.  Its verify works level by level in blocks of
``VERIFY_ROWS`` rows on the card (the reference unpacks a whole fresh
pack, 52.3 GB at dlrm-rm2's full width, and dequantizes the host levels on
the host).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import packed_store as ps
from repro_torch.core.packed_store import (_TIER_SHIFT, PackedStore,
                                           _assemble, _placeholder,
                                           _quantize_tier, extract_rows,
                                           merge_stores)
from repro_torch.core.qat_store import FQuantConfig, QATStore, current_tiers
from repro_torch.core.tiers import Tier, tier_counts
from repro_torch.store.budget import COLD, HOT, WARM
from repro_torch.store.hier import HierStore, RetierPlan, mismatch_pack
from repro_torch.store.manifest import ColdShards, ShardWriter

# rows of one verify block: bounds the two fp32 unpacks held at a time
# (the full-width wide&deep table unpacked whole is 2.84 GB, twice)
VERIFY_ROWS = 1 << 20


class ShadowRepack:
    """Chunked copy-on-write twin of ``repack_delta`` for the flat store.

    Freezes the mover set once (rows whose packed tier differs from the
    snapshot's Eq. 8 tier) and gives every mover its slot in its new
    tier's mover block (movers in order, as the reference's chunk stores
    concatenate).  Each step quantizes at most a row budget of movers
    and writes them into those blocks; the final store is assembled in
    one O(V) step whatever the number of steps: surviving rows carry
    their live bytes (``extract_rows``), the mover blocks append
    (``merge_stores``), a permutation restores global-id addressing.
    The live store is read, never written.
    """

    def __init__(self, packed: PackedStore, snapshot: QATStore,
                 cfg: FQuantConfig, mesh=None, axis: str = "model"):
        self.live = packed
        self.mesh, self.axis = mesh, axis
        self.snapshot = snapshot
        self.cfg = cfg
        self.table = snapshot.table
        old = ps.packed_tiers(packed).to(torch.int64)
        self.new_tiers = current_tiers(snapshot, cfg).to(torch.int64)
        self.movers = torch.nonzero(old != self.new_tiers).reshape(-1)
        self._n = int(self.movers.numel())
        self.pos = 0
        self.result: PackedStore | None = None
        # each mover's new tier and its slot among that tier's movers
        mtier = self.new_tiers[self.movers]
        slots = (mtier[None, :] == torch.arange(3, device=mtier.device)
                 [:, None]).cumsum(1) - 1
        self._mtier = mtier
        self._slot = slots.gather(0, mtier[None, :]).reshape(-1)
        self._counts = tier_counts(mtier)
        del slots
        dim, dev = self.table.shape[1], self.table.device
        dtypes = (packed.payload8.dtype, packed.payload16.dtype,
                  packed.payload32.dtype)
        # plain tensors, written in place by steps inside and outside
        # inference mode (a build opened on a request drains at teardown)
        with torch.inference_mode(False):
            self._payload = [torch.empty((c, dim), dtype=dt, device=dev)
                             for c, dt in zip(self._counts, dtypes)]
            self._scale = [torch.empty((c,), dtype=torch.float32,
                                       device=dev) for c in self._counts[:2]]

    @property
    def moved(self) -> int:
        return self._n

    @property
    def remaining_rows(self) -> int:
        return self._n - self.pos

    @property
    def staged(self) -> bool:
        return self.result is not None

    def step(self, budget: int) -> bool:
        """Quantize the next ``budget`` (>= 1) movers into their tiers'
        blocks (each tier's quantizer once over the step's rows, row-wise,
        as ``quantize_rows``; each tier keeps its own rows), and
        materialize the final store when the mover set drains.  Returns
        ``staged``.  (The reference quantizes a step in sub-chunks padded
        to one shape for XLA's compile cache; eager torch has none to
        fill, and the leaves are the same.)"""
        if self.result is not None:
            return True
        take = min(max(int(budget), 1), self._n - self.pos)
        if take > 0:
            p0, p1 = self.pos, self.pos + take
            rows = self.table[self.movers[p0:p1]].to(torch.float32)
            mtier, slot = self._mtier[p0:p1], self._slot[p0:p1]
            for tier in Tier:
                t = int(tier.value)
                q, s = _quantize_tier(rows, tier, self.cfg)
                sel = torch.nonzero(mtier == t).reshape(-1)
                if sel.numel():
                    dest = slot.index_select(0, sel)
                    self._payload[t].index_copy_(0, dest,
                                                 q.index_select(0, sel))
                    if s is not None:
                        self._scale[t].index_copy_(0, dest,
                                                   s.index_select(0, sel))
            self.pos = p1
        if self.pos >= self._n:
            self.result = self.materialize()
        return self.result is not None

    def _mover_store(self) -> PackedStore:
        """The sub-store of the processed movers, position ``i`` = mover
        ``i``: each tier's block cut to the rows written so far."""
        pos = self.pos
        done = (self._counts if pos >= self._n
                else tier_counts(self._mtier[:pos]))
        dev = self.table.device
        parts = []
        for k, n in enumerate(done):
            scaled = k < 2
            if n:
                parts.append((self._payload[k][:n],
                              self._scale[k][:n] if scaled else None))
            else:
                parts.append(_placeholder(self._payload[k].dtype, scaled,
                                          self.table.shape[1], dev))
        indirect = ((self._mtier[:pos] << _TIER_SHIFT)
                    | self._slot[:pos]).to(torch.int32)
        return _assemble(parts, indirect)

    def materialize(self) -> PackedStore:
        """The store as if swapped now: processed movers re-tiered, every
        other row (the movers not reached yet included) with its live
        bytes.  Its ``unpack`` equals that of ``repack_delta(live,
        snapshot, cfg, movers[:pos])``; its leaves equal the reference's.
        A constant number of launches and host reads, however many steps
        the build took.
        """
        done = self.movers[:self.pos]
        vocab = self.live.vocab
        dev = self.live.indirect.device
        mask = torch.zeros(vocab, dtype=torch.bool, device=dev)
        mask[done] = True
        keep = torch.nonzero(~mask).reshape(-1)
        n_keep = vocab - done.numel()
        perm = torch.empty(vocab, dtype=torch.int64, device=dev)
        perm[keep] = torch.arange(n_keep, device=dev)
        perm[done] = n_keep + torch.arange(done.numel(), device=dev)
        merged = merge_stores([extract_rows(self.live, keep),
                               self._mover_store()])
        del keep, mask
        return extract_rows(merged, perm)

    def place(self):
        """The finished store as the server serves it: already on the
        serving device (the reference transfers its host result here), row
        sharded under the server's mesh (views, no copy, on one device)."""
        from repro_torch.dist.packed import place_packed
        return place_packed(self.result, self.mesh, self.axis)

    def verify(self) -> None:
        """Raise ``AssertionError`` unless the finished store unpacks bit
        for bit to a fresh ``pack`` at the snapshot fold state (O(V): the
        pack, then both unpacked in blocks of ``VERIFY_ROWS`` rows).
        Returns after the comparison has been read back."""
        ref = ps.pack(self.snapshot, self.cfg)
        got = self.result
        bad = torch.zeros((), dtype=torch.bool, device=got.indirect.device)
        for r0 in range(0, got.vocab, VERIFY_ROWS):
            r1 = min(got.vocab, r0 + VERIFY_ROWS)
            a = ps.unpack(ref, r0, r1).view(torch.int32)
            b = ps.unpack(got, r0, r1).view(torch.int32)
            bad |= (a != b).any()
        if bool(bad):
            raise AssertionError(
                "shadow swap verify FAILED: the shadow store is not "
                "bit-identical to pack() at the snapshot fold state")

    def commit(self, server, staged: PackedStore | None) -> int:
        """Flip the server's live store to the shadow generation (``staged``
        is ``place``'s result under the server's mesh)."""
        b = server.backend
        b.packed = self.place() if staged is None else staged
        return self.moved

    def discard(self) -> None:
        """Nothing to undo for the flat store: dropping the object is the
        whole discard, the live store was never written."""


class ShadowMigrate:
    """Chunked twin of ``HierStore.migrate``: the same plan, builders and
    commit, on another schedule.

    ``step`` order: (1) the level builds, hot, then warm, then the cold
    ids, at most the step's row budget; (2) the cold generation,
    one shard a step into ``ShardWriter``'s tmp dir (the live generation
    sees nothing until the swap publishes); (3) staged.  The steps and
    their row counts are the reference's.
    """

    def __init__(self, hier: HierStore, snapshot: QATStore,
                 cfg: FQuantConfig, chunk_rows: int = 512):
        self.hier = hier
        self.snapshot = snapshot
        self.cfg = cfg
        self.chunk_rows = max(int(chunk_rows), 1)
        self.rp: RetierPlan = hier.plan_retier(snapshot, cfg)
        plan = self.rp.plan
        self._cold_needed = bool(plan.cold_ids.size
                                 and hier.cold_changed(self.rp))
        if self._cold_needed and hier.cfg.store_dir is None:
            raise ValueError("cold spill requires store_dir")
        self._levels = [("hot", HOT, plan.hot_ids),
                        ("warm", WARM, plan.warm_ids)]
        if self._cold_needed:
            self._levels.append(("cold", COLD, plan.cold_ids))
        self._built: dict[str, list] = {n: [] for n, _, _ in self._levels}
        self._pos = {n: 0 for n, _, _ in self._levels}
        self.results: dict[str, PackedStore] = {}
        self.writer: ShardWriter | None = None
        self.total_rows = int(sum(ids.size for _, _, ids in self._levels))
        self.done_rows = 0
        self.staged = False

    @property
    def moved(self) -> int:
        return int(np.count_nonzero(self.rp.crossed))

    @property
    def remaining_rows(self) -> int:
        return self.total_rows - self.done_rows

    def _empty(self, lev: int) -> PackedStore:
        return self.hier.build_rows(np.zeros((0,), np.int64), self.rp,
                                    self.cfg, self.hier.level_device(lev))

    def step(self, budget: int) -> bool:
        """At most ``budget`` rows of level builds, or one cold shard.
        Returns ``staged``.  (The reference builds a step in sub-runs of
        ``chunk_rows`` rows, padded to one shape for XLA's compile cache;
        eager torch has none to fill, so a step builds its rows of a level
        in one run: the same rows a step, so the same steps, and the runs
        merge to the same store.)"""
        if self.staged:
            return True
        budget = max(int(budget), 1)
        while budget > 0 and self.done_rows < self.total_rows:
            for name, lev, ids in self._levels:
                p = self._pos[name]
                if p < ids.size:
                    chunk = ids[p:p + budget]
                    self._built[name].append(self.hier.build_rows(
                        chunk, self.rp, self.cfg,
                        self.hier.level_device(lev)))
                    self._pos[name] = p + int(chunk.size)
                    self.done_rows += int(chunk.size)
                    budget -= int(chunk.size)
                    break
        if self.done_rows < self.total_rows:
            return False
        for name, lev, _ in self._levels:
            if name not in self.results:
                # consecutive runs merge back into the one-shot build
                built = self._built[name]
                self.results[name] = (merge_stores(built) if built
                                      else self._empty(lev))
                self._built[name] = []
        for name, lev in (("hot", HOT), ("warm", WARM)):
            if name not in self.results:
                self.results[name] = self._empty(lev)
        if self._cold_needed:
            if self.writer is None:
                self.writer = ShardWriter(
                    self.hier.cfg.store_dir, self.results["cold"],
                    self.rp.plan.cold_ids, self.hier.cfg.rows_per_shard)
            if self.writer.write_next():
                return False
        self.staged = True
        return True

    def place(self) -> PackedStore:
        """The new hot level, built on the serving device already (the
        hier store shards it over its mesh itself, at the commit's
        ``place``)."""
        return self.results["hot"]

    def verify(self) -> None:
        """Raise ``AssertionError`` unless every row of the built
        generation looks up bit for bit as a fresh ``pack`` at the snapshot
        fold state does (``store.hier.mismatch_pack``: level by level, in
        blocks on the table's device, each against the pack of its own
        rows; a host level's blocks are cut out of it and looked up on the
        device, where the reference dequantizes them on the host, whose
        ``np_lookup`` the tests and the serving audits hold to the device's
        bits).  A cold level the plan leaves as it is is read from the
        live shards."""
        plan = self.rp.plan
        bad = None
        for name, lev, ids in (("hot", HOT, plan.hot_ids),
                               ("warm", WARM, plan.warm_ids),
                               ("cold", COLD, plan.cold_ids)):
            if name in self.results:
                store = self.results[name]

                def block(c0, c1, store=store):
                    return extract_rows(store, torch.arange(
                        c0, c1, device=store.indirect.device))
            else:               # the live cold shards serve on
                def block(c0, c1, lev=lev):
                    return self.hier.level_block(lev, c0, c1)
            b = mismatch_pack(self.snapshot, self.cfg, ids, block,
                              chunk_rows=VERIFY_ROWS)
            bad = b if bad is None else bad | b
        if bool(bad):
            raise AssertionError(
                "shadow migrate verify FAILED: the staged generation is not "
                "bit-identical to pack() at the snapshot fold state")

    def commit(self, server, staged: PackedStore | None) -> int:
        """Publish the cold generation and flip the hier state (the
        ``commit_retier`` of the synchronous path)."""
        new_cold = self.hier.cold
        if self._cold_needed:
            self.writer.publish()
            new_cold = ColdShards(self.hier.cfg.store_dir)
        elif not self.rp.plan.cold_ids.size:
            new_cold = None
        out = self.hier.commit_retier(self.rp, self.results["hot"],
                                      self.results["warm"], new_cold,
                                      hot_dev=staged)
        server._place()
        return out["crossed"]

    def discard(self) -> None:
        """Remove the unpublished cold tmp dir; the live generation, and
        any mapping of it, stays as it was."""
        if self.writer is not None:
            self.writer.abort()
            self.writer = None
