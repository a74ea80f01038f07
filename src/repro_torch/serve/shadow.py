"""Shadow-store re-tiering: a copy-on-write repack off the request path.

Port of the flat half of ``repro/serve/shadow.py``.  The synchronous
re-tier (``packed_store.repack_delta``) stalls the request that runs it
for the whole rebuild.  ``ShadowRepack`` splits it into a shadow
generation built in bounded chunks while requests keep reading the live
store, then swapped in with one pointer flip (``serve.online``):

    begin    snapshot the fold state (``QATStore`` is an immutable
             NamedTuple and the fold returns a new priority tensor, so
             keeping the reference is the snapshot) and freeze the mover
             set against it
    chunk    each step quantizes at most a row budget of movers
             (``quantize_rows``, row-wise, so chunking changes no byte);
             the live store is never written
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

Not ported yet: ``ShadowMigrate``, the hierarchical twin (ROADMAP Queue 1
item 8).
"""

from __future__ import annotations

import torch

from repro_torch.core import packed_store as ps
from repro_torch.core.packed_store import (PackedStore, extract_rows,
                                           merge_stores)
from repro_torch.core.qat_store import FQuantConfig, QATStore, current_tiers

# rows of one verify block: bounds the two fp32 unpacks held at a time
# (the full-width wide&deep table unpacked whole is 2.84 GB, twice)
VERIFY_ROWS = 1 << 20


class ShadowRepack:
    """Chunked copy-on-write twin of ``repack_delta`` for the flat store.

    Freezes the mover set once (rows whose packed tier differs from the
    snapshot's Eq. 8 tier), quantizes it in bounded steps
    (``quantize_rows``) and assembles the final store in one O(V) step:
    surviving rows carry their live bytes (``extract_rows``), the
    quantized chunks append (``merge_stores``), a permutation restores
    global-id addressing.  The live store is read, never written.
    """

    def __init__(self, packed: PackedStore, snapshot: QATStore,
                 cfg: FQuantConfig):
        self.live = packed
        self.snapshot = snapshot
        self.cfg = cfg
        self.table = snapshot.table
        old = ps.packed_tiers(packed).to(torch.int64)
        self.new_tiers = current_tiers(snapshot, cfg).to(torch.int64)
        self.movers = torch.nonzero(old != self.new_tiers).reshape(-1)
        self._n = int(self.movers.numel())
        self.pos = 0
        self._chunks: list[PackedStore] = []
        self.result: PackedStore | None = None

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
        """Quantize the next ``budget`` (>= 1) movers in one
        ``quantize_rows`` call, and materialize the final store when the
        mover set drains.  Returns ``staged``.  (The reference quantizes
        a step in sub-chunks padded to one shape for XLA's compile cache;
        eager torch has none to fill, and the leaves are the same.)"""
        if self.result is not None:
            return True
        take = min(max(int(budget), 1), self._n - self.pos)
        if take > 0:
            chunk = self.movers[self.pos:self.pos + take]
            self._chunks.append(ps.quantize_rows(self.table, chunk,
                                                 self.new_tiers, self.cfg))
            self.pos += take
        if self.pos >= self._n:
            self.result = self.materialize()
        return self.result is not None

    def materialize(self) -> PackedStore:
        """The store as if swapped now: processed movers re-tiered, every
        other row (the movers not reached yet included) with its live
        bytes.  Its ``unpack`` equals that of ``repack_delta(live,
        snapshot, cfg, movers[:pos])``; its leaves equal the reference's.
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
        merged = merge_stores([extract_rows(self.live, keep)]
                              + self._chunks)
        del keep, mask
        return extract_rows(merged, perm)

    def place(self) -> PackedStore:
        """The finished store, already on the serving device (the
        reference transfers its host result here)."""
        return self.result

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
        """Flip the server's live store to the shadow generation."""
        server.backend.packed = self.place() if staged is None else staged
        return self.moved

    def discard(self) -> None:
        """Nothing to undo for the flat store: dropping the object is the
        whole discard, the live store was never written."""
