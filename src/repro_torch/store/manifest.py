"""Cold level: mmap'd tier-partitioned shard files under a ``hier_store/v1``
manifest, and the host dequant shared by every spill level.

Port of ``repro/store/manifest.py``, in the same on-disk format, so a
store directory written by either package opens in the other.  Each
shard is a ``PackedStore`` over a contiguous slice of the cold rows
(cold-local order): six raw ``.npy`` files a shard directory
(``payload8``, ``scale8``, ``payload16``, ``scale16``, ``payload32``,
``indirect``), mapped back with ``np.load(..., mmap_mode="c")`` so a cold
gather reads only the pages of the rows it touches (copy-on-write: the
arrays are writable, so ``torch.from_numpy`` shares them without a copy,
and nothing is ever written back).  bf16 payloads are stored as their
raw uint16 bits (numpy has no bfloat16) with the dtype named in the
manifest.  The manifest, written last, pins the format::

    {"schema": "hier_store/v1", "dim": D, "rows": N,
     "rows_per_shard": R, "payload16_dtype": "bfloat16",
     "tier_counts": [n8, n16, n32], "nbytes": {...},
     "shards": [{"dir": "shard_00000", "rows": R}, ...]}

plus ``row_ids.npy`` (the global id of every cold-local row, ascending).

``np_lookup`` is the host mirror of ``packed_store.lookup``: int8 / bf16 /
fp16 widened to fp32 and one fp32 multiply by the scale, each correctly
rounded, so staged rows are bit-identical to what the device gather
returns for them.  The host levels are the port's ``PackedStore`` with CPU
tensors (``extract_rows`` / ``merge_stores`` cut and join them);
``np_lookup`` reads their leaves as numpy views.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import uuid

import numpy as np
import torch

from repro_torch.core.packed_store import (_IDX_MASK, _TIER_SHIFT,
                                           PackedStore, extract_rows,
                                           live_counts, merge_stores)

SCHEMA = "hier_store/v1"
MANIFEST = "manifest.json"
_FIELDS = ("payload8", "scale8", "payload16", "scale16", "payload32",
           "indirect")
# the half payload's dtype names in the manifest
_HALF_NAMES = {torch.bfloat16: "bfloat16", torch.float16: "float16"}


def _as_numpy(leaf) -> np.ndarray:
    """A CPU leaf as a numpy view (no copy): a bf16 tensor (or numpy's
    2-byte bfloat16 extension dtype) as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16)
        return leaf.numpy()
    a = np.asarray(leaf)
    return a.view(np.uint16) if a.dtype.kind == "V" else a


def _widen(rows: np.ndarray) -> np.ndarray:
    """Payload rows as fp32, exactly: uint16 holds bf16 bits."""
    if rows.dtype == np.uint16:
        return (rows.astype(np.uint32) << 16).view(np.float32)
    return rows.astype(np.float32)


def np_lookup(packed: PackedStore, local_ids) -> np.ndarray:
    """Host dequantizing gather over a store with CPU leaves (tensors or
    numpy), bit-identical to ``packed_store.lookup``: int (N,) -> fp32
    (N, D), numpy.  In numpy, as the reference's: a cold gather calls it
    once a shard, and numpy's per-call cost is a fraction of torch's."""
    p8, s8, p16, s16, p32, ind = (_as_numpy(x) for x in packed)
    ids = np.asarray(local_ids, np.int64).reshape(-1)
    out = np.empty((ids.size, p32.shape[-1]), np.float32)
    if not ids.size:
        return out
    code = ind[ids]
    tier = code >> _TIER_SHIFT
    loc = (code & _IDX_MASK).astype(np.int64)
    for t, (payload, scale) in enumerate(((p8, s8), (p16, s16),
                                          (p32, None))):
        m = tier == t
        if not m.any():
            continue
        li = loc[m]
        rows = _widen(payload[li])
        if scale is not None:
            rows *= scale[li, None]
        out[m] = rows
    return out


def _save_leaf(path: str, leaf: torch.Tensor) -> str | None:
    """Write one leaf as raw ``.npy``; a bf16 payload goes to disk as its
    uint16 bits.  Returns the half dtype's name for a half payload."""
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        np.save(path, t.view(torch.int16).numpy().view(np.uint16))
    else:
        np.save(path, t.numpy())
    return _HALF_NAMES.get(t.dtype)


def _load_leaf(path: str, half: torch.dtype | None = None) -> torch.Tensor:
    """An mmap'd leaf as a CPU tensor over the mapping (bf16 from its
    uint16 bits when ``half`` says so)."""
    a = np.load(path, mmap_mode="c")
    if half == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def publish_dir(tmp: str, store_dir: str) -> None:
    """Atomic publish of a fully written generation directory: move the
    previous generation aside, rename the new one in, then delete the old
    (open mappings of the old files stay valid until they are dropped).
    A crash between the two renames leaves ``store_dir`` absent and the
    previous generation intact under ``.old_*``, which ``ColdShards``
    recovers."""
    old = None
    if os.path.exists(store_dir):
        old = f"{store_dir}.old_{uuid.uuid4().hex[:8]}"
        os.rename(store_dir, old)
    os.rename(tmp, store_dir)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)


class ShardWriter:
    """Incremental cold-generation writer: one shard a ``write_next``
    call, the manifest and an atomic publish at the end.

    The chunked sibling of ``write_cold_shards``: the shadow migration
    (``serve.shadow.ShadowMigrate``) writes one shard a serve step, then
    publishes at the swap.  Everything is written inside a hidden tmp dir
    beside ``store_dir``; until ``publish()`` the live generation is
    untouched, and ``abort()`` removes the tmp dir without a trace.
    ``cold`` is a ``PackedStore`` with CPU leaves, position ``i`` = global
    row ``row_ids[i]``.
    """

    def __init__(self, store_dir: str, cold: PackedStore, row_ids,
                 rows_per_shard: int = 4096):
        self.store_dir = store_dir
        self.cold = cold
        self.row_ids = np.asarray(row_ids, np.int64)
        self.rows = int(cold.indirect.shape[0])
        self.rows_per_shard = max(1, int(rows_per_shard))
        self.num_shards = (-(-self.rows // self.rows_per_shard)
                           if self.rows else 0)
        self.tmp = os.path.join(
            os.path.dirname(os.path.abspath(store_dir)) or ".",
            f".tmp_hier_{uuid.uuid4().hex[:8]}")
        os.makedirs(self.tmp, exist_ok=True)
        self._next = 0
        self._p16_dtype = None
        self._published = False

    @property
    def shards_left(self) -> int:
        return self.num_shards - self._next

    def write_next(self) -> bool:
        """Write one shard; True while shards remain after this call."""
        k = self._next
        if k >= self.num_shards:
            return False
        r0 = k * self.rows_per_shard
        r1 = min((k + 1) * self.rows_per_shard, self.rows)
        sub = extract_rows(self.cold, torch.arange(r0, r1))
        sdir = os.path.join(self.tmp, f"shard_{k:05d}")
        os.makedirs(sdir)
        for f in _FIELDS:
            name = _save_leaf(os.path.join(sdir, f + ".npy"),
                              getattr(sub, f))
            if f == "payload16":
                self._p16_dtype = name
        self._next = k + 1
        return self._next < self.num_shards

    def publish(self) -> dict:
        """Write the remaining shards, then the manifest last, and swap the
        generation in atomically.  Returns the manifest."""
        while self._next < self.num_shards:
            self.write_next()
        np.save(os.path.join(self.tmp, "row_ids.npy"), self.row_ids)
        manifest = {
            "schema": SCHEMA,
            "dim": int(self.cold.payload32.shape[-1]),
            "rows": self.rows,
            "rows_per_shard": self.rows_per_shard,
            "payload16_dtype": (self._p16_dtype
                                or _HALF_NAMES[self.cold.payload16.dtype]),
            "tier_counts": [int(c) for c in live_counts(self.cold)],
            "nbytes": self.cold.nbytes(by_tier=True),
            "shards": [{"dir": f"shard_{k:05d}",
                        "rows": int(min((k + 1) * self.rows_per_shard,
                                        self.rows)
                                    - k * self.rows_per_shard)}
                       for k in range(self.num_shards)],
        }
        with open(os.path.join(self.tmp, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
        publish_dir(self.tmp, self.store_dir)
        self._published = True
        return manifest

    def abort(self) -> None:
        """Discard the unpublished generation (idempotent; nothing to do
        after ``publish``, whose tmp dir is gone)."""
        if not self._published:
            shutil.rmtree(self.tmp, ignore_errors=True)


def write_cold_shards(store_dir: str, cold: PackedStore, row_ids,
                      rows_per_shard: int = 4096) -> dict:
    """Serialize ``cold`` (CPU leaves, position ``i`` = global row
    ``row_ids[i]``) into ``store_dir`` atomically: the shards land in a
    tmp dir, the manifest is written last, one rename publishes.  Returns
    the manifest."""
    return ShardWriter(store_dir, cold, row_ids, rows_per_shard).publish()


class ColdShards:
    """An open cold level: the manifest and one mmap'd ``PackedStore`` a
    shard.

    Rows are addressed by cold-local id; gathers group the ids by shard
    (one stable sort) and index each shard's mapping once, so only the
    pages of the rows touched are read.  The files are immutable between
    migrations: a migration that changes the cold set writes a new
    generation and publishes it atomically.
    """

    def __init__(self, store_dir: str):
        self.dir = store_dir
        if not os.path.exists(os.path.join(store_dir, MANIFEST)):
            self._recover(store_dir)
        with open(os.path.join(store_dir, MANIFEST)) as f:
            self.manifest = json.load(f)
        if self.manifest.get("schema") != SCHEMA:
            raise ValueError(f"{store_dir}: schema "
                             f"{self.manifest.get('schema')!r} != {SCHEMA!r}")
        self.rows = int(self.manifest["rows"])
        self.rows_per_shard = int(self.manifest["rows_per_shard"])
        self.row_ids = np.load(os.path.join(store_dir, "row_ids.npy"))
        name = self.manifest["payload16_dtype"]
        half = {v: k for k, v in _HALF_NAMES.items()}.get(name)
        if half is None:
            raise ValueError(f"{store_dir}: unknown payload16_dtype {name!r}")
        self._shards = []
        for s in self.manifest["shards"]:
            sdir = os.path.join(store_dir, s["dir"])
            self._shards.append(PackedStore(**{
                f: _load_leaf(os.path.join(sdir, f + ".npy"),
                              half if f == "payload16" else None)
                for f in _FIELDS}))

    @staticmethod
    def _recover(store_dir: str) -> None:
        """Crash recovery: a kill between ``publish_dir``'s two renames
        leaves ``store_dir`` absent and the previous generation under
        ``<store_dir>.old_*``: move the newest complete one back."""
        cands = [d for d in sorted(glob.glob(f"{store_dir}.old_*"),
                                   key=os.path.getmtime)
                 if os.path.exists(os.path.join(d, MANIFEST))]
        if not cands or os.path.exists(store_dir):
            return
        os.rename(cands[-1], store_dir)

    @property
    def num_shards(self) -> int:
        return len(self._shards)

    def nbytes(self) -> int:
        return int(sum(self.manifest["nbytes"].values()))

    def _by_shard(self, local_ids):
        """[(shard, positions (ascending), shard-local ids)] for the
        shards the ids touch, in shard order."""
        ids = np.asarray(local_ids, np.int64).reshape(-1)
        shard = ids // self.rows_per_shard
        order = np.argsort(shard, kind="stable")
        ranked = shard[order]
        starts = np.concatenate(([0], np.flatnonzero(np.diff(ranked)) + 1)
                                ) if ids.size else np.zeros(0, np.int64)
        ends = np.append(starts[1:], ids.size)
        return [(int(ranked[s]), order[s:e],
                 ids[order[s:e]] % self.rows_per_shard)
                for s, e in zip(starts, ends)]

    def gather_fp32(self, local_ids) -> np.ndarray:
        """Dequantized fp32 rows for cold-local ids (any order), numpy."""
        n = np.asarray(local_ids).size
        out = np.empty((n, int(self.manifest["dim"])), np.float32)
        for k, pos, loc in self._by_shard(local_ids):
            out[pos] = np_lookup(self._shards[k], loc)
        return out

    def extract(self, local_ids) -> PackedStore:
        """The quantized sub-store over cold-local ids, in the given order
        (promotion: the bytes move levels untouched), CPU leaves."""
        groups = self._by_shard(local_ids)
        n = np.asarray(local_ids).size
        if not groups:
            return extract_rows(self._shards[0],
                                torch.zeros((0,), dtype=torch.int64))
        parts, perm, base = [], np.empty(n, np.int64), 0
        for k, pos, loc in groups:
            parts.append(extract_rows(self._shards[k], torch.from_numpy(loc)))
            perm[pos] = base + np.arange(pos.size)
            base += pos.size
        return extract_rows(merge_stores(parts), torch.from_numpy(perm))
