"""Checkpoint manager: atomic, versioned, async, restart-safe.

Port of ``repro/ckpt/manager.py``, in its on-disk format, so a checkpoint
either package writes restores in the other:

    <dir>/step_<n:010d>/host_0.npz      one array per leaf
    <dir>/step_<n:010d>/manifest.json   written LAST (the atomicity barrier)

Leaves are keyed by the reference's ``jax.tree_util.keystr`` paths
(``.params['embed_table']``, ``.opt[0].mu['net']...``): NamedTuple fields
are ``.name``, dict keys ``['key']`` in sorted order, sequence items
``[i]``; ``None`` is an empty subtree.  npz has no bfloat16, so bf16
leaves are stored as their uint16 bits with ``"bfloat16"`` in the
manifest's ``dtypes`` map.  A save is written to a hidden temp directory
and renamed into place; restore scans versions newest-first and skips
any without a manifest or that fails to load (a crash during save).

``save(..., blocking=False)`` copies every leaf to host memory before it
returns (the train step updates the table in place) and writes in a
daemon thread, one save in flight at a time.  Python scalars and strings
(a store manifest's ``kind`` tag) are 0-d arrays on disk and come back
as the template leaf's type, as in the reference; so a ``packed_store/v1``
or ``hashed_store/v1`` manifest round-trips.  A ``torch.Generator`` leaf
(the generic train step's rng) is stored as its uint8 state and comes
back as a generator on the template's device.

Checkpoints are elastic, as the reference's loop promises: a placed
train state (``dist.packed.RowShards`` leaves, a row shard a device)
saves each row-aligned leaf whole, the same file a mesh-1 save of the
state writes, and ``restore`` places each such leaf onto the template's
mesh, whatever its size, when its axis divides the rows.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import uuid
from typing import Any

import numpy as np
import torch

from repro_torch.dist.packed import RowShards, place_rows


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_paths(tree: Any, prefix: str = ""):
    """(keystr path, leaf) pairs in the reference's flattening order."""
    if tree is None:
        return
    if _is_namedtuple(tree):
        for f in tree._fields:
            yield from tree_paths(getattr(tree, f), f"{prefix}.{f}")
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from tree_paths(x, f"{prefix}[{i}]")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], f"{prefix}[{k!r}]")
    else:
        yield prefix, tree


def _to_host(leaf) -> tuple[np.ndarray, str | None]:
    """A leaf as an npz-storable host copy and its dtype-map entry (a
    ``torch.Generator``, the generic step's rng: its uint8 state; a placed
    ``RowShards`` leaf: the whole, its shards copied into one host array,
    so the file is a mesh-1 save's)."""
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy(), None
    if isinstance(leaf, RowShards):
        t = torch.empty(leaf.shape, dtype=leaf.dtype)
        for shard, (f, r) in zip(leaf.shards, leaf.windows):
            t[f:f + r].copy_(shard.detach())
    elif isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
    else:
        return np.array(leaf), None
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), None


def _rebuild(template: Any, leaves: dict, prefix: str = "") -> Any:
    if template is None:
        return None
    if _is_namedtuple(template):
        return type(template)(*(
            _rebuild(getattr(template, f), leaves, f"{prefix}.{f}")
            for f in template._fields))
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(x, leaves, f"{prefix}[{i}]")
                              for i, x in enumerate(template))
    if isinstance(template, dict):
        return {k: _rebuild(v, leaves, f"{prefix}[{k!r}]")
                for k, v in template.items()}
    return leaves[prefix]


def _host_tensor(key: str, arr: np.ndarray, dtype_name: str | None,
                 shape, dtype: torch.dtype) -> torch.Tensor:
    """A stored array as a host tensor, its shape and dtype checked
    against the template leaf's."""
    if dtype_name is not None:
        if dtype_name != "bfloat16":
            raise TypeError(f"{key}: stored dtype {dtype_name} is not "
                            "supported by the port")
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr if arr.flags.writeable else np.array(arr))
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"shape mismatch for {key}: ckpt "
                         f"{tuple(t.shape)} vs template {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"dtype mismatch for {key}: ckpt {t.dtype} vs "
                        f"template {dtype}")
    return t


def _restore_leaf(key: str, arr: np.ndarray, dtype_name: str | None,
                  leaf) -> Any:
    if isinstance(leaf, torch.Generator):
        gen = torch.Generator(device=leaf.device)
        gen.set_state(torch.from_numpy(np.array(arr, dtype=np.uint8)))
        return gen
    if isinstance(leaf, RowShards):
        # elastic: the whole leaf placed onto the template's mesh
        return place_rows(_host_tensor(key, arr, dtype_name, leaf.shape,
                                       leaf.dtype), leaf.mesh, leaf.axis)
    if isinstance(leaf, torch.Tensor):
        return _host_tensor(key, arr, dtype_name, leaf.shape,
                            leaf.dtype).to(leaf.device)
    if dtype_name is not None:
        raise TypeError(f"{key}: a {dtype_name} array for a "
                        f"{type(leaf).__name__} leaf")
    if isinstance(leaf, (int, float, bool)):
        return type(leaf)(arr.item())
    if isinstance(leaf, str):
        return str(arr.item())
    return np.array(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._last_error: Exception | None = None
        # one entry a published save: step, bytes on disk, seconds to
        # copy the leaves to host memory and to write them
        self.writes: list[dict] = []

    # ------------------------------------------------------------------ save

    def save(self, step: int, tree: Any, blocking: bool = True,
             extra: dict | None = None) -> None:
        """Checkpoint ``tree`` at ``step``.  Atomic: manifest written last."""
        self.wait()                               # one save in flight
        t0 = time.perf_counter()
        flat, dtypes = {}, {}
        for key, leaf in tree_paths(tree):            # host snapshot NOW
            flat[key], dt = _to_host(leaf)
            if dt is not None:
                dtypes[key] = dt
        snapshot_s = time.perf_counter() - t0

        def _write():
            try:
                t1 = time.perf_counter()
                tmp = os.path.join(
                    self.dir, f".tmp_{step}_{uuid.uuid4().hex[:8]}")
                final = os.path.join(self.dir, f"step_{step:010d}")
                os.makedirs(tmp, exist_ok=True)
                np.savez(os.path.join(tmp, "host_0.npz"), **flat)
                manifest = {"step": step, "keys": sorted(flat),
                            "dtypes": dtypes,
                            "treedef": type(tree).__name__,
                            "time": time.time(), "extra": extra or {},
                            "num_hosts": 1}
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)             # atomic publish
                self.writes.append({
                    "step": step,
                    "bytes": os.path.getsize(
                        os.path.join(final, "host_0.npz")),
                    "snapshot_s": snapshot_s,
                    "write_s": time.perf_counter() - t1})
                self._gc()
            except Exception as e:                # surfaced on next wait()
                self._last_error = e

        if blocking:
            _write()
            self.wait()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._last_error:
            err, self._last_error = self._last_error, None
            raise err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: int | None = None
                ) -> tuple[Any, int]:
        """Restore into the structure of ``template``: each tensor leaf
        comes back on the template leaf's device, with its shape and
        dtype checked.  Scans newest-first past corrupt checkpoints;
        raises FileNotFoundError if nothing valid exists."""
        steps = self.all_steps()
        if step is not None:
            steps = [s for s in steps if s == step]
        for s in reversed(steps):
            try:
                return self._restore_one(template, s), s
            except Exception:
                continue
        raise FileNotFoundError(f"no valid checkpoint in {self.dir}")

    def _restore_one(self, template: Any, step: int) -> Any:
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        dtypes = manifest.get("dtypes", {})
        leaves = {}
        with np.load(os.path.join(path, "host_0.npz")) as data:
            for key, leaf in tree_paths(template):
                if key not in data:
                    raise KeyError(f"checkpoint missing {key}")
                leaves[key] = _restore_leaf(key, data[key], dtypes.get(key),
                                            leaf)
        return _rebuild(template, leaves)
