"""A one-axis device mesh: the port's counterpart of ``jax.make_mesh((n,),
("model",))``.

The reference drives N devices from one process through ``shard_map``
(its CPU tests fake the devices with ``--xla_force_host_platform_device_
count``).  The port keeps that single-controller design: a ``Mesh`` is N
shards, each on a device, and the sharded paths (``dist.packed``,
``dist.hashed``) loop over the shards in one process.  ``make_mesh(n)``
puts all N shards on one device (the CPU tests, the one H100): each
shard's rows are then a view of the store, and N logical shards launch N
kernels whose partial outputs ``psum`` adds.  ``make_mesh(n,
devices=[...])`` puts one shard on each listed device.

``mesh.shape[axis]`` is N, so code that reads the reference's
``mesh.shape[axis]`` ports line for line.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import torch

from repro_torch import resolve_device


def _indexed(device) -> torch.device:
    """``device`` with its index: ``cuda`` is the current CUDA device, so
    that a shard on ``cuda`` and a tensor on ``cuda:0`` share a device."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """N shards along one named axis; shard ``i`` lives on
    ``devices[i]``."""

    def __init__(self, devices: Sequence, axis: str = "model"):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(_indexed(d) for d in devices)
        self.axis = axis

    @property
    def shape(self) -> dict:
        return {self.axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The first shard's device: where ``psum`` leaves the sum."""
        return self.devices[0]

    def shards_per_device(self) -> int:
        """The most shards one device holds: N on one device, 1 with one
        shard a device."""
        return max(self.devices.count(d) for d in self.devices)

    def distinct_devices(self) -> list[torch.device]:
        """The mesh's devices, each once, in shard order."""
        out = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out


def make_mesh(n: int, axis: str = "model", device=None,
              devices: Sequence | None = None) -> Mesh:
    """An ``n``-shard mesh along ``axis``: all shards on ``device``
    (default the GPU, as every entry point of the port; ``"cpu"`` for the
    CPU), or one shard on each of ``devices``."""
    if n < 1:
        raise ValueError(f"a mesh needs n >= 1 shards, got {n}")
    if devices is not None:
        if len(devices) != n:
            raise ValueError(f"{len(devices)} devices for a mesh of {n}")
        return Mesh([resolve_device(d) for d in devices], axis)
    return Mesh([resolve_device(device)] * n, axis)


def check_mesh(mesh, axis: str = "model") -> int:
    """The shard count of ``mesh`` along ``axis``; raises for anything that
    is not a ``Mesh`` along that axis."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a repro_torch.dist.Mesh, got "
                        f"{type(mesh).__name__}")
    if mesh.axis != axis:
        raise ValueError(f"mesh axis is {mesh.axis!r}, expected {axis!r}")
    return mesh.size


def psum(parts: Iterable[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The shards' partial outputs summed in shard order on the mesh's
    first device: ``((p0 + p1) + p2) + ...``, into the first partial in
    place (``parts`` may be a generator: one partial besides the sum
    exists at a time).  A shard contributes exact zeros where it owns
    nothing, so a sum in which one shard owns each element is exact in
    any order."""
    out = None
    for p in parts:
        p = p.to(mesh.device)
        out = p if out is None else out.add_(p)
    if out is None:
        raise ValueError("psum of no partials")
    return out
