"""Production mesh construction.

Port of ``repro/launch/mesh.py``.  Shapes:

    single pod : (data=16, model=16)          = 256 devices
    multi-pod  : (pod=2, data=16, model=16)   = 512 devices

"pod" is the slow-interconnect axis, used as pure data parallelism;
"model" carries TP/EP.  The production meshes are LOGICAL: named axes
and their sizes, no devices (the reference's dry run stands 512 host
devices in for TPUs; the port's runs on ``meta`` tensors, see
``launch/dryrun.py``).  ``make_elastic_mesh`` and ``make_host_mesh``
size the mesh by ``torch.cuda.device_count()`` (the CPU counts as one
device when there is no GPU).

The one-axis ``dist.mesh.Mesh`` that ``dist.packed`` and ``dist.hashed``
loop over is a different object: it holds a device a shard.  The CLIs
build it from ``--device`` and ``--mesh`` through ``device_list`` and
``mesh_from_args``: ``--device`` is one device (every shard on it) or a
comma-separated list of cards, shard ``i`` on the ``i``-th.
"""

from __future__ import annotations

import math

import torch

from repro_torch import resolve_device
from repro_torch.dist.mesh import make_mesh


class LogicalMesh:
    """Named axes and their sizes: what ``dist.ctx`` resolves against and
    what a dry-run cell's specs divide by."""

    def __init__(self, shape, axis_names):
        if len(shape) != len(axis_names):
            raise ValueError(f"{len(shape)} sizes for axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.axis_sizes = tuple(int(s) for s in shape)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return LogicalMesh(shape, axes)


def device_count() -> int:
    """The CUDA devices of this process, or 1 (the CPU) without one."""
    return torch.cuda.device_count() or 1


def make_elastic_mesh(model_parallel: int = 16, pod_size: int = 256
                      ) -> LogicalMesh:
    """The largest (pod, data, model) mesh over the devices present."""
    n = device_count()
    model = math.gcd(model_parallel, n)
    pods = max(1, n // pod_size)
    data = n // (pods * model)
    if pods > 1:
        return LogicalMesh((pods, data, model), ("pod", "data", "model"))
    return LogicalMesh((data, model), ("data", "model"))


def make_host_mesh(model: int = 1) -> LogicalMesh:
    """A (data, model) mesh over the local devices."""
    n = device_count()
    return LogicalMesh((n // model, model), ("data", "model"))


def device_list(spec: str | None) -> list[str]:
    """``--device``'s entries: [None] (the GPU) when it is not given, else
    the comma-separated names as written."""
    if spec is None:
        return [None]
    names = [x.strip() for x in str(spec).split(",")]
    if not all(names):
        raise ValueError(f"--device {spec!r} has an empty entry")
    return names


def card_count(spec: str | None) -> int:
    """How many distinct devices ``--device spec`` names, read from the
    names alone (no card is touched): a bare ``cuda`` is card 0, the
    current device of a fresh process."""
    def key(x):
        d = torch.device("cuda" if x is None else x)
        return d.type, d.index or 0
    return len({key(x) for x in device_list(spec)})


def check_device_arg(ap, args) -> None:
    """Parse-time check of ``--device`` against ``--mesh``: a list of
    several devices needs exactly one a shard (``ap.error`` otherwise)."""
    try:
        names = device_list(args.device)
    except ValueError as e:
        ap.error(str(e))
    if len(names) > 1 and len(names) != args.mesh:
        ap.error(f"--device lists {len(names)} devices for --mesh "
                 f"{args.mesh}: give one device, or one a shard")


def mesh_from_args(spec: str | None, n: int):
    """(device, mesh) of ``--device spec --mesh n``: the run's device (the
    first listed) and None at n = 1, else the n-shard mesh, every shard on
    the one device or shard ``i`` on the ``i``-th listed.  Each device is
    resolved as every entry point resolves it (``resolve_device``: the GPU
    unless the CPU is asked for), and a listed card that is not present
    raises: nothing falls back to fewer cards or to the CPU."""
    devices = [resolve_device(x) for x in device_list(spec)]
    for d in devices:
        if d.type == "cuda" and d.index is not None and (
                d.index >= torch.cuda.device_count()):
            raise RuntimeError(f"{d} is not present: "
                               f"{torch.cuda.device_count()} CUDA devices")
    if len(devices) > 1 and len(devices) != n:
        raise ValueError(f"{len(devices)} devices for a mesh of {n}")
    if n <= 1:
        return devices[0], None
    if len(devices) == 1:
        return devices[0], make_mesh(n, device=devices[0])
    return devices[0], make_mesh(n, devices=devices)
