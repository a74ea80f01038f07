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
loop over is a different object: it holds a device a shard.
"""

from __future__ import annotations

import math

import torch


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
