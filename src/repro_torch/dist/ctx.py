"""Process-global SPMD context: logical axis names -> mesh axes.

Port of ``repro/dist/ctx.py``.  Model code annotates activations with
LOGICAL axis names:

    ctx.configure(mesh, batch=("pod", "data"), tp="model")
    x = ctx.constrain(x, "batch", None, None)      # (B, T, D)

Logical names: ``"batch"`` (the configured data-parallel axis or axis
tuple), ``"tp"`` (the tensor-parallel axis), ``None`` (replicated), ``UNC``
(left to the partitioner), any other string (a mesh axis name, passed
through).  ``resolve`` / ``spec`` translate them to ``PartitionSpec``
entries as the reference does, dropping an axis that does not divide
its dimension to ``None`` (the same model code resolves on a 512-chip
mesh and on a 4-device one).

The port has no partitioner: the single controller places data itself
(as ``dist.packed`` does), so ``constrain`` checks and returns ``x``
unchanged.  Unconfigured it is an exact identity; configured it raises
on a rank mismatch, as the reference's does, so the models' annotations
(``models/attention.py``, ``moe.py``, ``transformer.py``) are held to
their tensors' ranks under the dry run (``launch/dryrun.py``).
"""

from __future__ import annotations


class _Unconstrained:
    """Sentinel: leave this dimension's sharding to the partitioner."""

    def __repr__(self) -> str:
        return "UNC"


UNC = _Unconstrained()


class PartitionSpec(tuple):
    """A sharding spec: one entry a dimension, each ``None`` (replicated),
    a mesh axis name, a tuple of names (one name: that name), or
    ``UNCONSTRAINED``.  Trailing dimensions past the entries are
    replicated; ``PartitionSpec()`` is fully replicated.  The counterpart
    of ``jax.sharding.PartitionSpec``, and compared as a plain tuple of
    its entries."""

    UNCONSTRAINED = UNC

    def __new__(cls, *entries):
        # a one-axis tuple is that axis, as JAX normalises it
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec

_mesh = None
_batch = None
_tp = "model"


def configure(mesh, batch="data", tp: str = "model") -> None:
    """Install the process-global mesh and logical-axis bindings.

    mesh: anything with a ``shape`` dict of axis sizes (a
    ``launch.mesh.LogicalMesh``).  batch: the mesh axis name or tuple of
    names carrying data parallelism.  tp: the tensor-parallel axis name.
    """
    global _mesh, _batch, _tp
    _mesh, _batch, _tp = mesh, batch, tp


def unconfigure() -> None:
    """Return to the single-device identity state."""
    global _mesh, _batch
    _mesh, _batch = None, None


def configured() -> bool:
    return _mesh is not None


def mesh():
    return _mesh


def _axis_size(axis) -> int:
    axes = axis if isinstance(axis, tuple) else (axis,)
    n = 1
    for a in axes:
        n *= _mesh.shape.get(a, 1)
    return n


def resolve(logical, dim: int | None = None):
    """One logical entry -> a ``PartitionSpec`` entry (with the
    divisibility guard when ``dim`` is given)."""
    if logical is UNC:
        return PartitionSpec.UNCONSTRAINED
    if logical is None:
        return None
    axis = _batch if logical == "batch" else (
        _tp if logical == "tp" else logical)
    if axis is None:
        return None
    if dim is not None and dim % _axis_size(axis) != 0:
        return None
    return axis


def spec(*logical_axes, shape=None) -> PartitionSpec:
    """Resolve a full logical spec (``shape`` enables the divisibility
    guard)."""
    dims = shape if shape is not None else (None,) * len(logical_axes)
    return PartitionSpec(*(resolve(ax, d)
                           for ax, d in zip(logical_axes, dims)))


def constrain(x, *logical_axes):
    """``x`` unchanged.  Unconfigured, nothing else happens; configured,
    one logical entry a dimension of ``x`` is required (``ValueError``
    otherwise, the reference's check) and the spec is resolved against
    the mesh."""
    if _mesh is None:
        return x
    if len(logical_axes) != x.ndim:
        raise ValueError(
            f"constrain: got {len(logical_axes)} axes for rank-{x.ndim} "
            f"array of shape {tuple(x.shape)}")
    spec(*logical_axes, shape=tuple(x.shape))
    return x
