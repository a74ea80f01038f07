"""Op-level counting of a traced step: FLOPs, HBM bytes, collective bytes
and live temporaries.

The counterpart of ``repro/launch/hlo_analysis.py``.  The reference reads
the optimized HLO of a compiled cell; the port has no HLO, so it counts
the ATen ops that a cell's function runs on ``meta`` tensors (shapes and
dtypes, no data, nothing allocated) under a ``TorchDispatchMode``:

  * matmul FLOPs   ``2 * prod(result) * prod(contracting dims)`` for every
                   ``mm`` / ``addmm`` / ``bmm`` / ``baddbmm`` (``matmul``,
                   ``einsum`` and ``linear`` reach these), the reference's
                   ``dot`` count; backward and recomputation
                   (``torch.utils.checkpoint``) ops are counted as they
                   run, as XLA's are;
  * result bytes   of every op that is not a view, a layout or dtype
                   change, a factory, or one of the elementwise ops the
                   reference's ``FREE_OPS`` names (a TPU compiler fuses
                   them into their consumers): the HBM-traffic proxy;
  * collective bytes by kind, reported by the port's own collectives
                   (``dist.mesh.psum``, ``dist.collectives``' split-KV
                   combine, ``optim.grad_compress``' all-gather) through
                   ``core.op_counter.report_collective``;
  * the peak of the live bytes of results created during the trace (each
    freed when its tensor is), the temporaries;
  * which tensors some op took (``read``), so a caller can leave out the
    arguments a step never reads, as ``jax.jit`` drops unused ones.

A hand-written kernel's op (``kernels/*/ops.py``) on ``meta`` runs
nothing and reports through ``core.op_counter.report_kernel`` the bytes
and operations its roofline bound counts (``PERF.md`` section 6), every
slot's row read once (no data, so no repeats are known).  The hooks live
in ``core.op_counter`` so that the kernels and ``dist`` do not import
this package of entry points.  A Python loop over layers is
counted once an iteration, so ``unknown_trip_whiles`` (the reference's
while loops without a known trip count) is always 0.
"""

from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import op_counter
from repro_torch.core.op_counter import tensors

# views, layout and dtype changes, factories, and the elementwise ops of
# the reference's FREE_OPS (add, multiply, subtract, select, compare,
# exponential, negate, divide, maximum, minimum, rsqrt, tanh, and, or, not)
FREE_OPS = {
    "detach", "alias", "lift_fresh", "lift_fresh_copy", "view", "_unsafe_view",
    "expand", "t", "transpose", "permute", "unsqueeze", "squeeze", "slice",
    "select", "as_strided", "unbind", "split", "split_with_sizes",
    "clone", "copy_", "_to_copy",
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "zeros", "zeros_like", "new_zeros", "ones", "ones_like", "new_ones",
    "full", "full_like", "new_full", "scalar_tensor", "arange", "fill_",
    "zero_", "fill",
    "add", "add_", "mul", "mul_", "sub", "sub_", "rsub", "where",
    "eq", "ne", "lt", "le", "gt", "ge", "exp", "exp_", "neg", "div", "div_",
    "maximum", "minimum", "rsqrt", "tanh", "logical_and", "logical_or",
    "logical_not", "bitwise_and", "bitwise_or", "bitwise_not",
    "masked_fill", "masked_fill_",
}

_MATMULS = {"mm", "addmm", "bmm", "baddbmm"}


@dataclasses.dataclass
class ModuleStats:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    unknown_trip_whiles: int = 0
    peak_live_bytes: int = 0
    kernel_calls: dict = dataclasses.field(
        default_factory=lambda: defaultdict(int))

    def collective_total(self) -> float:
        return float(sum(self.collective.values()))


def _nbytes(t) -> int:
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    if isinstance(t, (list, tuple)):
        return sum(_nbytes(x) for x in t)
    return 0


def matmul_flops(name: str, args, out) -> float:
    """``2 * prod(result) * K`` of one ``mm`` / ``addmm`` / ``bmm`` /
    ``baddbmm`` (K the contracted length)."""
    a = args[1] if name in ("addmm", "baddbmm") else args[0]
    return 2.0 * out.numel() * a.shape[-1]


class OpCounter(TorchDispatchMode):
    """``with OpCounter() as c: fn(*args)`` fills ``c.stats``."""

    def __init__(self):
        super().__init__()
        self.stats = ModuleStats()
        self._live: dict[int, int] = {}
        self._live_bytes = 0
        self.read: set[int] = set()   # ids of the tensors an op took

    def __enter__(self):
        op_counter.active.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        op_counter.active.remove(self)
        return super().__exit__(*exc)

    def _release(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    def _track(self, out) -> None:
        for t in tensors(out):
            key = t.untyped_storage()._cdata
            if key in self._live:
                continue
            n = t.untyped_storage().nbytes()
            self._live[key] = n
            self._live_bytes += n
            weakref.finalize(t, self._release, key)
        self.stats.peak_live_bytes = max(self.stats.peak_live_bytes,
                                         self._live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        for t in tensors(list(args) + list((kwargs or {}).values())):
            self.read.add(id(t))
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in _MATMULS:
            self.stats.flops += matmul_flops(name, args, out)
        if name not in FREE_OPS:
            self.stats.hbm_bytes += _nbytes(out)
        if not any(r.alias_info is not None for r in func._schema.returns):
            self._track(out)
        return out


def analyze(fn, *args) -> tuple[ModuleStats, object]:
    """Run ``fn(*args)`` under an ``OpCounter``: (stats, its result)."""
    with OpCounter() as c:
        out = fn(*args)
    return c.stats, out

