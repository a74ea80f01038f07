"""The hooks through which the port's kernel ops and collectives report to
an active op counter (``launch.op_analysis.OpCounter``, the dry run's).

They live here, below the kernels and ``dist``, so that those layers do
not import the package of entry points.  With no counter active every
hook is a no-op.
"""

from __future__ import annotations

import torch

# the counters now counting, innermost last (``OpCounter`` enters and
# leaves this list)
active: list = []


def counting() -> bool:
    """Some counter is active."""
    return bool(active)


def tensors(t):
    """The tensors in ``t``: a tensor, or lists and tuples of them."""
    if isinstance(t, torch.Tensor):
        yield t
    elif isinstance(t, (list, tuple)):
        for x in t:
            yield from tensors(x)


def on_meta(t: torch.Tensor) -> bool:
    """``t`` is on ``meta``: a kernel op then runs nothing and reports its
    bound instead (a test may patch this to let ``meta`` stand in for a
    CUDA tensor on a machine without one)."""
    return t.device.type == "meta"


def report_kernel(name: str, inputs=(), *, nbytes: float = 0.0,
                  flops: float = 0.0) -> None:
    """A hand-written kernel's op ran on ``meta``: add its bound's bytes
    and operations to every active counter, and mark the tensors it took
    (``inputs``, ``None`` entries skipped) as read."""
    for c in active:
        c.stats.hbm_bytes += nbytes
        c.stats.flops += flops
        c.stats.kernel_calls[name] += 1
        c.read.update(id(t) for t in tensors(list(inputs)))


def report_collective(kind: str, nbytes: float) -> None:
    """One of the port's collectives moved ``nbytes`` (its result's
    bytes, as the reference counts a collective op)."""
    for c in active:
        c.stats.collective[kind] += nbytes


def meta_like(shape, dtype=torch.float32) -> torch.Tensor:
    """An output of a kernel's op on ``meta``: shape and dtype only."""
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                       device="meta")
