"""Span tracing and the one shared wall-clock helper.

Port of ``repro/obs/trace.py``.  ``timeblock(name)`` is the timing idiom
of the serve, train and pipeline loops: it always measures (the loops
need wall time whether or not metrics are on), and ``tb.sync(value)``
is the one sync point, a synchronize of the calling thread's current
stream on the device that holds ``value`` (a tensor, or a tuple, list or
dict holding tensors), so device work drains inside the clock:

    with timeblock("serve.request") as tb:
        out = serve_fn(batch)
        tb.sync(out)
    lat_seconds = tb.seconds

Only the registry recording of ``timeblock`` is gated: with metrics
enabled it records ``<name>_us`` into the current registry
(``registry.get_registry``).

``span(name)`` times a stage into histogram ``<name>_us`` and tracks the
nesting path (``Span.path`` is ``"parent/child"``, a thread-local stack,
popped and recorded even when the body raises).  While the registry is
disabled, ``span`` returns a shared no-op singleton: one flag check, no
allocation, no clock and no sync (its ``sync`` returns the value
untouched), so an instrumented request path costs nothing until a
driver turns metrics on.
"""

from __future__ import annotations

import threading
import time

import torch

from repro_torch.obs import registry as _reg

_tls = threading.local()


def _stack() -> list:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def _first_tensor(value):
    if isinstance(value, torch.Tensor):
        return value
    items = value.values() if isinstance(value, dict) else (
        value if isinstance(value, (tuple, list)) else ())
    for x in items:
        t = _first_tensor(x)
        if t is not None:
            return t
    return None


def _sync(value):
    """Wait for the work this thread queued on the device of ``value``
    (its current stream; None, or no CUDA tensor in it, is a no-op) so
    the enclosing clock measures finished work, not dispatch."""
    t = _first_tensor(value) if value is not None else None
    if t is not None and t.device.type == "cuda":
        torch.cuda.current_stream(t.device).synchronize()
    return value


class Span:
    """Timed stage: records ``<name>_us`` on exit (even on exception)."""

    __slots__ = ("name", "path", "seconds", "_t0")

    def __init__(self, name: str):
        self.name = name
        self.path = name
        self.seconds = 0.0

    def __enter__(self) -> "Span":
        s = _stack()
        s.append(self.name)
        self.path = "/".join(s)
        self._t0 = time.perf_counter()
        return self

    def sync(self, value):
        return _sync(value)

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.seconds = time.perf_counter() - self._t0
        s = _stack()
        if s and s[-1] == self.name:
            s.pop()
        reg = _reg.get_registry()
        if reg.enabled:
            reg.observe(self.name + "_us", self.seconds * 1e6)
        return False


class _NullSpan:
    """Disabled-mode singleton: no clock, no stack, no recording."""

    __slots__ = ()
    name = path = ""
    seconds = 0.0

    def __enter__(self):
        return self

    @staticmethod
    def sync(value):
        return value

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL_SPAN = _NullSpan()


def span(name: str):
    """Context manager timing one stage into histogram ``<name>_us``;
    the shared no-op ``_NULL_SPAN`` while the registry is disabled."""
    if not _reg.get_registry().enabled:
        return _NULL_SPAN
    return Span(name)


def current_path() -> str:
    """The active span path ("a/b/c"), "" outside any span."""
    return "/".join(_stack())


class Timeblock:
    """Always-on wall clock (``seconds`` after exit); registry recording
    of ``<name>_us`` only when metrics are enabled."""

    __slots__ = ("name", "seconds", "_t0")

    def __init__(self, name: str | None = None):
        self.name = name
        self.seconds = 0.0

    def __enter__(self) -> "Timeblock":
        self._t0 = time.perf_counter()
        return self

    def sync(self, value):
        return _sync(value)

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.seconds = time.perf_counter() - self._t0
        if self.name is not None:
            reg = _reg.get_registry()
            if reg.enabled:
                reg.observe(self.name + "_us", self.seconds * 1e6)
        return False

    # for regions that do not nest as a ``with`` block (pipeline stages
    # threaded through straight-line code)
    def start(self) -> "Timeblock":
        return self.__enter__()

    def stop(self) -> float:
        self.__exit__(None, None, None)
        return self.seconds


def timeblock(name: str | None = None) -> Timeblock:
    return Timeblock(name)
