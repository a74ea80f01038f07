"""Observability: the streaming latency histogram (``registry``) and the
span / wall-clock helpers (``trace``); port of part of ``repro.obs`` (the
counters, gauges, registry recording and sinks come with a later slice)."""

from repro_torch.obs.registry import Histogram  # noqa: F401
from repro_torch.obs.trace import (  # noqa: F401
    Span,
    Timeblock,
    current_path,
    span,
    timeblock,
)
