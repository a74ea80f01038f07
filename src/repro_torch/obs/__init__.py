"""Observability: the streaming latency histogram (port of part of
``repro.obs``; the registry, spans and sinks come with a later slice)."""
