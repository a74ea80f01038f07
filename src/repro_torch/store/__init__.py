"""Embedding-store backends (port of ``repro.store``: the flat packed and
the ROBE-style hashed backends and their registry; the hier backend
comes with a later slice)."""
