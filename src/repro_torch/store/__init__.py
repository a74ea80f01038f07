"""Embedding-store backends (port of ``repro.store``: the flat packed
backend; the hier and hashed backends come with later slices)."""
