"""Fused hashed gather-and-combine over a chunk pool: port of
``repro.kernels.hashed_gather`` (ROBE-style compositional rows)."""
