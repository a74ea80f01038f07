"""Synthetic data (numpy-only copies of ``repro.data``)."""
