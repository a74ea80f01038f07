"""Fused dequant embedding-bag: port of ``repro.kernels.dequant_bag``."""
