"""Fused dequant-bag -> first matmul: port of ``repro.kernels.bag_matmul``."""
