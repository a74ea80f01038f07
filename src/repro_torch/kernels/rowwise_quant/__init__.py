"""Fused row-wise int8 quantization: port of
``repro.kernels.rowwise_quant``."""
