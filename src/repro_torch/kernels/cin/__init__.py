"""xDeepFM CIN layer: port of ``repro.kernels.cin``."""
