"""Runnable recsys examples (``python -m repro_torch.examples.<name>``):
the port's counterparts of the repository's ``examples/quickstart.py``,
``compress_dlrm.py`` and ``serve_quantized.py``.  Each runs on ``cuda``
unless ``--device cpu`` is given."""
