"""The port's benchmarks: ``common`` (the bench DLRM setup) and ``qps``
(the online ``bench_qps/v1`` record), ports of ``benchmarks/common.py``
and ``benchmarks/qps.py``."""
