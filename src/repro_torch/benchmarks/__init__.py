"""The port's benchmarks, ports of the top-level ``benchmarks`` package:
``common`` (the bench DLRM, its training drivers and ``eval_auc``),
``qps`` (the online ``bench_qps/v1`` record), the paper's tables and
figures (``table2_time``, ``table3_fquant``, ``fig3_thresholds``,
``table4_combined``, ``fig2_fperm``, ``freq_error``) and their runner,
``run``."""
