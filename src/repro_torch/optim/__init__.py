"""Optimizers: Adam for the dense params, row-wise adagrad for the table
(``rowwise_adagrad_table_update``, in place) and as a tree optimizer
(``rowwise_adagrad``, the paper-table benchmarks')."""

from repro_torch.optim.optimizers import (  # noqa: F401
    AdagradState,
    Optimizer,
    adam,
    apply_updates,
    rowwise_adagrad,
    rowwise_adagrad_table_update,
)
