"""Optimizers: Adam for the dense params, row-wise adagrad for the table."""
