"""Optimizers and gradient compression.

``optimizers`` (port of ``repro/optim/optimizers.py``): Adam for the
dense params, row-wise adagrad for the table (``rowwise_adagrad_table_
update``, in place) and as a tree optimizer (``rowwise_adagrad``, the
paper-table benchmarks').  ``grad_compress`` (port of
``repro/optim/grad_compress.py``): the int8 wire format of the gradient
exchange with error feedback, through ``kernels.rowwise_quant``.
"""

from repro_torch.optim.optimizers import (  # noqa: F401
    AdagradState,
    Optimizer,
    adam,
    apply_updates,
    rowwise_adagrad,
    rowwise_adagrad_table_update,
)
from repro_torch.optim.grad_compress import (  # noqa: F401
    compress_int8,
    decompress_int8,
    error_feedback_allreduce,
)
