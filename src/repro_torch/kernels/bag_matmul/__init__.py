"""Fused dequant-bag -> first matmul: port of ``repro.kernels.bag_matmul``."""

from repro_torch.kernels.bag_matmul.autodiff import bag_matmul_train  # noqa: F401
from repro_torch.kernels.bag_matmul.ops import packed_bag_matmul  # noqa: F401
