"""Baselines the paper compares against (Sec. 4.1.3).

Port of ``repro/core/baselines``.  Quantization side: MPE (fp32 cache +
LFU/LRU), ALPT (learned scales), uniform fp16 / int8 stochastic
rounding.  Feature-selection side: Permutation
(``repro_torch.core.permutation``), group LASSO (proximal SGD),
Gumbel-softmax selection (FSCD / AutoField style).
"""

from repro_torch.core.baselines import alpt, gumbel, lasso, mpe, uniform  # noqa: F401
