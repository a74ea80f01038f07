"""Uniform-precision quantized training baselines (Table 3 context rows).

Port of ``repro/core/baselines/uniform.py``: "fp16 with stochastic
rounding" and "int8 with stochastic rounding" (Zhang et al. [34] style),
every row at one precision, as degenerate F-Quantization tier configs,
so the code path is the tiered one.
"""

from __future__ import annotations

from repro_torch.core.qat_store import FQuantConfig
from repro_torch.core.tiers import TierConfig

_INF = float("inf")


def all_int8_config(**kw) -> FQuantConfig:
    # t8 = +inf: every priority falls below it -> everything int8
    return FQuantConfig(tiers=TierConfig(t8=_INF, t16=_INF), **kw)


def all_half_config(**kw) -> FQuantConfig:
    # t8 = -inf, t16 = +inf -> everything half
    return FQuantConfig(tiers=TierConfig(t8=-_INF, t16=_INF), **kw)


def all_fp32_config(**kw) -> FQuantConfig:
    return FQuantConfig(tiers=TierConfig(t8=-_INF, t16=-_INF), **kw)


def memory_fraction(config_name: str) -> float:
    return {"int8": 0.25, "half": 0.5, "fp32": 1.0}[config_name]
