"""qwen3-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=12288
vocab=151936, qk_norm [hf:Qwen/Qwen3-8B].

Port of ``repro/configs/qwen3_8b.py``.  Pure full attention, so no
long_500k cell.
"""

import torch

from repro_torch.configs.common import LMArch
from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    name="qwen3-8b", n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    head_dim=128, d_ff=12288, vocab=151936, qk_norm=True,
    rope_theta=1e6, compute_dtype=torch.bfloat16, max_seq=32768)

SMOKE = LMConfig(
    name="qwen3-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, vocab=512, qk_norm=True, max_seq=64)


def arch() -> LMArch:
    return LMArch(name="qwen3-8b", lm_cfg=FULL, smoke_cfg=SMOKE,
                  supports_long=False)
