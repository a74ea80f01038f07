"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, SWA [arXiv:2401.04088].

Port of ``repro/configs/mixtral_8x22b.py``.  The 4,096-token window
bounds the live keys, so long_500k runs with a rolling cache (window-size
storage, absolute-position masking).
"""

import torch

from repro_torch.configs.common import LMArch
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

WINDOW = 4096

FULL = LMConfig(
    name="mixtral-8x22b", n_layers=56, d_model=6144, n_heads=48,
    n_kv_heads=8, head_dim=128, d_ff=16384, vocab=32768, window=WINDOW,
    moe=MoEConfig(d_model=6144, d_ff=16384, num_experts=8, top_k=2,
                  capacity_factor=1.25),
    rope_theta=1e6, compute_dtype=torch.bfloat16, max_seq=524288)

SMOKE = LMConfig(
    name="mixtral-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=96, vocab=512, window=16,
    moe=MoEConfig(d_model=64, d_ff=96, num_experts=4, top_k=2),
    max_seq=64)


def arch() -> LMArch:
    return LMArch(name="mixtral-8x22b", lm_cfg=FULL, smoke_cfg=SMOKE,
                  supports_long=True, rolling_window=WINDOW)
