"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H (MLA) d_ff=1408 an
expert, vocab=102400, MoE 64 routed + 2 shared, top-6, MLA kv_lora=512
[arXiv:2405.04434].

Port of ``repro/configs/deepseek_v2_lite_16b.py``.  The MLA latent cache
(512 + 64 dims a token) makes long_500k run.  Layer 0 has a dense FFN
(first_k_dense_replace=1, d_ff=10944 as in the HF config).
"""

import torch

from repro_torch.configs.common import LMArch
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    name="deepseek-v2-lite-16b", n_layers=27, d_model=2048, n_heads=16,
    n_kv_heads=16, head_dim=128, d_ff=10944, vocab=102400,
    attn="mla", kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128, first_dense=1,
    moe=MoEConfig(d_model=2048, d_ff=1408, num_experts=64, top_k=6,
                  num_shared=2, capacity_factor=1.25),
    rope_theta=1e4, compute_dtype=torch.bfloat16, max_seq=524288)

SMOKE = LMConfig(
    name="dsv2lite-smoke", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=4, head_dim=16, d_ff=128, vocab=512,
    attn="mla", kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
    v_head_dim=16, first_dense=1,
    moe=MoEConfig(d_model=64, d_ff=32, num_experts=8, top_k=2,
                  num_shared=1),
    max_seq=64)


def arch() -> LMArch:
    return LMArch(name="deepseek-v2-lite-16b", lm_cfg=FULL,
                  smoke_cfg=SMOKE, supports_long=True)
