"""deepseek-coder-33b [dense]: 62L d_model=7168 56H (GQA kv=8)
d_ff=19200 vocab=32256, llama-arch [arXiv:2401.14196].

Port of ``repro/configs/deepseek_coder_33b.py``.  Pure full attention,
so no long_500k cell.
"""

import torch

from repro_torch.configs.common import LMArch
from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    name="deepseek-coder-33b", n_layers=62, d_model=7168, n_heads=56,
    n_kv_heads=8, head_dim=128, d_ff=19200, vocab=32256,
    rope_theta=1e5, compute_dtype=torch.bfloat16, max_seq=32768)

SMOKE = LMConfig(
    name="dscoder-smoke", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    head_dim=8, d_ff=160, vocab=512, max_seq=64)


def arch() -> LMArch:
    return LMArch(name="deepseek-coder-33b", lm_cfg=FULL, smoke_cfg=SMOKE,
                  supports_long=False)
