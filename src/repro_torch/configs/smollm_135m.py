"""smollm-135m [dense]: 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.

Port of ``repro/configs/smollm_135m.py``: Llama-arch small
[hf:HuggingFaceTB/SmolLM-135M], tied embeddings.  Pure full attention,
so no long_500k cell.
"""

import torch

from repro_torch.configs.common import LMArch
from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    name="smollm-135m", n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
    head_dim=64, d_ff=1536, vocab=49152, tie_embeddings=True,
    compute_dtype=torch.bfloat16, max_seq=4096)

SMOKE = LMConfig(
    name="smollm-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, vocab=512, tie_embeddings=True, max_seq=64)


def arch() -> LMArch:
    return LMArch(name="smollm-135m", lm_cfg=FULL, smoke_cfg=SMOKE,
                  supports_long=False)
