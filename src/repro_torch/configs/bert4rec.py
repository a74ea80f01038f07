"""bert4rec [recsys]: embed_dim=64 n_blocks=2 n_heads=2 seq_len=200
interaction=bidir-seq [arXiv:1904.06690].

Port of ``repro/configs/bert4rec.py``.  Item vocabulary sized for an
industrial catalogue (5M items); the stacked table is [items | positions
| pad], 5,000,704 rows x 64 = 1.28 GB fp32.  Field pruning is degenerate
here (fields = {item table, position table}); F-Quantization applies to
the zipf-accessed item rows.  A sequence arch: the train CLI runs its
family smoke, and the serve and fleet CLIs refuse it, as the
reference's do.
"""

from repro_torch.configs.common import RecsysArch
from repro_torch.models import recsys as R

NUM_ITEMS = 5_000_002          # + [MASK] + [PAD]
SEQ_LEN = 200

FULL_CFG = R.Bert4RecConfig(num_items=NUM_ITEMS, embed_dim=64,
                            n_blocks=2, n_heads=2, seq_len=SEQ_LEN)

SMOKE_CFG = R.Bert4RecConfig(num_items=502, embed_dim=32, n_blocks=2,
                             n_heads=2, seq_len=32)


def arch() -> RecsysArch:
    return RecsysArch(name="bert4rec",
                      model=R.make_bert4rec(FULL_CFG),
                      smoke_model=R.make_bert4rec(SMOKE_CFG),
                      smoke_num_dense=0, seq_model=True, seq_len=SEQ_LEN,
                      cfg=FULL_CFG, smoke_cfg=SMOKE_CFG)
