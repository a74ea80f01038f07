"""wide-deep [recsys]: n_sparse=40 embed_dim=32 mlp=1024-512-256
interaction=concat [arXiv:1606.07792].

Port of ``repro/configs/wide_deep.py``: 40 app-store-like id fields (a
few large id spaces, many small categorical ones), 22,216,000 rows
(22,216,192 stacked, 512-padded) x 32 = 2.84 GB fp32; deep MLP
1280-1024-512-256-1.
"""

from repro_torch.configs.common import RecsysArch
from repro_torch.data.criteo import CriteoConfig, CriteoSynth
from repro_torch.models import recsys as R

CARDS = tuple([10_000_000, 10_000_000, 1_000_000, 1_000_000, 100_000]
              + [10_000] * 10 + [1_000] * 15 + [100] * 10)
assert len(CARDS) == 40

FULL_CFG = R.WideDeepConfig(cardinalities=CARDS, embed_dim=32,
                            mlp=(1024, 512, 256))

_smoke_ds = CriteoSynth(CriteoConfig(num_fields=8, important_fields=4))
SMOKE_CFG = R.WideDeepConfig(
    cardinalities=tuple(int(c) for c in _smoke_ds.cards), embed_dim=8,
    mlp=(32, 16))


def arch() -> RecsysArch:
    return RecsysArch(name="wide-deep", model=R.make_wide_deep(FULL_CFG),
                      smoke_model=R.make_wide_deep(SMOKE_CFG), num_dense=0,
                      smoke_num_dense=0, cfg=FULL_CFG, smoke_cfg=SMOKE_CFG)
