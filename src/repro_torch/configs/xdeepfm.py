"""xdeepfm [recsys]: n_sparse=39 embed_dim=10 cin_layers=200-200-200
mlp=400-400 interaction=cin [arXiv:1803.05170].

Port of ``repro/configs/xdeepfm.py``: 39 fields (Criteo's 26 categorical
+ 13 bucketized dense, the paper's setup), 86,709,150 rows (86,709,248
stacked, 512-padded) x 10 = 3.47 GB fp32; CIN 200-200-200 (the compute
hot spot, ``kernels.cin``), deep MLP 390-400-400-1.
"""

from repro_torch.configs.common import RecsysArch
from repro_torch.data.criteo import CriteoConfig, CriteoSynth
from repro_torch.models import recsys as R

CARDS = tuple([40_000_000, 40_000_000, 5_000_000, 1_000_000, 500_000,
               100_000, 50_000, 20_000, 10_000, 5_000]
              + [2_000] * 10 + [500] * 6 + [100] * 10 + [50] * 3)
assert len(CARDS) == 39

FULL_CFG = R.XDeepFMConfig(cardinalities=CARDS, embed_dim=10,
                           cin_layers=(200, 200, 200), mlp=(400, 400))

_smoke_ds = CriteoSynth(CriteoConfig(num_fields=8, important_fields=4))
SMOKE_CFG = R.XDeepFMConfig(
    cardinalities=tuple(int(c) for c in _smoke_ds.cards), embed_dim=6,
    cin_layers=(16, 16), mlp=(32,))


def arch() -> RecsysArch:
    return RecsysArch(name="xdeepfm", model=R.make_xdeepfm(FULL_CFG),
                      smoke_model=R.make_xdeepfm(SMOKE_CFG), num_dense=0,
                      smoke_num_dense=0, cfg=FULL_CFG, smoke_cfg=SMOKE_CFG)
