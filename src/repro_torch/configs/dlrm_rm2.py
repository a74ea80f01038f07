"""dlrm-rm2 [recsys]: n_dense=13 n_sparse=26 embed_dim=64
bot_mlp=13-512-256-64 top_mlp=512-512-256-1 interaction=dot
[arXiv:1906.00091].

Port of ``repro/configs/dlrm_rm2.py``.  Production cardinalities follow
the Criteo-terabyte scale: 204,185,088 stacked rows (512-padded) x 64
dims = 52.3 GB fp32, the SHARK compression target.
"""

from repro_torch.configs.common import RecsysArch
from repro_torch.data.criteo import CriteoConfig, CriteoSynth
from repro_torch.models import recsys as R

# Criteo-terabyte-like cardinalities for the 26 sparse fields (public
# dataset statistics, rounded; dominated by a few huge id spaces)
CARDS = (
    40_000_000, 39_060, 17_295, 7_424, 20_265, 3, 7_122, 1_543, 63,
    40_000_000, 3_067_956, 405_282, 10, 2_209, 11_938, 155, 4, 976, 14,
    40_000_000, 40_000_000, 40_000_000, 590_152, 12_973, 108, 36,
)

FULL_CFG = R.DLRMConfig(cardinalities=CARDS, embed_dim=64, num_dense=13,
                        bot_mlp=(512, 256, 64),
                        top_mlp=(512, 512, 256, 1))

_smoke_ds = CriteoSynth(CriteoConfig(num_fields=8, important_fields=4,
                                     num_dense=5))
SMOKE_CFG = R.DLRMConfig(
    cardinalities=tuple(int(c) for c in _smoke_ds.cards), embed_dim=16,
    num_dense=5, bot_mlp=(32, 16), top_mlp=(32, 1))


def arch() -> RecsysArch:
    return RecsysArch(name="dlrm-rm2", model=R.make_dlrm(FULL_CFG),
                      smoke_model=R.make_dlrm(SMOKE_CFG), num_dense=13,
                      cfg=FULL_CFG, smoke_cfg=SMOKE_CFG)
