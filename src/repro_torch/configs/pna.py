"""pna [gnn]: n_layers=4 d_hidden=75 aggregators=mean-max-min-std
scalers=id-amp-atten [arXiv:2004.05718].

Port of ``repro/configs/pna.py``.  Shapes: full_graph_sm (Cora-like),
minibatch_lg (Reddit-like, sampled, with a 232,965-row learned node
table, 233,472 padded: the F-Quantization surface), ogb_products
(full-batch large), molecule (batched small graphs).
"""

from repro_torch.configs.common import GNNArch


def arch() -> GNNArch:
    return GNNArch(name="pna", d_hidden=75, n_layers=4)
