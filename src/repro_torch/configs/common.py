"""Shapes and the recsys arch record shared by the configs.

Port of the recsys part of ``repro/configs/common.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

RECSYS_SHAPES = {
    "train_batch": dict(batch=65536),
    "serve_p99": dict(batch=512),
    "serve_bulk": dict(batch=262144),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000),
}


@dataclasses.dataclass
class RecsysArch:
    model: Any                       # models.recsys.Model (full size)
    smoke_model: Any                 # reduced
    num_dense: int = 13              # dense features of the full model
    smoke_num_dense: int = 5         # reduced config's dense width (0:
                                     # the model takes no dense input)
    name: str = ""
    cfg: Any = None                  # the full model's config dataclass
    smoke_cfg: Any = None            # the reduced one's
