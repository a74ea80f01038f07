"""One config per ported architecture.  ``get(name)`` returns an Arch.

    from repro_torch import configs
    arch = configs.get("dlrm-rm2")
    model = arch.model            # published widths
    model = arch.smoke_model      # the reduced CPU-test size
"""

from __future__ import annotations

import importlib

ARCHS = {
    "dlrm-rm2": "repro_torch.configs.dlrm_rm2",
    "wide-deep": "repro_torch.configs.wide_deep",
    "xdeepfm": "repro_torch.configs.xdeepfm",
    "bert4rec": "repro_torch.configs.bert4rec",
}


def get(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[name]).arch()


def names() -> list[str]:
    return list(ARCHS)
