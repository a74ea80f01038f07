"""One config per architecture, the reference's ten.  ``get(name)``
returns an Arch.

    from repro_torch import configs
    arch = configs.get("dlrm-rm2")
    model = arch.model            # published widths (recsys)
    model = arch.smoke_model      # the reduced CPU-test size
    configs.get("qwen3-8b").lm_cfg          # an LM's published config
    configs.get("pna")._cfg("minibatch_lg") # a GNN cell's config
"""

from __future__ import annotations

import importlib

ARCHS = {
    # LM family
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    # GNN
    "pna": "repro_torch.configs.pna",
    # recsys
    "wide-deep": "repro_torch.configs.wide_deep",
    "bert4rec": "repro_torch.configs.bert4rec",
    "xdeepfm": "repro_torch.configs.xdeepfm",
    "dlrm-rm2": "repro_torch.configs.dlrm_rm2",
}


def get(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[name]).arch()


def names() -> list[str]:
    return list(ARCHS)
