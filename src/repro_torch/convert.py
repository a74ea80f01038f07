"""Carry weights (dlrm, wide&deep, xDeepFM, bert4rec, PNA and the
decoder-only LMs), QAT, packed, hierarchical and hashed stores, train
states and the MPE / ALPT baselines' states from the JAX package into
the port.

Inputs are numpy arrays, never JAX objects, so this module imports neither
package's JAX code: a caller brings params to the host
(``jax.device_get``) and hands the nested dict over.  bf16 leaves arrive
as uint16 views of their bits (``np.asarray(x).view(np.uint16)``), or as
numpy's 2-byte bfloat16 extension dtype itself, and come out as
``torch.bfloat16`` with the same bits.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.core.baselines.alpt import ALPTState
from repro_torch.core.baselines.mpe import MPEState
from repro_torch.core.packed_store import PackedStore
from repro_torch.core.qat_store import QATStore
from repro_torch.optim.optimizers import AdamState
from repro_torch.store.hashed import HashedConfig, HashedStore
from repro_torch.store.hier import HierStore
from repro_torch.train.accum import TaylorAccum
from repro_torch.train.steps import TrainState


def to_tensor(x, device: str | torch.device = "cpu") -> torch.Tensor:
    """numpy array -> tensor with the same bits (uint16 -> bf16)."""
    a = np.array(x)                  # a writable copy that torch may own
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:   # bfloat16
        a = a.view(np.uint16)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(params, device: str | torch.device = "cpu"):
    """Nested dicts and lists of numpy arrays -> the same nesting of
    tensors: any model's params (``embed_table``, ``wide_table``,
    ``net.bot``/``top`` for dlrm, ``net.deep``/``bias`` for wide&deep,
    ``net.cin.w{i}``/``cin_out``/``deep`` for xDeepFM, ``net.blocks[i]``/
    ``ln_f`` for bert4rec, ``enc``/``layer_{i}``/``out`` for PNA, the
    stacked (L, ...) ``layers`` and ``dense_layer_{i}`` of an LM, bf16
    leaves included), and an LM's decode cache (``k``, ``v``, ``pos``)."""
    if isinstance(params, Mapping):
        return {k: params_from_jax(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_from_jax(v, device) for v in params]
    return to_tensor(params, device)


def packed_from_jax(leaves, device: str | torch.device = "cpu"
                    ) -> PackedStore:
    """A reference ``PackedStore`` with its six leaves brought to numpy
    -> the port's ``PackedStore``."""
    return PackedStore(*(to_tensor(getattr(leaves, f), device)
                         for f in PackedStore._fields))


def qat_store_from_jax(store, device: str | torch.device = "cpu"
                       ) -> QATStore:
    """A reference ``QATStore`` (table, priority) with its leaves brought
    to numpy -> the port's ``QATStore``."""
    return QATStore(table=to_tensor(store.table, device),
                    priority=to_tensor(store.priority, device))


def hier_store_from_jax(tree, hier_cfg, device: str | torch.device = "cpu"
                        ) -> HierStore:
    """A reference ``HierStore.state_tree()`` with its leaves brought to
    numpy -> the port's ``HierStore`` on ``device`` (the hot level there,
    the warm one on the CPU; ``HierBackend.from_manifest``).  The cold
    shards are opened from ``hier_cfg.store_dir``: both packages write the
    same ``hier_store/v1`` files."""
    from repro_torch.store.api import HierBackend
    return HierBackend.from_manifest(tree, hier_cfg=hier_cfg,
                                     device=device).hier


def hashed_store_from_jax(hs, device: str | torch.device = "cpu"
                          ) -> HashedStore:
    """A reference ``HashedStore`` (pool, pool_scale, priority) with its
    leaves brought to numpy -> the port's ``HashedStore``."""
    return HashedStore(*(to_tensor(getattr(hs, f), device)
                         for f in HashedStore._fields))


def hashed_config_from_jax(hcfg) -> HashedConfig:
    """A reference ``HashedConfig`` -> the port's (the same fields)."""
    return HashedConfig(**{f: int(getattr(hcfg, f))
                           for f in HashedConfig._fields})


def train_state_from_jax(state, device: str | torch.device = "cpu"
                         ) -> TrainState:
    """A reference compressed-step ``TrainState`` with its leaves brought
    to numpy (``jax.device_get``) -> the port's ``TrainState``: params
    (``embed_table`` and ``net``), Adam ``step``/``mu``/``nu``, the
    row-wise adagrad accumulator, the step, the priorities, the rng key
    leaf and the ``TaylorAccum``."""
    adam_state, accum_sq = state.opt

    def t(x):
        return None if x is None else to_tensor(x, device)

    acc = state.accum
    return TrainState(
        params=params_from_jax(state.params, device),
        opt=(AdamState(step=t(adam_state.step),
                       mu=params_from_jax(adam_state.mu, device),
                       nu=params_from_jax(adam_state.nu, device)),
             t(accum_sq)),
        step=t(state.step), priority=t(state.priority), rng=t(state.rng),
        accum=None if acc is None else TaylorAccum(
            *(t(getattr(acc, f)) for f in TaylorAccum._fields)))


def mpe_state_from_jax(state, device: str | torch.device = "cpu"
                       ) -> MPEState:
    """A reference ``MPEState`` with its leaves brought to numpy -> the
    port's (its step a host int)."""
    return MPEState(table=to_tensor(state.table, device),
                    priority=to_tensor(state.priority, device),
                    in_cache=to_tensor(state.in_cache, device),
                    step=int(state.step))


def alpt_state_from_jax(state, device: str | torch.device = "cpu"
                        ) -> ALPTState:
    """A reference ``ALPTState`` (q, scale) with its leaves brought to
    numpy -> the port's."""
    return ALPTState(q=to_tensor(state.q, device),
                     scale=to_tensor(state.scale, device))
