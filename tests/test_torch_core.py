"""Parity of the port's F-Quantization core with the JAX package.

Same numpy inputs through ``repro`` and ``repro_torch``: tier thresholds
and vectors, row-wise quantizers, ``snap`` and ``pack`` leaf for leaf, and
the port's chunked build against its whole-table ``pack``.  Everything is
bit-exact except the thresholds, which may differ by 1 ulp of the fp32
quantile (the reference blends the two neighbours in XLA, which may
contract the blend into an FMA).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro.core import packed_store as jps
from repro.core import qat_store as jqs
from repro.core import rowwise_quant as jrq
from repro.core import tiers as jtiers
from repro.data import criteo as jcriteo
from repro_torch.core import packed_store as tps
from repro_torch.core import qat_store as tqs
from repro_torch.core import rowwise_quant as trq
from repro_torch.core import tiers as ttiers
from repro_torch.data import criteo as tcriteo


def bits(x) -> np.ndarray:
    """Raw bits of a JAX/numpy array or a torch tensor, as unsigned ints."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.view(torch.int16)
        x = x.numpy()
    a = np.asarray(x)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.dtype.itemsize])


def test_criteo_synth_copy_draws_the_same_batches():
    kw = dict(num_fields=8, important_fields=4, num_dense=5)
    j = jcriteo.CriteoSynth(jcriteo.CriteoConfig(**kw))
    t = tcriteo.CriteoSynth(tcriteo.CriteoConfig(**kw))
    np.testing.assert_array_equal(j.cards, t.cards)
    for step in (0, 3):
        jb, tb = j.batch(64, step), t.batch(64, step)
        for key in jb:
            np.testing.assert_array_equal(jb[key], tb[key], err_msg=key)


def _priorities(kind: str, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "pareto":          # the serving CLI's profile
        return (rng.pareto(1.2, n) * 10).astype(np.float32)
    if kind == "ties":            # a mass of never-touched rows at 0
        w = (rng.pareto(1.5, n) * 100).astype(np.float32)
        w[rng.random(n) < 0.6] = 0.0
        return w
    return rng.uniform(0, 1e6, n).astype(np.float32)


@pytest.mark.parametrize("kind,n,ratio", [
    ("pareto", 179_712, 0.5),     # dlrm-rm2 smoke total_rows
    ("ties", 10_001, 0.5),
    ("uniform", 4_097, 0.3),
    ("pareto", 999, 0.9),
])
def test_plan_thresholds_and_tiers_match_jax(kind, n, ratio):
    w = _priorities(kind, n)
    jcfg = jtiers.plan_thresholds_for_ratio(jnp.asarray(w), 16, ratio)
    tcfg = ttiers.plan_thresholds_for_ratio(torch.from_numpy(w), 16, ratio)
    for a, b in zip(jcfg, tcfg):
        assert abs(a - b) <= np.spacing(np.float32(abs(a))), (jcfg, tcfg)
    jt = np.asarray(jtiers.assign_tiers(jnp.asarray(w), jcfg))
    tt = ttiers.assign_tiers(torch.from_numpy(w), tcfg).numpy()
    np.testing.assert_array_equal(jt, tt)
    assert ttiers.memory_bytes(torch.from_numpy(tt), 16) == \
        jtiers.memory_bytes(jt, 16)


@pytest.mark.parametrize("mode", ["narrow", "full"])
@pytest.mark.parametrize("strict_fp16", [False, True])
def test_rowwise_quantizers_bit_equal(mode, strict_fp16):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((257, 24)) * 0.05).astype(np.float32)
    x[3] = 0.0                                    # the 1e-12 scale floor
    q, s = jrq.quantize_rowwise(jnp.asarray(x), 8, mode=mode)
    tq, ts = trq.quantize_rowwise(torch.from_numpy(x), 8, mode=mode)
    np.testing.assert_array_equal(bits(q), bits(tq))
    np.testing.assert_array_equal(bits(s), bits(ts))
    h, hs = jrq.quantize_half(jnp.asarray(x), strict_fp16=strict_fp16)
    th, ths = trq.quantize_half(torch.from_numpy(x), strict_fp16=strict_fp16)
    np.testing.assert_array_equal(bits(h), bits(th))
    np.testing.assert_array_equal(bits(hs), bits(ths))


def _smoke_store(v: int = 3000, d: int = 16, seed: int = 0):
    rng = np.random.default_rng(seed)
    table = (rng.standard_normal((v, d)) * 0.05).astype(np.float32)
    pri = _priorities("pareto", v, seed)
    return table, pri


def _pack_both(table, pri, **cfg_kw):
    jcfg = jqs.FQuantConfig(
        tiers=jtiers.plan_thresholds_for_ratio(jnp.asarray(pri),
                                               table.shape[1], 0.5),
        stochastic=False, **cfg_kw)
    jstore = jqs.QATStore(jnp.asarray(table), jnp.asarray(pri))
    jsnap = jqs.snap(jstore.table, jqs.current_tiers(jstore, jcfg), jcfg)
    jpacked = jps.pack(jstore._replace(table=jsnap), jcfg)

    tcfg = tqs.FQuantConfig(tiers=ttiers.TierConfig(*jcfg.tiers), **cfg_kw)
    tstore = tqs.QATStore(torch.from_numpy(table), torch.from_numpy(pri))
    tsnap = tqs.snap(tstore.table, tqs.current_tiers(tstore, tcfg), tcfg)
    tpacked = tps.pack(tstore._replace(table=tsnap), tcfg)
    return (jsnap, jpacked), (tsnap, tpacked, tcfg)


@pytest.mark.parametrize("cfg_kw", [{}, {"strict_fp16": True},
                                    {"mode": "full"}])
def test_snap_and_pack_leaf_for_leaf(cfg_kw):
    table, pri = _smoke_store()
    (jsnap, jpacked), (tsnap, tpacked, _) = _pack_both(table, pri, **cfg_kw)
    np.testing.assert_array_equal(bits(jsnap), bits(tsnap))
    for field in jps.PackedStore._fields:
        a, b = getattr(jpacked, field), getattr(tpacked, field)
        assert tuple(a.shape) == tuple(b.shape), field
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=field)
    assert tpacked.nbytes() == jpacked.nbytes()
    assert tpacked.nbytes(by_tier=True) == jpacked.nbytes(by_tier=True)
    np.testing.assert_array_equal(tps.packed_tiers(tpacked).numpy(),
                                  jps.packed_tiers(jpacked))
    assert tps.live_counts(tpacked) == list(jps.live_counts(jpacked))


@pytest.mark.parametrize("case", ["mixed", "empty_int8_tier",
                                  "one_chunk"])
def test_chunked_build_equals_pack(case):
    table, pri = _smoke_store(v=1000, d=8, seed=3)
    cfg = tqs.FQuantConfig(
        tiers=ttiers.plan_thresholds_for_ratio(torch.from_numpy(pri), 8,
                                               0.5))
    chunk = {"mixed": 96, "empty_int8_tier": 250, "one_chunk": 4096}[case]
    if case == "empty_int8_tier":
        cfg = cfg._replace(tiers=ttiers.TierConfig(t8=-1.0, t16=50.0))
    t = torch.from_numpy(table)
    p = torch.from_numpy(pri)
    snapped = tqs.snap(t, ttiers.assign_tiers(p, cfg.tiers), cfg)
    whole = tps.pack(tqs.QATStore(snapped, p), cfg)
    calls = []

    def rows(r0, r1):
        calls.append((r0, r1))
        return t[r0:r1].clone()

    chunked = tps.build_chunked(rows, p, 8, cfg, chunk_rows=chunk)
    assert calls == [(r, min(1000, r + chunk)) for r in range(0, 1000, chunk)]
    for field in tps.PackedStore._fields:
        np.testing.assert_array_equal(bits(getattr(whole, field)),
                                      bits(getattr(chunked, field)),
                                      err_msg=field)
    if case == "empty_int8_tier":
        assert tps.live_counts(chunked)[0] == 0
        assert chunked.payload8.shape == (1, 8)
