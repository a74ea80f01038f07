"""Parity of the port's (B, K)-grid oracles with the JAX package, on the
CPU.

``dequant_bag_rowgrid`` and ``bag_grad_rowgrid`` take their plain
versions on the CPU; here those are held bit for bit to the reference's
Pallas rowgrid kernels run in interpret mode (as ``tests/test_kernels.py``
and ``tests/test_bag_backward.py`` run them), at K = 1 and K > 1, with
the NaN rule each kernel keeps: the dequant oracle reads every slot, so a
NaN row in a zero-weight slot makes its bag NaN where the tiled kernel
skips it; the scatter oracle skips ``c == 0`` slots, so a NaN cotangent
under zero coefficients leaks nowhere.  On finite inputs both plain
oracles equal the tiled plain versions bit for bit.  Tolerance 0
throughout (NaN compared by position).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro.kernels.dequant_bag.kernel import (bag_grad_pallas_rowgrid,
                                              dequant_bag_pallas_rowgrid)
from repro_torch.convert import to_tensor
from repro_torch.kernels.dequant_bag import kernel as tkernel
from repro_torch.kernels.dequant_bag import ops as tops
from repro_torch.kernels.dequant_bag import ref as tref


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    a = np.asarray(x, np.float32)
    return np.where(np.isnan(a), np.float32(np.nan), a).view(np.uint32)


def _payload(dtype: str, v: int, d: int, rng) -> np.ndarray:
    if dtype == "int8":
        return rng.integers(-128, 128, (v, d)).astype(np.int8)
    x = (rng.standard_normal((v, d)) * 0.1).astype(np.float32)
    if dtype == "bfloat16":
        return np.array(jnp.asarray(x, jnp.bfloat16)).view(np.uint16)
    return x


def _jpay(payload: np.ndarray, dtype: str):
    return (jnp.asarray(payload).view(jnp.bfloat16) if dtype == "bfloat16"
            else jnp.asarray(payload))


def _bag_inputs(dtype, v, d, b, k, seed=0):
    rng = np.random.default_rng(seed)
    payload = _payload(dtype, v, d, rng)
    scales = (rng.random(v) * 0.01).astype(np.float32)
    idx = rng.integers(0, v, (b, k)).astype(np.int32)
    w = rng.random((b, k)).astype(np.float32)
    w[rng.random((b, k)) < 0.4] = 0.0             # masked slots
    return payload, scales, idx, w


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("v,d,b,k", [(64, 16, 7, 4), (40, 9, 5, 1)])
def test_dequant_rowgrid_bit_equal_to_pallas_rowgrid(dtype, v, d, b, k):
    payload, scales, idx, w = _bag_inputs(dtype, v, d, b, k)
    want = dequant_bag_pallas_rowgrid(
        _jpay(payload, dtype), jnp.asarray(scales), jnp.asarray(idx),
        jnp.asarray(w), interpret=True)
    tkernel.reset_launches()
    args = (to_tensor(payload), torch.from_numpy(scales),
            torch.from_numpy(idx), torch.from_numpy(w))
    got = tops.dequant_bag_rowgrid(*args)
    assert tkernel.rowgrid_launches["dequant_bag_rowgrid"] == 0
    np.testing.assert_array_equal(bits(got), bits(want))
    # finite inputs: the oracle equals the tiled plain version
    np.testing.assert_array_equal(bits(got), bits(tref.dequant_bag_ref(*args)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("k", [1, 4])
def test_dequant_rowgrid_reads_zero_weight_slots(dtype, k):
    """A NaN row (a NaN scale for int8) in a zero-weight slot: NaN bags
    from the rowgrid oracle, as the interpret-mode Pallas rowgrid gives;
    finite bags from the tiled plain version."""
    v, d, b, bad = 30, 8, 6, 3
    payload, scales, idx, w = _bag_inputs(dtype, v, d, b, k, seed=1)
    idx[idx == bad] = bad + 1
    w[w == 0] = 0.5
    idx[::2, k - 1], w[::2, k - 1] = bad, 0.0
    if dtype == "int8":
        scales[bad] = np.nan
    elif dtype == "float32":
        payload[bad] = np.nan
    else:
        payload[bad] = np.asarray(jnp.full((d,), jnp.nan, jnp.bfloat16)
                                  ).view(np.uint16)
    want = dequant_bag_pallas_rowgrid(
        _jpay(payload, dtype), jnp.asarray(scales), jnp.asarray(idx),
        jnp.asarray(w), interpret=True)
    args = (to_tensor(payload), torch.from_numpy(scales),
            torch.from_numpy(idx), torch.from_numpy(w))
    got = tops.dequant_bag_rowgrid(*args)
    np.testing.assert_array_equal(bits(got), bits(want))
    assert torch.isnan(got[::2]).all() and torch.isfinite(got[1::2]).all()
    tiled = tref.dequant_bag_ref(*args)
    assert torch.isfinite(tiled).all()
    np.testing.assert_array_equal(bits(got[1::2]), bits(tiled[1::2]))


def _grad_inputs(b, k, v, d, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((b, d)).astype(np.float32)
    idx = rng.integers(0, v, (b, k)).astype(np.int32)
    idx[:, 0] = rng.integers(0, 3, b)              # hot duplicate rows
    scales = (rng.random(v) * 3).astype(np.float32)
    w = rng.random((b, k)).astype(np.float32)
    w[rng.random((b, k)) < 0.4] = 0.0
    return g, idx, scales, w


@pytest.mark.parametrize("b,k,v,d", [(16, 1, 10, 8), (9, 5, 12, 7)])
@pytest.mark.parametrize("scaled", [False, True])
def test_bag_grad_rowgrid_bit_equal_to_pallas_rowgrid(b, k, v, d, scaled):
    g, idx, scales, w = _grad_inputs(b, k, v, d)
    s = scales if scaled else None
    want = bag_grad_pallas_rowgrid(
        jnp.asarray(g), None if s is None else jnp.asarray(s),
        jnp.asarray(idx), jnp.asarray(w), v, interpret=True)
    args = (torch.from_numpy(g), None if s is None else torch.from_numpy(s),
            torch.from_numpy(idx), torch.from_numpy(w), v)
    got = tops.bag_grad_rowgrid(*args)
    np.testing.assert_array_equal(bits(got), bits(want))
    np.testing.assert_array_equal(bits(got), bits(tref.bag_grad_ref(*args)))


def test_bag_grad_rowgrid_skips_zero_coefficients():
    """A NaN cotangent in a bag whose coefficients are all zero leaks
    nowhere, in the Pallas rowgrid and in the port's oracle alike."""
    b, k, v, d = 8, 3, 6, 5
    g, idx, _, w = _grad_inputs(b, k, v, d, seed=2)
    w[w == 0] = 0.25
    g[3], w[3] = np.nan, 0.0
    want = bag_grad_pallas_rowgrid(jnp.asarray(g), None, jnp.asarray(idx),
                                   jnp.asarray(w), v, interpret=True)
    got = tops.bag_grad_rowgrid(torch.from_numpy(g), None,
                                torch.from_numpy(idx), torch.from_numpy(w), v)
    assert torch.isfinite(got).all()
    np.testing.assert_array_equal(bits(got), bits(want))


def test_rowgrid_refs_on_empty_batches():
    payload = torch.zeros((4, 3))
    out = tops.dequant_bag_rowgrid(payload, None,
                                   torch.zeros((0, 2), dtype=torch.int32))
    assert out.shape == (0, 3)
    grad = tops.bag_grad_rowgrid(torch.zeros((0, 3)), None,
                                 torch.zeros((0, 2), dtype=torch.int32), None,
                                 4)
    assert torch.equal(grad, torch.zeros((4, 3)))


def test_rowgrid_cuda_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.dequant_bag_rowgrid_cuda(
            torch.zeros((4, 3)), None, torch.zeros((1, 1), dtype=torch.int32),
            torch.ones((1, 1)))
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.bag_grad_rowgrid_cuda(
            torch.zeros((1, 3)), torch.zeros((1, 1), dtype=torch.int32),
            torch.ones((1, 1)), torch.zeros((4, 3)))


@pytest.mark.parametrize("n,buckets", [(1, 1), (32, 1), (33, 2), (208, 8),
                                       (65_536, 2048), (131_072, 4096),
                                       (1_703_936, 4096), (2**31 - 2, 4096)])
def test_rowgrid_buckets_near_one_window_each(n, buckets):
    """P is a power of two, about one 32-slot window a bucket, at most
    4,096 (the pass-1 tile's shared histogram); the gradcheck's 208 slots
    take 8, a training batch's 1,703,936 the most."""
    p = tkernel.rowgrid_buckets(n)
    assert p == buckets
    assert p & (p - 1) == 0 and 1 <= p <= tkernel.ROWGRID_MAX_BUCKETS
    assert p == tkernel.ROWGRID_MAX_BUCKETS or p * 32 >= n
    assert p == 1 or (p // 2) * 32 < n


@pytest.mark.parametrize("n", [1, 208, 4096, 4097, 1_703_936])
def test_rowgrid_scratch_words_cover_the_layout(n):
    """The scratch the wrapper allocates is the C entry's layout: the
    meta words, three per bucket, a count a bucket a 4,096-slot tile, and
    a row, bag and coefficient a slot."""
    p = tkernel.rowgrid_buckets(n)
    tiles = -(-n // tkernel.ROWGRID_TILE)
    want = tkernel.ROWGRID_META + 3 * p + tiles * p + 3 * n
    assert tkernel.rowgrid_scratch_words(n, p) == want
    # the counts are at most a word a slot and a tile's worth more
    assert want <= tkernel.ROWGRID_META + 4 * n + 4 * 4096
    # a training batch's scratch: ~27 MB beside its 436 MB of g
    if n == 1_703_936:
        assert tkernel.rowgrid_scratch_words(n, p) * 4 < 28e6


def _grad_args(**bad):
    args = {"g": torch.zeros((4, 8)),
            "indices": torch.zeros((4, 2), dtype=torch.int32),
            "coeff": torch.ones((4, 2)), "out": torch.zeros((6, 8))}
    args.update(bad)
    return args


@pytest.mark.parametrize("bad,err", [
    ({"g": torch.zeros((4, 8), dtype=torch.float64)}, TypeError),
    ({"indices": torch.zeros((4, 2), dtype=torch.int64)}, TypeError),
    ({"coeff": torch.ones((4, 2), dtype=torch.float16)}, TypeError),
    ({"out": torch.zeros((6, 8), dtype=torch.bfloat16)}, TypeError),
    ({"g": torch.zeros(32)}, TypeError),
    ({"g": torch.zeros((8, 4)).t()}, ValueError),
    ({"coeff": torch.ones((4, 3))}, ValueError),
    ({"indices": torch.zeros((5, 2), dtype=torch.int32),
      "coeff": torch.ones((5, 2))}, ValueError),
    ({"out": torch.zeros((6, 9))}, ValueError),
    ({"out": torch.zeros((6, 8), device="meta")}, ValueError),
    ({}, ValueError),                        # all right, but on the CPU
])
def test_bag_grad_rowgrid_cuda_refuses(bad, err):
    """Wrong dtypes, shapes, layouts and devices raise before anything is
    built or launched; right ones on the CPU raise for want of CUDA."""
    tkernel.reset_launches()
    with pytest.raises(err):
        tkernel.bag_grad_rowgrid_cuda(**_grad_args(**bad))
    assert tkernel.rowgrid_launches["bag_grad_rowgrid"] == 0


def _bag_args(**bad):
    args = {"payload": torch.zeros((6, 8), dtype=torch.int8),
            "scales": torch.ones(6),
            "indices": torch.zeros((4, 2), dtype=torch.int32),
            "weights": torch.ones((4, 2))}
    args.update(bad)
    return args


@pytest.mark.parametrize("bad,err", [
    ({"payload": torch.zeros((6, 8), dtype=torch.int16)}, TypeError),
    ({"payload": torch.zeros(48, dtype=torch.int8)}, TypeError),
    ({"scales": torch.ones(6, dtype=torch.float64)}, TypeError),
    ({"scales": torch.ones(7)}, ValueError),
    ({"indices": torch.zeros((4, 2), dtype=torch.int64)}, TypeError),
    ({"weights": torch.ones((4, 3))}, ValueError),
    ({"weights": torch.ones((2, 4)).t()}, ValueError),
    ({"weights": torch.ones((4, 2), device="meta")}, ValueError),
    ({}, ValueError),
])
def test_dequant_bag_rowgrid_cuda_refuses(bad, err):
    tkernel.reset_launches()
    with pytest.raises(err):
        tkernel.dequant_bag_rowgrid_cuda(**_bag_args(**bad))
    assert tkernel.rowgrid_launches["dequant_bag_rowgrid"] == 0


def test_grad_cases_cover_the_oracle_schedule():
    """``cases.bag_grad_cases`` holds what the card oracle's schedule must
    get right: a hot row's bucket, every slot in one bucket, rows repeating
    inside and across 32-slot windows, runs sharing a bucket at K = 3 with
    zero coefficients, widths 33 and 200 off alignment, and B = 0; on the
    small ones both plain versions agree bit for bit."""
    from repro_torch.kernels import cases
    stride = cases.BUCKET_STRIDE
    assert stride % tkernel.ROWGRID_MAX_BUCKETS == 0
    by_name = {c.name: c for c in cases.bag_grad_cases(torch.device("cpu"),
                                                       tkernel.HEAVY_RUN)}
    flat = by_name["hot_bucket"].indices.reshape(-1).long()
    counts = torch.bincount(flat)
    assert int(counts.max()) == 65_536 and int(counts.argmax()) == 0
    same = flat[flat % stride == 0]
    assert torch.unique(same).numel() == 33 and same.numel() == 65_536 + 8192
    assert int((flat % stride != 0).sum()) == 8192
    c = by_name["one_bucket"]
    assert bool((c.indices % stride == 0).all())
    assert torch.unique(c.indices).numel() == 64 and c.indices.shape[1] == 2
    for d in (33, 64):
        c = by_name[f"window_edges_d{d}"]
        rows = c.indices.reshape(-1).tolist()
        wins = [rows[i:i + 32] for i in range(0, len(rows), 32)]
        assert len(wins) == 5 and c.g.shape[1] == d
        assert rows[31] == rows[32]                     # across an edge
        assert len(set(wins[0])) < 32                   # twice in a window
        gone = (set(wins[0]) - set(wins[1])) & set(wins[2])
        assert gone                                     # back after a gap
        assert len(set(wins[3])) == 1 and wins[3][0] in wins[2]
    c = by_name["shared_runs_k3"]
    assert c.indices.shape[1] == 3 and bool((c.indices % stride == 0).all())
    assert 0.1 < float((c.coeff == 0).float().mean()) < 0.3
    assert by_name["empty"].indices.shape == (0, 2)
    for d in (33, 200):
        c = by_name[f"misaligned_d{d}"]
        assert c.g.shape[1] == d and c.g.data_ptr() % 16
    for name in ("one_bucket", "window_edges_d33", "shared_runs_k3",
                 "empty"):
        c = by_name[name]
        a = tref.bag_grad_ref(c.g, None, c.indices, c.coeff, c.vocab)
        b = tref.bag_grad_rowgrid_ref(c.g, None, c.indices, c.coeff,
                                      c.vocab)
        np.testing.assert_array_equal(bits(a), bits(b))
