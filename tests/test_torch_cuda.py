"""The port's CUDA kernels on the card: each against its plain version.

Marked ``cuda``; each test skips where there is no GPU (decided inside
the fixture, never at import).  Run on a machine with an H100 with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro_torch.core import packed_store as tps
from repro_torch.core import qat_store as tqs
from repro_torch.core.tiers import TierConfig
from repro_torch import configs
from repro_torch.kernels import cases
from repro_torch.kernels.bag_matmul import kernel as bm_kernel
from repro_torch.kernels.bag_matmul import ops as bm_ops
from repro_torch.kernels.bag_matmul.ref import bag_matmul_ref
from repro_torch.kernels.cin import kernel as cin_kernel
from repro_torch.kernels.cin import ops as cin_ops
from repro_torch.kernels.cin.ref import cin_layer_ref
from repro_torch.kernels.dequant_bag import kernel, ops, ref
from repro_torch.kernels.hashed_gather import kernel as hg_kernel
from repro_torch.kernels.hashed_gather import ops as hg_ops
from repro_torch.kernels.hashed_gather.ref import hashed_gather_ref
from repro_torch.kernels.rowwise_quant import kernel as rq_kernel
from repro_torch.kernels.rowwise_quant import ops as rq_ops
from repro_torch.kernels.rowwise_quant.ref import quantize_rowwise_ref
from repro_torch.launch import serve, train
from repro_torch.train import setup

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float16",
                                   "float32"])
@pytest.mark.parametrize("b,k,d", [(1000, 1, 64), (1000, 8, 64),
                                   (7, 3, 33), (300, 8, 200)])
def test_dequant_bag_kernel_bit_equal_to_plain(dev, dtype, b, k, d):
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    v = 999
    if dtype == "int8":
        payload = torch.randint(-128, 128, (v, d), generator=g, device=dev,
                                dtype=torch.int8)
    else:
        payload = (torch.randn((v, d), generator=g, device=dev) * 0.1).to(
            getattr(torch, dtype))
    scales = torch.rand(v, generator=g, device=dev) * 0.01
    idx = torch.randint(0, v, (b, k), generator=g, device=dev,
                        dtype=torch.int32)
    w = torch.rand((b, k), generator=g, device=dev)
    w[torch.rand((b, k), generator=g, device=dev) < 0.4] = 0.0
    kernel.reset_launches()
    got = ops.dequant_bag(payload, scales, idx, w)
    want = ref.dequant_bag_ref(payload, scales, idx, w)
    assert kernel.launches[dtype] == 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_packed_lookup_fused_bit_equal_on_card(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    table = torch.randn((3000, 64), generator=g, device=dev) * 0.05
    pri = torch.rand(3000, generator=g, device=dev) * 2e5
    cfg = tqs.FQuantConfig(tiers=TierConfig(5e4, 1.5e5))
    store = tqs.QATStore(table, pri)
    store = store._replace(table=tqs.snap(
        table, tqs.current_tiers(store, cfg), cfg))
    packed = tps.pack(store, cfg)
    idx = torch.randint(0, 3000, (512, 26), generator=g, device=dev)
    fused = tps.lookup_fused(packed, idx)
    assert torch.equal(fused.view(torch.int32),
                       tps.lookup(packed, idx).view(torch.int32))


def test_strict_fp16_store_serves_on_card(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    pri = torch.rand(3000, generator=g, device=dev) * 2e5
    cfg = tqs.FQuantConfig(tiers=TierConfig(5e4, 1.5e5), strict_fp16=True)
    table = torch.randn((3000, 64), generator=g, device=dev) * 0.05
    packed = tps.build_chunked(lambda r0, r1: table[r0:r1], pri, 64, cfg,
                               chunk_rows=1000)
    assert packed.payload16.dtype == torch.float16
    idx = torch.randint(0, 3000, (512, 26), generator=g, device=dev)
    kernel.reset_launches()
    fused = tps.lookup_fused(packed, idx)
    assert kernel.launches["tiered"] == kernel.total_launches() == 1
    assert torch.equal(fused.view(torch.int32),
                       tps.lookup(packed, idx).view(torch.int32))


@pytest.mark.parametrize("name", (*cases.GATHER_CASE_NAMES,
                                  cases.GATHER_BIG))
def test_dequant_bag_rowgrid_on_gather_cases(dev, name):
    """The oracle's vector path on the tiled kernel's cases (every dtype
    at D 1/10/32/33/64/128, K 1/8/40, payloads off 16-byte alignment, the
    2.1 GB int8 payload read past 2^31 bytes): bit-equal to its plain
    version, and to the tiled kernel on every bag that reads no NaN row
    (a NaN row under a zero weight turns the oracle's bag NaN only)."""
    c = next(c for c in cases.gather_cases(dev) if c.name == name)
    args = (c.payload, c.scales, c.indices, c.weights)
    got = kernel.dequant_bag_rowgrid_cuda(*args)
    tiled = kernel.dequant_bag_cuda(*args)
    torch.cuda.synchronize()
    assert _nan_equal(got, ref.dequant_bag_rowgrid_ref(*args))
    fin = torch.isfinite(got).all(1)
    assert torch.equal(got[fin].view(torch.int32),
                       tiled[fin].view(torch.int32))
    assert bool(torch.isfinite(tiled).all())


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float16",
                                   "float32"])
@pytest.mark.parametrize("d", [1, 10, 33, 200])
@pytest.mark.parametrize("k", [1, 2, 3, 5, 8])
def test_dequant_bag_rowgrid_inf_row_under_zero_weight(dev, dtype, d, k):
    """An inf row (an inf scale for int8) under a zero weight: the
    oracle's bag is NaN (inf * 0), as its plain version's; every other bag
    equals the tiled kernel's, which skips the slot."""
    g = torch.Generator(device=dev)
    g.manual_seed(14)
    v, b, bad = 997, 45, 5
    dt = getattr(torch, dtype)
    payload = (torch.randint(-128, 128, (v, d), generator=g, device=dev,
                             dtype=torch.int8) if dt == torch.int8 else
               (torch.randn((v, d), generator=g, device=dev) * 0.1).to(dt))
    scales = torch.rand(v, generator=g, device=dev) * 0.01
    idx = torch.randint(0, v, (b, k), generator=g, device=dev,
                        dtype=torch.int32)
    idx[idx == bad] = bad + 1
    w = torch.rand((b, k), generator=g, device=dev) + 0.5
    w[torch.rand((b, k), generator=g, device=dev) < 0.3] = 0.0
    idx[::3, k - 1], w[::3, k - 1] = bad, 0.0
    if dt == torch.int8:
        scales[bad] = float("inf")
    else:
        payload[bad] = float("inf")
    got = kernel.dequant_bag_rowgrid_cuda(payload, scales, idx, w)
    tiled = kernel.dequant_bag_cuda(payload, scales, idx, w)
    torch.cuda.synchronize()
    assert _nan_equal(got, ref.dequant_bag_rowgrid_ref(payload, scales, idx,
                                                       w))
    assert torch.isnan(got[::3]).all()
    rest = torch.ones(b, dtype=torch.bool, device=dev)
    rest[::3] = False
    assert torch.equal(got[rest].view(torch.int32),
                       tiled[rest].view(torch.int32))


@pytest.mark.parametrize("b,k,d,v", [(1000, 1, 64, 50_000),
                                     (1000, 8, 64, 300),
                                     (37, 3, 33, 20), (300, 2, 200, 7),
                                     (0, 4, 64, 10)])
@pytest.mark.parametrize("scaled", [False, True])
def test_bag_grad_kernel_bit_equal_to_plain(dev, b, k, d, v, scaled):
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    grad = torch.randn((b, d), generator=g, device=dev)
    idx = torch.randint(0, v, (b, k), generator=g, device=dev,
                        dtype=torch.int32)
    w = torch.rand((b, k), generator=g, device=dev)
    w[torch.rand((b, k), generator=g, device=dev) < 0.4] = 0.0
    s = torch.rand(v, generator=g, device=dev) * 3 if scaled else None
    kernel.reset_launches()
    got = ops.bag_grad(grad, s, idx, w, v)
    want = ref.bag_grad_ref(grad, s, idx, w, v)
    torch.cuda.synchronize()
    assert kernel.bag_grad_launches["float32"] == (1 if b else 0)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


GRAD_CASES = ("one_row", "threshold_d64", "threshold_d8", "zeros_nan",
              "misaligned_d1", "misaligned_d8", "misaligned_d10",
              "misaligned_d64", "misaligned_d128", "misaligned_d33",
              "misaligned_d200", "hot_bucket", "one_bucket",
              "window_edges_d33", "window_edges_d64", "shared_runs_k3",
              "empty")


@pytest.mark.parametrize("name", GRAD_CASES)
@pytest.mark.parametrize("grouped", [False, True])
def test_bag_grad_schedules_bit_equal_to_plain_and_rowgrid(dev, name,
                                                           grouped):
    """bag_grad's schedules (one row of every slot, runs at the heavy-run
    threshold and one either side, zero coefficients over a NaN
    cotangent, widths off 16-byte alignment) and the (B, K)-grid
    oracle's (a hot row's bucket, every slot in one bucket, rows across
    and inside its 32-slot windows, K 3, B 0), with and without a
    precomputed grouping: bit-equal to the plain version and to the
    oracle, and finite."""
    by_name = {c.name: c for c in cases.bag_grad_cases(dev,
                                                       kernel.HEAVY_RUN)}
    c = by_name[name]
    plan = kernel.plan_slots(c.indices) if grouped else None
    kernel.reset_launches()
    got = kernel.bag_grad_cuda(c.g, c.indices, c.coeff, c.out, plan=plan)
    want = ref.bag_grad_ref(c.g, None, c.indices, c.coeff, c.vocab)
    oracle = kernel.bag_grad_rowgrid_cuda(c.g, c.indices, c.coeff,
                                          torch.zeros_like(want))
    torch.cuda.synchronize()
    launched = 1 if c.indices.numel() else 0
    assert kernel.bag_grad_launches["float32"] == launched
    assert kernel.rowgrid_launches["bag_grad_rowgrid"] == launched
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(oracle.view(torch.int32), want.view(torch.int32))


def test_bag_grad_fit_shaped_grouping_bit_equal(dev):
    """The hashed fit's adj: (V*C, 2) bags of +-1 signs over S pool rows
    at D = 8, the grouping made once and reused."""
    g = torch.Generator(device=dev)
    g.manual_seed(14)
    bags = torch.randint(0, 3001, (400_000, 2), generator=g, device=dev,
                         dtype=torch.int32)
    signs = (torch.randint(0, 2, (400_000, 2), generator=g, device=dev)
             * 2 - 1).float()
    x = torch.randn((400_000, 8), generator=g, device=dev)
    plan = ops.plan_slots(bags)
    want = ref.bag_grad_ref(x, None, bags, signs, 3001)
    for _ in range(2):
        got = ops.bag_grad(x, None, bags, signs, 3001, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float16",
                                   "float32"])
@pytest.mark.parametrize("which", range(len(cases.MATMUL_SHAPES) + 1))
@pytest.mark.parametrize("scale_after", [False, True])
def test_bag_matmul_schedules_bit_equal_to_plain(dev, dtype, which,
                                                 scale_after):
    """B 1/31/512/513, K 1/39/40, D 1/10/32/384, H 1/63/400/1024, and two
    dead fields over a NaN in w3 (every slot is multiplied: that column
    is NaN in both)."""
    c = cases.bag_matmul_cases(dev, getattr(torch, dtype))[which]
    bm_kernel.reset_launches()
    got = bm_ops.bag_matmul(*c[1:], scale_after=scale_after)
    want = bag_matmul_ref(*c[1:], scale_after=scale_after)
    torch.cuda.synchronize()
    assert bm_kernel.launches[dtype] == 1
    assert _nan_equal(got, want)
    if c.name.startswith("dead"):
        assert bool(torch.isnan(got[:, 7]).all())


def test_train_step_on_card_matches_cpu(dev):
    arch = configs.get("dlrm-rm2")
    gpu = setup.build_recsys_training(arch, batch=256, device=dev)
    cpu = setup.build_recsys_training(arch, batch=256,
                                      device=torch.device("cpu"))
    cpu_state = cpu.state._replace(params=_to(gpu.state.params, "cpu"))
    kernel.reset_launches()
    state, m = gpu.step(gpu.state, gpu.batch_fn(0))
    assert kernel.total_launches() == 1
    assert kernel.bag_grad_launches["float32"] == 1
    cstate, cm = cpu.step(cpu_state, cpu.batch_fn(0))
    assert abs(float(m["loss"]) - float(cm["loss"])) <= 1e-5
    assert torch.equal(state.priority.cpu(), cstate.priority)
    torch.testing.assert_close(state.params["embed_table"].cpu(),
                               cstate.params["embed_table"], rtol=0,
                               atol=1e-4)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def test_train_smoke_launches_both_kernels(dev, tmp_path):
    rec = train.run(train.parse_args(
        ["--model", "smoke", "--steps", "4", "--batch", "128",
         "--ckpt-dir", str(tmp_path)]))
    assert rec["device"] == "cuda"
    assert rec["kernel_launches"] == {"dequant_bag": 4, "bag_grad": 4}


def test_serve_smoke_launches_the_kernel(dev):
    rec = serve.run(serve.parse_args(
        ["--model", "smoke", "--requests", "3", "--batch", "64"])).record
    # one tiered launch a request
    assert rec["device"] == "cuda" and rec["kernel_launches"] == 3


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float16",
                                   "float32"])
@pytest.mark.parametrize("b,k,d,h", [(512, 1, 32, 1024), (37, 5, 10, 70),
                                     (512, 40, 32, 1024), (100, 39, 10, 400),
                                     (7, 3, 200, 33)])
@pytest.mark.parametrize("scale_after", [False, True])
def test_bag_matmul_kernel_bit_equal_to_plain(dev, dtype, b, k, d, h,
                                              scale_after):
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    v = 999
    if dtype == "int8":
        payload = torch.randint(-128, 128, (v, d), generator=g, device=dev,
                                dtype=torch.int8)
    else:
        payload = (torch.randn((v, d), generator=g, device=dev) * 0.1).to(
            getattr(torch, dtype))
    scales = torch.rand(v, generator=g, device=dev) * 0.01
    idx = torch.randint(0, v, (b, k), generator=g, device=dev,
                        dtype=torch.int32)
    w = torch.rand((b, k), generator=g, device=dev)
    w[torch.rand((b, k), generator=g, device=dev) < 0.3] = 0.0
    w3 = torch.randn((k, d, h), generator=g, device=dev)
    bm_kernel.reset_launches()
    got = bm_ops.bag_matmul(payload, scales, idx, w, w3,
                            scale_after=scale_after)
    want = bag_matmul_ref(payload, scales, idx, w, w3,
                          scale_after=scale_after)
    torch.cuda.synchronize()
    assert bm_kernel.launches[dtype] == 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("b,o,h,m,d", [(64, 200, 39, 39, 10),
                                       (64, 200, 200, 39, 10),
                                       (13, 17, 9, 8, 6), (5, 3, 1, 1, 128)])
def test_cin_kernel_bit_equal_to_plain(dev, b, o, h, m, d):
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    w = torch.randn((o, h, m), generator=g, device=dev) / (h * m) ** 0.5
    xk = torch.randn((b, h, d), generator=g, device=dev)
    x0 = torch.randn((b, m, d), generator=g, device=dev)
    cin_kernel.reset_launches()
    got = cin_ops.cin_layer(w, xk, x0)
    want = cin_layer_ref(w, xk, x0)
    torch.cuda.synchronize()
    assert cin_kernel.launches["float32"] == 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("arch", ["wide-deep", "xdeepfm"])
def test_online_fused_serve_smoke_launches_the_kernels(dev, arch):
    rec = serve.run(serve.parse_args(
        ["--arch", arch, "--online", "--fuse-matmul", "--model", "smoke",
         "--requests", "4", "--batch", "64"])).record
    launches = rec["kernel_launches"]
    assert rec["device"] == "cuda" and rec["retiers"] == 2
    assert launches["bag_matmul"] == 3 * 4
    layers = len(getattr(configs.get(arch).smoke_cfg, "cin_layers", ()))
    assert launches["cin"] == layers * 4


@pytest.mark.parametrize("dtype", ["int8", "float32"])
@pytest.mark.parametrize("b,k,c,z", [(20_480, 1, 4, 8), (333, 5, 4, 8),
                                     (77, 3, 2, 5), (0, 1, 2, 4)])
def test_hashed_gather_kernel_bit_equal_to_plain(dev, dtype, b, k, c, z):
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    s = 4001
    if dtype == "int8":
        pool = torch.randint(-128, 128, (s, z), generator=g, device=dev,
                             dtype=torch.int8)
    else:
        pool = torch.randn((s, z), generator=g, device=dev) * 0.1
    scales = torch.rand(s, generator=g, device=dev) * 0.01
    idx = torch.randint(0, 10 ** 6, (b, k), generator=g, device=dev,
                        dtype=torch.int32)
    w = torch.rand((b, k), generator=g, device=dev)
    w[torch.rand((b, k), generator=g, device=dev) < 0.3] = 0.0
    slots, coeff = hg_ops.slot_plan(idx, w if k > 1 else None, num_chunks=c,
                                    num_hashes=2, num_slots=s)
    hg_kernel.reset_launches()
    got = hg_ops.hashed_gather(pool, scales, slots, coeff, num_chunks=c)
    want = hashed_gather_ref(pool, scales, slots, coeff, num_chunks=c)
    torch.cuda.synchronize()
    assert hg_kernel.launches[dtype] == (1 if b else 0)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("v,d", [(1001, 64), (257, 32), (33, 10), (9, 8)])
@pytest.mark.parametrize("mode", ["narrow", "full"])
@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("reciprocal", [False, True])
def test_rowwise_quant_kernel_bit_equal_to_plain(dev, v, d, mode,
                                                 stochastic, reciprocal):
    g = torch.Generator(device=dev)
    g.manual_seed(v + d)
    x = torch.randn((v, d), generator=g, device=dev) * (
        torch.rand((v, 1), generator=g, device=dev) * 10)
    x[0] = 0.0
    noise = (torch.rand((v, d), generator=g, device=dev) if stochastic
             else None)
    rq_kernel.reset_launches()
    q, sc = rq_ops.quantize_rowwise(x, noise, mode, reciprocal=reciprocal)
    wq, ws = quantize_rowwise_ref(x, noise, mode, reciprocal=reciprocal)
    torch.cuda.synchronize()
    assert rq_kernel.launches["float32"] == 1
    assert torch.equal(q, wq)
    assert torch.equal(sc.view(torch.int32), ws.view(torch.int32))


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("reciprocal", [False, True])
def test_rowwise_quant_kernel_non_finite_rows_as_plain(dev, stochastic,
                                                       reciprocal):
    """A NaN row keeps its NaN in the scale (the kernel's max must not
    drop it) and NaN codes store 0, as the plain version's cast does."""
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    v, d = 70, 40
    x = torch.randn((v, d), generator=g, device=dev)
    x[3, 33] = float("nan")            # in the second pass of a lane
    x[4, 0] = float("inf")
    x[5] = -float("inf")
    x[6, 7] = float("nan")
    x[6, 8] = float("inf")
    noise = (torch.rand((v, d), generator=g, device=dev) if stochastic
             else None)
    q, sc = rq_ops.quantize_rowwise(x, noise, reciprocal=reciprocal)
    wq, ws = quantize_rowwise_ref(x, noise, reciprocal=reciprocal)
    torch.cuda.synchronize()
    assert bool(torch.isnan(sc[3, 0])) and bool(torch.isinf(sc[4, 0]))
    assert torch.equal(q, wq)
    torch.testing.assert_close(sc, ws, rtol=0, atol=0, equal_nan=True)


def test_packed_int8_tier_quantizes_through_the_kernel(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    table = torch.randn((3000, 64), generator=g, device=dev) * 0.05
    pri = torch.rand(3000, generator=g, device=dev) * 2e5
    cfg = tqs.FQuantConfig(tiers=TierConfig(5e4, 1.5e5))
    store = tqs.QATStore(table, pri)
    rq_kernel.reset_launches()
    packed = tps.pack(store, cfg)
    assert rq_kernel.launches["float32"] == 1
    cpu = tps.pack(tqs.QATStore(table.cpu(), pri.cpu()), cfg)
    for name in tps.PackedStore._fields:
        a, b = getattr(packed, name).cpu(), getattr(cpu, name)
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b), name


@pytest.mark.parametrize("bits", ["32", "8"])
def test_hashed_online_serve_smoke_launches_the_kernels(dev, bits):
    rec = serve.run(serve.parse_args(
        ["--arch", "wide-deep", "--online", "--store-backend", "hashed",
         "--hash-bits", bits, "--model", "smoke", "--requests", "4",
         "--batch", "64"])).record
    assert rec["device"] == "cuda" and rec["retiers"] == 2
    assert rec["rows_moved"] == 0 and rec["hash_bits"] == int(bits)
    # one gather a request and one per cache rebuild (2 re-tiers)
    assert rec["kernel_launches"]["hashed_gather"] == 4 + 2
    assert rec["build_kernel_launches"]["quantize_rowwise"] == (
        1 if bits == "8" else 0)


def _nan_equal(a, b) -> bool:
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and torch.equal(
        torch.where(na, 0.0, a).view(torch.int32),
        torch.where(nb, 0.0, b).view(torch.int32))


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float16",
                                   "float32"])
@pytest.mark.parametrize("b,k,d", [(1000, 1, 64), (1000, 8, 64),
                                   (7, 3, 33), (0, 2, 64)])
def test_dequant_bag_rowgrid_kernel_bit_equal_to_plain_and_tiled(dev, dtype,
                                                                 b, k, d):
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    v = 3000
    dt = getattr(torch, dtype)
    payload = (torch.randint(-128, 128, (v, d), generator=g, device=dev,
                             dtype=torch.int8) if dt == torch.int8 else
               (torch.randn((v, d), generator=g, device=dev) * 0.1).to(dt))
    scales = torch.rand(v, generator=g, device=dev) * 0.01
    idx = torch.randint(0, v, (b, k), generator=g, device=dev,
                        dtype=torch.int32)
    w = torch.rand((b, k), generator=g, device=dev)
    w[torch.rand((b, k), generator=g, device=dev) < 0.4] = 0.0
    kernel.reset_launches()
    got = ops.dequant_bag_rowgrid(payload, scales, idx, w)
    want = ref.dequant_bag_rowgrid_ref(payload, scales, idx, w)
    tiled = ops.dequant_bag(payload, scales, idx, w)
    torch.cuda.synchronize()
    assert kernel.rowgrid_launches["dequant_bag_rowgrid"] == (1 if b else 0)
    assert _nan_equal(got, want) and _nan_equal(got, tiled)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_dequant_bag_rowgrid_kernel_reads_zero_weight_slots(dev, dtype):
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    v, b, k, bad = 200, 16, 4, 9
    dt = getattr(torch, dtype)
    payload = (torch.randint(-128, 128, (v, 8), generator=g, device=dev,
                             dtype=torch.int8) if dt == torch.int8 else
               torch.randn((v, 8), generator=g, device=dev).to(dt))
    scales = torch.rand(v, generator=g, device=dev)
    idx = torch.randint(0, v, (b, k), generator=g, device=dev,
                        dtype=torch.int32)
    idx[idx == bad] = bad + 1
    w = torch.rand((b, k), generator=g, device=dev) + 0.5
    idx[::2, 2], w[::2, 2] = bad, 0.0
    if dt == torch.int8:
        scales[bad] = float("nan")
    else:
        payload[bad] = float("nan")
    got = ops.dequant_bag_rowgrid(payload, scales, idx, w)
    tiled = ops.dequant_bag(payload, scales, idx, w)
    torch.cuda.synchronize()
    assert _nan_equal(got, ref.dequant_bag_rowgrid_ref(payload, scales, idx,
                                                       w))
    assert _nan_equal(tiled, ref.dequant_bag_ref(payload, scales, idx, w))
    assert torch.isnan(got[::2]).all() and torch.isfinite(tiled).all()


@pytest.mark.parametrize("name", (*cases.GATHER_CASE_NAMES,
                                  cases.GATHER_BIG))
def test_dequant_bag_rowgrid_on_gather_cases(dev, name):
    """The oracle's vector path on the tiled kernel's cases (every dtype
    at D 1/10/32/33/64/128, K 1/8/40, payloads off 16-byte alignment, the
    2.1 GB int8 payload read past 2^31 bytes): bit-equal to its plain
    version, and to the tiled kernel on every bag that reads no NaN row
    (a NaN row under a zero weight turns the oracle's bag NaN only)."""
    c = next(c for c in cases.gather_cases(dev) if c.name == name)
    args = (c.payload, c.scales, c.indices, c.weights)
    got = kernel.dequant_bag_rowgrid_cuda(*args)
    tiled = kernel.dequant_bag_cuda(*args)
    torch.cuda.synchronize()
    assert _nan_equal(got, ref.dequant_bag_rowgrid_ref(*args))
    fin = torch.isfinite(got).all(1)
    assert torch.equal(got[fin].view(torch.int32),
                       tiled[fin].view(torch.int32))
    assert bool(torch.isfinite(tiled).all())


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float16",
                                   "float32"])
@pytest.mark.parametrize("d", [1, 10, 33, 200])
@pytest.mark.parametrize("k", [1, 2, 3, 5, 8])
def test_dequant_bag_rowgrid_inf_row_under_zero_weight(dev, dtype, d, k):
    """An inf row (an inf scale for int8) under a zero weight: the
    oracle's bag is NaN (inf * 0), as its plain version's; every other bag
    equals the tiled kernel's, which skips the slot."""
    g = torch.Generator(device=dev)
    g.manual_seed(14)
    v, b, bad = 997, 45, 5
    dt = getattr(torch, dtype)
    payload = (torch.randint(-128, 128, (v, d), generator=g, device=dev,
                             dtype=torch.int8) if dt == torch.int8 else
               (torch.randn((v, d), generator=g, device=dev) * 0.1).to(dt))
    scales = torch.rand(v, generator=g, device=dev) * 0.01
    idx = torch.randint(0, v, (b, k), generator=g, device=dev,
                        dtype=torch.int32)
    idx[idx == bad] = bad + 1
    w = torch.rand((b, k), generator=g, device=dev) + 0.5
    w[torch.rand((b, k), generator=g, device=dev) < 0.3] = 0.0
    idx[::3, k - 1], w[::3, k - 1] = bad, 0.0
    if dt == torch.int8:
        scales[bad] = float("inf")
    else:
        payload[bad] = float("inf")
    got = kernel.dequant_bag_rowgrid_cuda(payload, scales, idx, w)
    tiled = kernel.dequant_bag_cuda(payload, scales, idx, w)
    torch.cuda.synchronize()
    assert _nan_equal(got, ref.dequant_bag_rowgrid_ref(payload, scales, idx,
                                                       w))
    assert torch.isnan(got[::3]).all()
    rest = torch.ones(b, dtype=torch.bool, device=dev)
    rest[::3] = False
    assert torch.equal(got[rest].view(torch.int32),
                       tiled[rest].view(torch.int32))


@pytest.mark.parametrize("b,k,d,v", [(1000, 1, 64, 50_000),
                                     (300, 8, 64, 40), (37, 3, 33, 20),
                                     (0, 4, 64, 10)])
@pytest.mark.parametrize("scaled", [False, True])
def test_bag_grad_rowgrid_kernel_bit_equal_to_plain_and_tiled(dev, b, k, d,
                                                              v, scaled):
    g = torch.Generator(device=dev)
    g.manual_seed(13)
    grad = torch.randn((b, d), generator=g, device=dev)
    idx = torch.randint(0, v, (b, k), generator=g, device=dev,
                        dtype=torch.int32)
    w = torch.rand((b, k), generator=g, device=dev)
    w[torch.rand((b, k), generator=g, device=dev) < 0.4] = 0.0
    s = torch.rand(v, generator=g, device=dev) * 3 if scaled else None
    kernel.reset_launches()
    got = ops.bag_grad_rowgrid(grad, s, idx, w, v)
    want = ref.bag_grad_rowgrid_ref(grad, s, idx, w, v)
    tiled = ops.bag_grad(grad, s, idx, w, v)
    torch.cuda.synchronize()
    assert kernel.rowgrid_launches["bag_grad_rowgrid"] == (1 if b else 0)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got.view(torch.int32), tiled.view(torch.int32))


@pytest.mark.parametrize("backend", ["packed", "hashed"])
def test_pipeline_smoke_launches_the_kernels(dev, tmp_path, backend):
    from repro_torch import kernels
    from repro_torch.launch import pipeline
    kernels.reset_launches()
    rec = pipeline.run_pipeline(pipeline.fast_config(
        ckpt_dir=str(tmp_path), store_backend=backend))
    kl = rec["kernel_launches"]
    assert rec["device"] == "cuda" and pipeline.verify_failures(rec) == []
    assert kl["train"]["dequant_bag"] == kl["train"]["bag_grad"] == 24
    assert kl["finetune"]["dequant_bag"] == len(rec["finetune_losses"]) > 0
    key = "hashed_gather" if backend == "hashed" else "dequant_bag"
    assert kl["serve"][key] > 0 and kl["eval"][key] > 0


@pytest.mark.parametrize("name", cases.CIN_CASE_NAMES)
def test_cin_cases_bit_equal_to_plain(dev, name):
    """CIN on shapes that the 200 (o) x 40 (n) tiles and 32-deep k chunks
    do not divide (O 17 / 201 / 400, a sample's D = 6 or D = 128 columns
    split across n tiles, H * M of 72, 1,521 and 7,800), H = M = 1, W one
    float off alignment at H * M = 72, and a NaN in W (NaN in its output
    channel in both)."""
    c = {c.name: c for c in cases.cin_cases(dev)}[name]
    assert (c.w.data_ptr() % 16 != 0) == (name == "w_off_k72")
    cin_kernel.reset_launches()
    got = cin_ops.cin_layer(c.w, c.xk, c.x0)
    want = cin_layer_ref(c.w, c.xk, c.x0)
    torch.cuda.synchronize()
    assert cin_kernel.launches["float32"] == 1
    assert _nan_equal(got, want)
    nan = torch.isnan(got)
    if name == "nan_w":
        assert bool(nan[:, 5].all()) and int(nan.sum()) == nan[:, 5].numel()
    else:
        assert not bool(nan.any())


@pytest.mark.parametrize("name", cases.QUANT_CASE_NAMES)
@pytest.mark.parametrize("mode", ["narrow", "full"])
@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("reciprocal", [False, True])
def test_rowwise_quant_cases_bit_equal_to_plain(dev, name, mode, stochastic,
                                                reciprocal):
    """The quantizer's vector, scalar and wide-row paths: D
    64/32/10/8/3/68/133 with zero, .5-multiple, NaN and inf rows beside
    finite ones, and x or noise off 16-byte alignment."""
    c = {c.name: c for c in cases.quant_cases(dev)}[name]
    nz = c.noise if stochastic else None
    rq_kernel.reset_launches()
    q, sc = rq_kernel.quantize_rowwise_cuda(c.x, nz, mode,
                                            reciprocal=reciprocal)
    wq, ws = quantize_rowwise_ref(c.x, nz, mode, reciprocal=reciprocal)
    torch.cuda.synchronize()
    assert rq_kernel.launches["float32"] == 1
    assert torch.equal(q, wq)
    assert _nan_equal(sc, ws)


@pytest.mark.parametrize("name", cases.GATHER_CASE_NAMES + (cases.GATHER_BIG,))
def test_dequant_bag_gather_cases_bit_equal_to_plain(dev, name):
    """The single-tier kernel on its cases: every dtype at D
    1/10/32/33/64/128, K 1/8/40, B of 61/37/64, 30% zero weights, a NaN
    row under zero weights (finite bags), payload views off 16-byte
    alignment, and an int8 payload over 2.1 GB read past 2^31 bytes."""
    c = {c.name: c for c in cases.gather_cases(dev)}[name]
    kernel.reset_launches()
    got = ops.dequant_bag(c.payload, c.scales, c.indices, c.weights)
    want = ref.dequant_bag_ref(c.payload, c.scales, c.indices, c.weights)
    torch.cuda.synchronize()
    assert kernel.launches[str(c.payload.dtype).removeprefix("torch.")] == 1
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("name", cases.TIERED_CASE_NAMES)
def test_dequant_bag_tiered_cases_bit_equal_to_composition(dev, name):
    """The tiered entry in one launch against the per-tier composition,
    through the plain bag and through three single-tier launches (NaN
    bags where a weight is not finite), and at K = 1 unweighted against
    packed_store.lookup."""
    c = {c.name: c for c in cases.tiered_cases(dev)}[name]
    packed = tps.PackedStore(*c.leaves)
    kernel.reset_launches()
    got = ops.packed_bag_lookup(packed, c.ids, c.weights)
    torch.cuda.synchronize()
    assert kernel.launches["tiered"] == kernel.total_launches() == 1
    plain = ops.packed_bag_lookup_tiers(packed, c.ids, c.weights,
                                        bag=ref.dequant_bag_ref)
    composed = ops.packed_bag_lookup_tiers(packed, c.ids, c.weights)
    torch.cuda.synchronize()
    assert _nan_equal(got, plain) and _nan_equal(got, composed)
    if c.weights is not None:
        bad = ~torch.isfinite(c.weights).all(1)
        assert bool(torch.isnan(got[bad]).all())
        assert bool(torch.isfinite(got[~bad]).all())
    elif c.ids.shape[1] == 1:
        plain = tps.lookup(packed, c.ids[:, 0])
        assert torch.equal(got.view(torch.int32), plain.view(torch.int32))


@pytest.mark.parametrize("name", cases.WINDOW_CASE_NAMES)
def test_dequant_bag_window_cases_bit_equal_to_composition(dev, name):
    """The tiered entry's shard window, one launch a shard, against the
    windowed per-shard composition through the plain bag and through
    three single-tier launches (NaN bags where a weight is not finite);
    the shards' sum in shard order is ``sharded_bag_lookup_rect``."""
    from repro_torch.dist import make_mesh
    from repro_torch.dist import packed as dp
    c = {c.name: c for c in cases.window_cases(dev)}[name]
    sp = dp.shard_packed(tps.PackedStore(*c.leaves), make_mesh(c.shards))
    kernel.reset_launches()
    got = [ops.packed_bag_lookup(sh, c.ids, c.weights, firsts=f)
           for sh, f in zip(sp.shards, sp.firsts)]
    torch.cuda.synchronize()
    assert kernel.launches["tiered"] == kernel.total_launches() == c.shards
    for g, sh, f in zip(got, sp.shards, sp.firsts):
        plain = ops.packed_bag_lookup_tiers(sh, c.ids, c.weights,
                                            bag=ref.dequant_bag_ref,
                                            firsts=f)
        composed = ops.packed_bag_lookup_tiers(sh, c.ids, c.weights,
                                               firsts=f)
        assert _nan_equal(g, plain) and _nan_equal(g, composed)
    total = got[0]
    for g in got[1:]:
        total = total + g
    assert _nan_equal(total, dp.sharded_bag_lookup_rect(sp, c.ids,
                                                        weights=c.weights))


@pytest.mark.parametrize("name", cases.HASH_CASE_NAMES)
def test_hashed_gather_cases_both_entries_bit_equal_to_plain(dev, name):
    """The plan and ids entries on the hashed cases (Z 4/5/8, T 1/2/6,
    int8 and fp32 pools, S no power of two, seeds 0 and 7, weighted K = 3
    with zero weights, int64 ids past 2^32): each bit-equal to the plain
    gather of the slot plan."""
    c = {c.name: c for c in cases.hashed_cases(dev)}[name]
    kw = dict(num_chunks=c.num_chunks, num_hashes=c.num_hashes,
              seed=c.seed)
    slots, coeff = hg_ops.slot_plan(c.ids, c.weights,
                                    num_slots=c.pool.shape[0], **kw)
    hg_kernel.reset_launches()
    by_ids = hg_ops.hashed_gather_ids(c.pool, c.scales, c.ids, c.weights,
                                      **kw)
    by_plan = hg_ops.hashed_gather(c.pool, c.scales, slots, coeff,
                                   num_chunks=c.num_chunks)
    want = hashed_gather_ref(c.pool, c.scales, slots, coeff,
                             num_chunks=c.num_chunks)
    torch.cuda.synchronize()
    dtype = str(c.pool.dtype).removeprefix("torch.")
    assert hg_kernel.launches[dtype] == hg_kernel.launches["ids_" + dtype] \
        == 1
    assert torch.equal(by_ids.view(torch.int32), want.view(torch.int32))
    assert torch.equal(by_plan.view(torch.int32), want.view(torch.int32))


# -- metrics on the card: served values do not depend on them ---------------

def _metrics_reset():
    from repro_torch import obs
    obs.close_sink()
    obs.disable()
    obs.get_registry().reset()


def test_online_lookup_bit_identical_with_metrics_on_card(dev):
    from repro_torch import obs
    from repro_torch.serve.online import OnlineConfig, OnlineServer
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    table = torch.randn((4000, 32), generator=g, device=dev) * 0.05
    pri = torch.rand(4000, generator=g, device=dev) * 100
    cfg = tqs.FQuantConfig(tiers=TierConfig(20.0, 60.0), stochastic=False)
    store = tqs.QATStore(table, pri)
    store = store._replace(table=tqs.snap(
        table, tqs.current_tiers(store, cfg), cfg))
    idx = torch.randint(0, 4000, (64, 8), generator=g, device=dev)
    valid = (torch.arange(64) < 50).numpy()[:, None]

    def serve_once():
        srv = OnlineServer(store, cfg, OnlineConfig(cache_rows=128,
                                                    retier_every=2))
        out = torch.stack([srv.lookup(idx, valid=valid, count=50)
                           for _ in range(4)])
        return out, srv.stats

    try:
        off, stats_off = serve_once()
        assert not obs.get_registry().counters
        obs.enable()
        on, stats_on = serve_once()
        reg = obs.get_registry()
        assert torch.equal(on.view(torch.int32), off.view(torch.int32))
        assert stats_on.as_dict() == stats_off.as_dict()
        assert reg.counters["serve.requests"] == 200
        assert reg.counters["serve.lookups"] == stats_on.lookups == 4 * 400
        assert reg.counters["serve.cache.hits"] == stats_on.hits
        assert reg.histograms["serve.retier_us"].count == stats_on.retiers
        assert reg.gauges["store.packed_bytes"] > 0
    finally:
        _metrics_reset()


@pytest.mark.parametrize("serve_batch", [0, 8])
def test_online_serve_bit_identical_with_metrics_on_card(dev, tmp_path,
                                                         serve_batch):
    """Request-at-a-time through the fused head (each request's logits),
    and micro-batched through the unfused one (each batch's served
    embeddings): the same bits with metrics on and off."""
    from repro_torch import obs
    from repro_torch.serve import loop
    from repro_torch.serve.online import OnlineConfig, OnlineServer
    model = configs.get("wide-deep").smoke_model
    spec = model.spec
    params, store, cfg = serve.online_store(model, spec, dev)

    def serve_once():
        # micro-batches that re-tier are not audited: one in three here
        server = OnlineServer(store, cfg, OnlineConfig(
            cache_rows=64, retier_every=16 if serve_batch else 2))
        outs = []
        if serve_batch:
            res = loop.serve_forward(
                server, model, spec, params, serve_batch=serve_batch,
                requests=24, audit=lambda packed, gidx, emb: outs.append(
                    emb.clone()))
        else:
            res = loop.serve_forward_loop(
                server, model, spec, params, batch=64, requests=6,
                fuse_matmul=True,
                audit=lambda r, idx: lambda out, emb: outs.append(
                    out.clone()))
        return outs, res.stats, server

    try:
        off, stats_off, srv_off = serve_once()
        obs.enable()
        path = tmp_path / "m.jsonl"
        obs.set_sink(obs.JsonlSink(str(path), every=2))
        on, stats_on, srv_on = serve_once()
        obs.flush()
        snap = obs.snapshot()
        assert len(on) == len(off) > 0
        for a, b in zip(on, off):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert stats_on == stats_off
        assert torch.equal(srv_on.store.priority, srv_off.store.priority)
        c = snap["counters"]
        assert c["serve.requests"] == stats_on["requests"]
        assert c["serve.lookups"] == stats_on["lookups"]
        assert c.get("serve.retier.rows_moved", 0) == stats_on["rows_moved"]
        h = snap["histograms"]
        assert h["serve.retier_us"]["count"] == stats_on["retiers"]
        assert h["serve.lookup_us"]["count"] == h["serve.request_us"]["count"]
        assert path.read_text().count("\n") >= 2
    finally:
        _metrics_reset()


def test_shadow_repack_stages_on_its_own_stream_on_card(dev, monkeypatch):
    """A shadow re-tier on the card with ``verify_swap``: the staging
    thread verifies on a CUDA stream of its own, lookups served while it
    runs are bit-equal to the live store's plain gather, and the swapped
    store unpacks bit for bit to ``pack`` at the snapshot."""
    from repro_torch.serve import shadow
    from repro_torch.serve.cache import cached_lookup
    from repro_torch.serve.online import OnlineConfig, OnlineServer
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    v, d = 1 << 22, 32
    table = torch.randn((v, d), generator=g, device=dev) * 0.05
    pri = torch.rand(v, generator=g, device=dev) * 100
    cfg = tqs.FQuantConfig(tiers=TierConfig(20.0, 60.0), stochastic=False)
    store = tqs.QATStore(table, pri)
    store = store._replace(table=tqs.snap(
        table, tqs.current_tiers(store, cfg), cfg))
    streams = []
    verify = shadow.ShadowRepack.verify

    def spy(self):
        streams.append(torch.cuda.current_stream(dev))
        return verify(self)
    monkeypatch.setattr(shadow.ShadowRepack, "verify", spy)
    server = OnlineServer(store, cfg, OnlineConfig(
        cache_rows=256, retier_async=True, shadow_rows_per_step=1 << 20,
        verify_swap=True))
    server.observe(torch.randint(0, v, (4096, 8), generator=g, device=dev))
    assert server.begin_retier()
    snap = server.shadow.snapshot
    while not server.shadow.staged:
        server._shadow_tick(1)
    live = server.packed
    assert live is not server.shadow.result
    overlapped = 0
    for _ in range(200):
        alive = server._warmup.is_alive()
        idx = torch.randint(0, v, (512, 40), generator=g, device=dev)
        got, _ = cached_lookup(live, server.cache, idx, server.lookup_fn())
        want = tps.lookup(live, idx)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        overlapped += alive
        if not alive:
            break
    server._warmup.join(timeout=300)
    assert not server._warmup.is_alive()
    assert streams and streams[0] != torch.cuda.default_stream(dev)
    assert overlapped >= 1
    assert server._shadow_tick(1) and server.stats.swaps == 1
    ref = tps.pack(snap, cfg)
    for r0 in range(0, v, 1 << 20):
        a = tps.unpack(server.packed, r0, r0 + (1 << 20))
        b = tps.unpack(ref, r0, r0 + (1 << 20))
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("arch", ["wide-deep", "xdeepfm"])
def test_online_fused_serve_shadow_smoke_on_card(dev, arch):
    """``--retier-async --verify-swap`` through the fused head: swaps land
    and the shadow chunks quantize through the kernel."""
    rq_kernel.reset_launches()
    served = serve.run(serve.parse_args(
        ["--arch", arch, "--online", "--fuse-matmul", "--model", "smoke",
         "--requests", "12", "--batch", "64", "--retier-async",
         "--verify-swap", "--shadow-rows", "65536"]))
    rec, server = served.record, served.server
    assert rec["retier_async"] is True and rec["swaps"] >= 1
    assert server.shadow is None
    assert rec["kernel_launches"]["bag_matmul"] == 3 * 12
    assert rec["kernel_launches"]["quantize_rowwise"] >= (
        server.stats.shadow_chunks)


@pytest.mark.parametrize("d", [8, 64])
def test_bag_grad_accumulate_over_chunks_bit_equal(dev, d):
    """Consecutive runs of bags scattered onto one output (``out=``, the
    hashed fit's row chunks) equal one call over all of them and the plain
    version, bit for bit; one row takes over the heavy-run threshold in
    two of the runs, so both the heavy and the light path accumulate."""
    g = torch.Generator(device=dev)
    g.manual_seed(15)
    n, v = 300_000, 3001
    bags = torch.randint(0, v, (n, 2), generator=g, device=dev,
                         dtype=torch.int32)
    bags[100_000:120_000, 0] = 7
    bags[250_000:280_000, 1] = 7
    signs = (torch.randint(0, 2, (n, 2), generator=g, device=dev)
             * 2 - 1).float()
    x = torch.randn((n, d), generator=g, device=dev)
    one = ops.bag_grad(x, None, bags, signs, v)
    want = ref.bag_grad_ref(x, None, bags, signs, v)
    out = torch.zeros((v, d), device=dev)
    kernel.reset_launches()
    for r0, r1 in ((0, 111_111), (111_111, 260_000), (260_000, n)):
        ops.bag_grad(x[r0:r1], None, bags[r0:r1], signs[r0:r1], v, out=out)
    torch.cuda.synchronize()
    assert kernel.bag_grad_launches["float32"] == 3
    assert torch.equal(one.view(torch.int32), want.view(torch.int32))
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


def test_chunked_fit_on_card_bit_equal_to_one_call(dev, monkeypatch):
    from repro_torch.store import hashed as H
    g = torch.Generator(device=dev)
    g.manual_seed(16)
    table = torch.randn((50_003, 16), generator=g, device=dev) * 0.05
    cfg = H.HashedConfig(vocab=50_003, dim=16, chunk_dim=8, num_slots=3001)
    checked = []

    def audit(r0, r1, x, bags, signs, before, after):
        want = ref.bag_grad_ref(x, None, bags, signs, cfg.num_slots,
                                out=before)
        checked.append(torch.equal(after.view(torch.int32),
                                   want.view(torch.int32)))
    one = H.fit_pool_from_table(table, cfg)
    monkeypatch.setattr(H, "FIT_PLAN_SLOTS", 0)      # 7,001 rows a chunk
    monkeypatch.setattr(H, "FIT_CHUNK_ROWS", 7001)
    chunked = H.fit_pool_from_table(table, cfg, audit=audit)
    torch.cuda.synchronize()
    assert checked == [True] * 8
    assert torch.equal(chunked.pool.view(torch.int32),
                       one.pool.view(torch.int32))
    assert 0.0 < H.fit_residual(one, cfg, table) < 1.0


def test_hashed_train_step_kernels_bit_equal_to_plain(dev):
    """The hashed step's forward (``hashed_gather``'s plan entry) and its
    pool gradient (``bag_grad``) against their plain versions on the same
    inputs, one launch each."""
    from repro_torch.kernels.hashed_gather.autodiff import (
        hashed_lookup_train)
    from repro_torch.kernels.hashed_gather.ops import slot_plan
    from repro_torch.kernels.hashed_gather.ref import hashed_grad_ref
    g = torch.Generator(device=dev)
    g.manual_seed(17)
    pool = torch.randn((4001, 8), generator=g, device=dev) * 0.05
    gidx = torch.randint(0, 200_000, (512, 10), generator=g, device=dev,
                         dtype=torch.int32)
    cot = torch.randn((512, 10, 16), generator=g, device=dev)
    kw = dict(num_chunks=2, num_hashes=4, seed=0)
    kernel.reset_launches()
    hg_kernel.reset_launches()
    leaf = pool.clone().requires_grad_()
    emb = hashed_lookup_train(leaf, gidx, **kw)
    (dpool,) = torch.autograd.grad(emb, leaf, cot)
    torch.cuda.synchronize()
    assert hg_kernel.launches["float32"] == 1
    assert kernel.bag_grad_launches["float32"] == 1
    slots, coeff = slot_plan(gidx.reshape(-1, 1), None, num_chunks=2,
                             num_hashes=4, num_slots=4001, seed=0)
    want = hashed_gather_ref(pool, None, slots, coeff, num_chunks=2)
    assert torch.equal(emb.detach().reshape(-1, 16).view(torch.int32),
                       want.view(torch.int32))
    want_grad = hashed_grad_ref(cot.reshape(-1, 16), None, slots, coeff,
                                4001, num_chunks=2)
    assert torch.equal(dpool.view(torch.int32), want_grad.view(torch.int32))


def _hier_on_card(dev, tmp_path, v=1 << 16, d=32, frac=6):
    """A hier store on the card: a snapped random table, pareto
    priorities, hot and warm budgets of 1/``frac`` of the pack each, the
    rest cold."""
    import numpy as np
    from repro_torch.store.hier import HierConfig, build_hier
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    table = torch.randn((v, d), generator=g, device=dev) * 0.05
    pri = torch.from_numpy((np.random.default_rng(0).pareto(1.2, v) * 20
                            ).astype(np.float32)).to(dev)
    cfg = tqs.FQuantConfig(tiers=TierConfig(5.0, 50.0), stochastic=False)
    store = tqs.QATStore(table, pri)
    store = store._replace(table=tqs.snap(
        table, tqs.current_tiers(store, cfg), cfg))
    b = tps.pack(store, cfg).nbytes() // frac
    hier = build_hier(store, cfg, HierConfig(b, b, 4096,
                                             str(tmp_path / "cold")))
    return hier, store, cfg


def test_hier_staging_back_to_back_on_card(dev, tmp_path):
    """Two micro-batches staged back to back, before either is read: each
    staging buffer on the card holds its own batch's rows (the pinned host
    block of the first is not handed to the second while its copy is in
    flight), and the combined rows equal the host oracle bit for bit."""
    import numpy as np
    from repro_torch.store.hier import combine_rows
    hier, _, _ = _hier_on_card(dev, tmp_path)
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, hier.vocab, (512, 26)) for _ in range(6)]
    staged = [hier.stage(b) for b in batches]       # no sync in between
    for b, sb in zip(batches, staged):
        rows = combine_rows(hier.hot_dev, sb.hot_local, sb.stage_slot,
                            sb.staging)
        want = torch.from_numpy(hier.gather_fp32_host(b)).to(dev)
        assert sb.staged > 0
        assert torch.equal(rows.view(torch.int32), want.view(torch.int32))


def test_hier_staged_serve_audit_on_card(dev, tmp_path):
    """The staged serve loop on the card, each audited batch: the hot
    level's fused gather equals the plain lookup and the served embeddings
    the host oracle, bit for bit; one tiered dequant_bag launch a
    micro-batch; migrations quantize through the kernel; after the
    serve, ``--verify-hier`` is bit-identical over every row."""
    from repro_torch.kernels.dequant_bag import ops as dops
    from repro_torch.serve import loop
    from repro_torch.serve.online import OnlineConfig, OnlineServer
    from repro_torch.store.hier import HierConfig
    model = configs.get("wide-deep").smoke_model
    spec = model.spec
    params, store, cfg = serve.online_store(model, spec, dev)
    b = tps.pack(store, cfg).nbytes() // 8
    server = OnlineServer(store, cfg, OnlineConfig(cache_rows=64,
                                                   retier_every=16),
                          hier=HierConfig(b, b, 4096,
                                          str(tmp_path / "cold")))
    seen = []

    def audit(hot, sb, gidx, emb):
        fused = dops.packed_lookup_fused(hot, sb.hot_local)
        plain = tps.lookup(hot, sb.hot_local)
        want = server.hier.gather_fp32_host(gidx.cpu().numpy())
        seen.append(torch.equal(fused.view(torch.int32),
                                plain.view(torch.int32))
                    and torch.equal(emb.cpu().view(torch.int32),
                                    torch.from_numpy(want).view(torch.int32)))
    kernel.reset_launches()
    rq_kernel.reset_launches()
    res = loop.serve_forward(server, model, spec, params, serve_batch=8,
                             requests=64, audit=audit)
    assert seen and all(seen)
    assert res.stats["migrations"] == 4 and res.stats["cold_hits"] > 0
    # one tiered launch a batch, one more an audited batch's fused check
    assert kernel.launches["tiered"] == 8 + len(seen)
    assert rq_kernel.total_launches() >= 1
    serve.verify_hier(server)


@pytest.fixture
def devs():
    """Up to four CUDA devices, one shard each (``make_mesh(n,
    devices=)``); skips with fewer than two."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    return [torch.device("cuda", i)
            for i in range(min(4, torch.cuda.device_count()))]


def _mesh_store(dev, seed: int, v: int = 4099, d: int = 32):
    """A snapped store on ``dev`` with rows in all three tiers."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    table = torch.randn((v, d), generator=g, device=dev) * 0.05
    pri = torch.rand(v, generator=g, device=dev) * 100
    cfg = tqs.FQuantConfig(tiers=TierConfig(20.0, 60.0), stochastic=False)
    store = tqs.QATStore(table, pri)
    store = store._replace(table=tqs.snap(
        table, tqs.current_tiers(store, cfg), cfg))
    return store, cfg, g


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().cpu().view(torch.uint8)


def test_mesh_over_devices_serves_as_the_one_device_mesh(devs):
    """One shard a device: each shard copied to its device, ``indirect``
    once a device; the sharded lookup, the rectangular bag, the fused
    first layer, ``unshard_packed`` and the hashed lookup equal the same
    mesh size on one device bit for bit (the same partials, summed in
    shard order on the first device); the ragged bag within 2e-5."""
    from repro_torch.dist import make_mesh
    from repro_torch.dist import hashed as dh
    from repro_torch.dist import packed as dp
    from repro_torch.store import hashed as th
    n = len(devs)
    store, cfg, g = _mesh_store(devs[0], 11)
    packed = tps.pack(store, cfg)
    one = dp.shard_packed(packed, make_mesh(n, device=devs[0]))
    multi = dp.shard_packed(packed, make_mesh(n, devices=devs))
    assert one.base is packed and multi.base is None
    for sh, d in zip(multi.shards, devs):
        assert all(leaf.device == d for leaf in sh)
    assert all(torch.equal(_bytes(a), _bytes(b))
               for a, b in zip(dp.unshard_packed(multi), packed))
    v, d = packed.vocab, packed.dim
    ids = torch.randint(0, v, (96, 7), generator=g, device=devs[0])
    w = torch.randn((96, 7), generator=g, device=devs[0])
    w[torch.rand((96, 7), generator=g, device=devs[0]) < 0.3] = 0.0
    kernel.reset_launches()
    got = dp.sharded_lookup(multi, ids)
    torch.cuda.synchronize()
    assert kernel.launches["tiered"] == kernel.total_launches() == n
    assert got.device == devs[0]
    assert torch.equal(_bytes(got), _bytes(tps.lookup(packed, ids)))
    assert torch.equal(_bytes(got), _bytes(dp.sharded_lookup(one, ids)))
    assert torch.equal(
        _bytes(dp.sharded_bag_lookup_rect(multi, ids, weights=w)),
        _bytes(dp.sharded_bag_lookup_rect(one, ids, weights=w)))
    flat = ids.reshape(-1)
    seg = torch.arange(96, device=devs[0]).repeat_interleave(7)
    # the ragged bag sums with index_add_, whose CUDA atomics fix no
    # order: the reference's own 2e-5
    torch.testing.assert_close(
        dp.sharded_bag_lookup(multi, flat, seg, 96, weights=w.reshape(-1)),
        dp.sharded_bag_lookup(one, flat, seg, 96, weights=w.reshape(-1)),
        rtol=0, atol=2e-5)
    wm = torch.randn((7 * d, 16), generator=g, device=devs[0]) * 0.1
    bm_kernel.reset_launches()
    got_mm = dp.sharded_bag_matmul(multi, ids, wm, weights=w)
    torch.cuda.synchronize()
    assert bm_kernel.total_launches() == 3 * n
    assert torch.equal(_bytes(got_mm), _bytes(dp.sharded_bag_matmul(
        one, ids, wm, weights=w)))
    hcfg = th.HashedConfig(vocab=5000, dim=32, chunk_dim=8, num_slots=1001)
    hs = th.init_hashed(hcfg, seed=3, device=devs[0])
    hone = dh.shard_hashed(hs, make_mesh(n, device=devs[0]))
    hmulti = dh.shard_hashed(hs, make_mesh(n, devices=devs))
    assert [p.device for p in hmulti.pools] == devs
    hid = torch.randint(0, 5000, (300,), generator=g, device=devs[0])
    hg_kernel.reset_launches()
    got_h = dh.sharded_hashed_lookup(hmulti, hcfg, hid)
    torch.cuda.synchronize()
    assert hg_kernel.total_launches() == n
    assert torch.equal(_bytes(got_h), _bytes(dh.sharded_hashed_lookup(
        hone, hcfg, hid)))


@pytest.mark.parametrize("retier_async", [False, True])
def test_online_server_over_devices_as_the_one_device_mesh(devs,
                                                           retier_async):
    """``OnlineServer`` with one shard a device: its re-tiers (unshard onto
    the first device, ``repack_delta``, reshard) move the same rows and
    every request's embeddings equal the one-device mesh's bit for bit."""
    from repro_torch.dist import make_mesh
    from repro_torch.dist.packed import ShardedPack
    from repro_torch.serve.online import OnlineConfig, OnlineServer
    n = len(devs)
    store, cfg, g = _mesh_store(devs[0], 12)
    reqs = [torch.randint(0, store.table.shape[0], (64, 8), generator=g,
                          device=devs[0]) for _ in range(6)]
    ocfg = OnlineConfig(cache_rows=128, retier_every=2,
                        retier_async=retier_async, shadow_rows_per_step=256)

    def serve(mesh):
        srv = OnlineServer(store, cfg, ocfg, mesh=mesh)
        out = torch.stack([srv.lookup(r) for r in reqs])
        if retier_async:
            srv.drain_shadow()
        assert isinstance(srv.backend.packed, ShardedPack)
        return out, srv.stats.as_dict(), srv.backend.packed

    out1, stats1, _ = serve(make_mesh(n, device=devs[0]))
    outn, statsn, packed = serve(make_mesh(n, devices=devs))
    assert stats1["rows_moved"] > 0
    for k in ("requests", "lookups", "hits", "retiers", "rows_moved",
              "swaps"):
        assert statsn[k] == stats1[k], k
    assert [sh.payload32.device for sh in packed.shards] == devs
    assert torch.equal(_bytes(outn), _bytes(out1))


def test_hier_over_devices_charges_each_card_its_shard(devs, tmp_path):
    """``build_hier`` with one shard a device charges each card its shard,
    as the reference charges a device (``plan_placement(n_shards=N)``),
    where N shards on one card are charged the whole level once; the two
    stores' lookups are equal bit for bit."""
    from repro_torch.core.qat_store import current_tiers
    from repro_torch.dist import make_mesh
    from repro_torch.store import hier as th
    from repro_torch.store.budget import plan_placement
    n = len(devs)
    store, cfg, g = _mesh_store(devs[0], 13)
    b = tps.pack(store, cfg).nbytes() // 16
    multi = th.build_hier(store, cfg, th.HierConfig(
        b, b, 64, str(tmp_path / "m")), mesh=make_mesh(n, devices=devs))
    one = th.build_hier(store, cfg, th.HierConfig(
        b, b, 64, str(tmp_path / "o")), mesh=make_mesh(n, device=devs[0]))
    plan = plan_placement(store.priority, current_tiers(store, cfg),
                          store.table.shape[1], b, b, n_shards=n)
    assert (multi.n_shards, one.n_shards) == (n, 1)
    assert (multi.hot_ids == plan.hot_ids).all()
    assert multi.hot_ids.size > one.hot_ids.size
    assert multi.cold_ids.size
    assert [sh.payload32.device for sh in multi.served.shards] == devs
    ids = torch.randint(0, store.table.shape[0], (512,), generator=g,
                        device=devs[0])
    assert torch.equal(_bytes(th.hier_lookup(multi, ids)),
                       _bytes(th.hier_lookup(one, ids)))


# ---- tilings (the autotune cache's candidates) ---------------------------

def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("b,k,d", [(64, 8, 64), (32, 4, 96), (512, 40, 32),
                                   (20000, 1, 64), (300, 3, 10)])
def test_dequant_bag_tilings_bit_equal_to_analytic(dev, dtype, b, k, d):
    """Every candidate tiling of the single-tier entry gives the analytic
    pick's bits; the mirror of the analytic rule is the kernel's."""
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    v = 777
    payload = (torch.randint(-128, 128, (v, d), generator=g, device=dev,
                             dtype=torch.int8) if dtype == "int8" else
               (torch.randn((v, d), generator=g, device=dev)).to(
                   getattr(torch, dtype)))
    scales = torch.rand(v, generator=g, device=dev) * 0.01
    idx = torch.randint(0, v, (b, k), generator=g, device=dev,
                        dtype=torch.int32)
    w = torch.rand((b, k), generator=g, device=dev)
    w[torch.rand((b, k), generator=g, device=dev) < 0.3] = 0.0
    analytic = kernel.dequant_bag_analytic(b, k, d, dev)
    assert analytic == kernel.dequant_bag_analytic(b, k, d)
    want = kernel.dequant_bag_cuda(payload, scales, idx, w)
    assert torch.equal(_bits(want), _bits(kernel.dequant_bag_cuda(
        payload, scales, idx, w, tiling=analytic)))
    from repro_torch.kernels import autotune
    cands = autotune.candidate_tilings("dequant_bag", analytic, dev, b=b,
                                       k=k, d=d)
    assert cands[0] == analytic and len(cands) > 1
    for t in cands:
        got = kernel.dequant_bag_cuda(payload, scales, idx, w, tiling=t)
        assert torch.equal(_bits(got), _bits(want)), t


@pytest.mark.parametrize("b,k,d", [(64, 8, 64), (512, 40, 32),
                                   (4000, 1, 10), (3000, 2, 96)])
def test_bag_grad_tilings_bit_equal_to_analytic(dev, b, k, d):
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    v = 500
    grad = torch.randn((b, d), generator=g, device=dev)
    # a zipf-ish index draw: some runs pass HEAVY_RUN
    idx = (torch.rand((b, k), generator=g, device=dev) ** 4 * v).to(
        torch.int32)
    coeff = torch.rand((b, k), generator=g, device=dev)
    analytic = kernel.bag_grad_analytic(d, device=dev)
    assert analytic == kernel.bag_grad_analytic(d)
    want = kernel.bag_grad_cuda(grad, idx, coeff, torch.zeros(
        (v, d), device=dev))
    for t in kernel.bag_grad_tilings(d):
        got = kernel.bag_grad_cuda(grad, idx, coeff, torch.zeros(
            (v, d), device=dev), tiling=t)
        assert torch.equal(_bits(got), _bits(want)), t


@pytest.mark.parametrize("dtype", ["int8", "float32"])
@pytest.mark.parametrize("b,k,d,h", [(64, 8, 64, 32), (512, 40, 32, 1024),
                                     (512, 39, 10, 400)])
def test_bag_matmul_tilings_bit_equal_to_analytic(dev, dtype, b, k, d, h):
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    v = 512
    payload = (torch.randint(-128, 128, (v, d), generator=g, device=dev,
                             dtype=torch.int8) if dtype == "int8" else
               torch.randn((v, d), generator=g, device=dev))
    scales = torch.rand(v, generator=g, device=dev) * 0.01
    idx = torch.randint(0, v, (b, k), generator=g, device=dev,
                        dtype=torch.int32)
    w = torch.rand((b, k), generator=g, device=dev)
    w3 = torch.randn((k, d, h), generator=g, device=dev) * 0.1
    analytic = bm_kernel.bag_matmul_analytic(b, h, dev)
    assert analytic == bm_kernel.bag_matmul_analytic(b, h)
    want = bm_kernel.bag_matmul_cuda(payload, scales, idx, w, w3)
    for t in bm_kernel.bag_matmul_tilings():
        got = bm_kernel.bag_matmul_cuda(payload, scales, idx, w, w3,
                                        tiling=t)
        assert torch.equal(_bits(got), _bits(want)), t


@pytest.mark.parametrize("dtype", ["int8", "float32"])
@pytest.mark.parametrize("b,c,k,nh,z", [(20480, 4, 1, 2, 8),
                                        (300, 2, 3, 2, 5)])
def test_hashed_gather_tilings_bit_equal_to_analytic(dev, dtype, b, c, k,
                                                     nh, z):
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    s = 3001
    pool = (torch.randint(-128, 128, (s, z), generator=g, device=dev,
                          dtype=torch.int8) if dtype == "int8" else
            torch.randn((s, z), generator=g, device=dev))
    scales = torch.rand(s, generator=g, device=dev) * 0.01
    ids = torch.randint(0, 10**6, (b, k), generator=g, device=dev)
    w = torch.rand((b, k), generator=g, device=dev)
    analytic = hg_kernel.hashed_gather_analytic(c, z, dev)
    assert analytic == hg_kernel.hashed_gather_analytic(c, z)
    want = hg_kernel.hashed_gather_ids_cuda(pool, scales, ids, w,
                                            num_chunks=c, num_hashes=nh)
    slots, coeff = hg_ops.slot_plan(ids, w, num_chunks=c, num_hashes=nh,
                                    num_slots=s)
    for t in hg_kernel.hashed_gather_tilings(c, z):
        got = hg_kernel.hashed_gather_ids_cuda(pool, scales, ids, w,
                                               num_chunks=c, num_hashes=nh,
                                               tiling=t)
        assert torch.equal(_bits(got), _bits(want)), t
        got = hg_kernel.hashed_gather_cuda(pool, scales, slots, coeff,
                                           num_chunks=c, tiling=t)
        assert torch.equal(_bits(got), _bits(want)), t


def test_cached_tiling_is_served_and_bit_equal(dev, tmp_path, monkeypatch):
    """A seeded cache entry reaches the launch (the wrapper resolves
    argument > cache > analytic) and changes no bit."""
    from repro_torch.kernels import autotune
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "a.json"))
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    payload = torch.randint(-128, 128, (300, 64), generator=g, device=dev,
                            dtype=torch.int8)
    scales = torch.rand(300, generator=g, device=dev)
    idx = torch.randint(0, 300, (64, 8), generator=g, device=dev,
                        dtype=torch.int32)
    w = torch.rand((64, 8), generator=g, device=dev)
    want = ops.dequant_bag(payload, scales, idx, w)
    seen = []
    real = kernel.dequant_bag_cuda
    monkeypatch.setattr(ops, "dequant_bag_cuda", lambda *a, **kw: (
        seen.append(kw["tiling"]), real(*a, **kw))[1])
    autotune.store("dequant_bag", "int8", 64, 8, 64, 64, 16, 1.0,
                   device=dev)
    got = ops.dequant_bag(payload, scales, idx, w)
    assert seen == [(64, 16)]
    assert torch.equal(_bits(got), _bits(want))
    ops.dequant_bag(payload, scales, idx, w, tiling=(16, 64))
    assert seen[-1] == (16, 64)


def test_bag_matmul_train_runs_on_the_card(dev):
    """The forward is the bag_matmul kernel and the table's gradient the
    bag_grad kernel, bit-equal to each launched alone."""
    from repro_torch.kernels.bag_matmul import bag_matmul_train
    g = torch.Generator(device=dev)
    g.manual_seed(8)
    b, k, d, h, v = 64, 6, 32, 96, 400
    table = torch.randn((v, d), generator=g, device=dev)
    idx = torch.randint(0, 50, (b, k), generator=g, device=dev,
                        dtype=torch.int32)
    w = torch.rand((b, k), generator=g, device=dev) + 0.5
    w3 = torch.randn((k, d, h), generator=g, device=dev)
    r = torch.randn((b, h), generator=g, device=dev)
    tt = table.clone().requires_grad_()
    bm_kernel.reset_launches()
    kernel.reset_launches()
    out = bag_matmul_train(tt, idx, w3, w)
    torch.sum(out * r).backward()
    assert bm_kernel.total_launches() == 1
    assert kernel.bag_grad_launches["float32"] == 1
    assert torch.equal(_bits(out), _bits(bm_ops.bag_matmul(
        table, None, idx, w, w3)))
    gk = torch.einsum("bh,kdh->bkd", r, w3)
    want = ops.bag_grad(gk.reshape(b * k, d).contiguous(), None,
                        idx.reshape(-1, 1), w.reshape(-1, 1), v)
    assert torch.equal(_bits(tt.grad), _bits(want))


def test_autotune_timer_reads_the_device_not_the_host(dev):
    """A call that holds the host 1 ms around a launch of a few us still
    times as the launch: the delay grows until the window's dispatch fits
    in it."""
    import time as _time
    from repro_torch.kernels import autotune
    x = torch.ones(1024, device=dev)

    def host_heavy():
        _time.sleep(1e-3)
        x.add_(1.0)

    us = autotune.time_us(host_heavy, iters=2, device=dev)
    assert 0 < us < 200, us


# ---- the SPMD layer: the int8 gradient exchange and split-KV decode ----

def _exchange(mesh, n: int, steps: int, dev_of):
    """``error_feedback_allreduce`` over ``mesh`` for ``steps`` steps of
    seeded gradients (numpy, so every device gets the same), the residual
    carried: each step's (means, residuals) on the CPU."""
    import numpy as np

    from repro_torch.optim import error_feedback_allreduce
    rng = np.random.default_rng(5)
    w = mesh.size
    res = [torch.zeros(n, device=dev_of(i)) for i in range(w)]
    out = []
    for _ in range(steps):
        grads = [torch.from_numpy((rng.standard_normal(n) * 1e-2).astype(
            np.float32)).to(dev_of(i)) for i in range(w)]
        means, res = error_feedback_allreduce(grads, res, mesh)
        out.append(([m.cpu() for m in means], [r.cpu() for r in res]))
    return out


def test_grad_exchange_on_card_bit_equal_to_the_cpu(dev):
    """Phase 22(a) at a small size: 4 logical shards on the card, 3 steps;
    4 quantizer launches a step, and every mean and residual equal to the
    CPU run (the plain quantizer) bit for bit."""
    from repro_torch.dist import make_mesh
    n = 1_000_003
    rq_kernel.reset_launches()
    card = _exchange(make_mesh(4, device=dev), n, 3, lambda i: dev)
    assert rq_kernel.total_launches() == 4 * 3
    cpu = _exchange(make_mesh(4, device="cpu"), n, 3, lambda i: "cpu")
    for (cm, cr), (pm, pr) in zip(card, cpu):
        for a, b in zip(cm + cr, pm + pr):
            assert torch.equal(a, b)


def _split_kv_inputs(dev, b=2, s=4096, h=8, d=64):
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    return (torch.randn((b, h, d), generator=g, device=dev),
            torch.randn((b, s, h, d), generator=g, device=dev),
            torch.randn((b, s, h, d), generator=g, device=dev))


def _full_softmax(q, k, v, cache_len: int, scale: float):
    sc = torch.einsum("bhd,bkhd->bhk", q.double(),
                      k[:, :cache_len + 1].double()) * scale
    return torch.einsum("bhk,bkhd->bhd", torch.softmax(sc, dim=-1),
                        v[:, :cache_len + 1].double())


def test_split_kv_on_card_matches_the_full_softmax(dev):
    """Phase 22(b) at a small size: 4 views of one cache on the card,
    within 2e-5 of the full softmax and of the CPU run."""
    from repro_torch.dist import make_mesh
    from repro_torch.dist.collectives import split_kv_decode_attention
    q, k, v = _split_kv_inputs(dev)
    out = split_kv_decode_attention(make_mesh(4, device=dev), q, k, v, 2047,
                                    0.125)
    assert out.device.type == "cuda"
    torch.testing.assert_close(out.double(), _full_softmax(q, k, v, 2047,
                                                           0.125),
                               rtol=2e-5, atol=2e-5)
    cpu = split_kv_decode_attention(make_mesh(4, device="cpu"), q.cpu(),
                                    k.cpu(), v.cpu(), 2047, 0.125)
    torch.testing.assert_close(out.cpu(), cpu, rtol=2e-5, atol=2e-5)


def test_grad_exchange_over_devices_as_the_one_device_mesh(devs):
    """One shard a card (``make_mesh(n, devices=)``): each card's payloads
    copied to every card, each card's mean and every residual equal to the
    one-card mesh's bit for bit."""
    from repro_torch.dist import make_mesh
    n, w = 1_000_003, len(devs)
    one = _exchange(make_mesh(w, device=devs[0]), n, 2, lambda i: devs[0])
    many = _exchange(make_mesh(w, devices=devs), n, 2, lambda i: devs[i])
    for (om, orr), (mm, mr) in zip(one, many):
        for a, b in zip(om + orr, mm + mr):
            assert torch.equal(a, b)


def test_split_kv_over_devices_as_the_one_device_mesh(devs):
    """Shard i's cache slots on card i: within 2e-5 of the one-card mesh
    and of the full softmax, the result on the first card."""
    from repro_torch.dist import make_mesh
    from repro_torch.dist.collectives import (shard_sequence,
                                              split_kv_decode_attention)
    q, k, v = _split_kv_inputs(devs[0])
    w = len(devs)
    mesh = make_mesh(w, devices=devs)
    ks, vs = shard_sequence(mesh, k), shard_sequence(mesh, v)
    assert [x.device for x in ks] == list(mesh.devices)
    out = split_kv_decode_attention(mesh, q, ks, vs, 3000, 0.125)
    one = split_kv_decode_attention(make_mesh(w, device=devs[0]), q, k, v,
                                    3000, 0.125)
    assert out.device == mesh.device
    torch.testing.assert_close(out, one, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(out.double(), _full_softmax(q, k, v, 3000,
                                                           0.125),
                               rtol=2e-5, atol=2e-5)


def test_kernel_ops_on_cuda_launch_their_kernels(dev):
    """The CUDA side of the ops' dispatch, unchanged beside the dry run's
    ``meta`` branch: a CUDA tensor launches the kernel, once."""
    from repro_torch import kernels as kernels_mod
    ids = torch.zeros((4, 3), dtype=torch.int32, device=dev)
    w = torch.ones((4, 3), device=dev)
    calls = {
        "dequant_bag": lambda: ops.dequant_bag(
            torch.zeros((6, 8), device=dev), None, ids, w),
        "bag_grad": lambda: ops.bag_grad(torch.zeros((4, 8), device=dev),
                                         None, ids, w, 6),
        "bag_matmul": lambda: bm_ops.bag_matmul(
            torch.zeros((6, 8), device=dev), None, ids, w,
            torch.zeros((3, 8, 5), device=dev)),
        "cin": lambda: cin_ops.cin_layer(
            torch.zeros((5, 3, 3), device=dev),
            torch.zeros((4, 3, 8), device=dev),
            torch.zeros((4, 3, 8), device=dev)),
        "hashed_gather": lambda: hg_ops.hashed_gather_ids(
            torch.zeros((16, 4), device=dev), None, ids, num_chunks=2,
            num_hashes=2),
        "quantize_rowwise": lambda: rq_ops.quantize_rowwise(
            torch.zeros((6, 256), device=dev)),
    }
    for name, call in calls.items():
        before = kernels_mod.launch_counts()[name]
        out = call()
        assert kernels_mod.launch_counts()[name] == before + 1, name
        first = out[0] if isinstance(out, tuple) else out
        assert first.device.type == "cuda", name


def _bits(x) -> torch.Tensor:
    from repro_torch.dist.packed import whole
    return whole(x).detach().contiguous().cpu().view(torch.uint8)


def _train_leaves(state) -> list:
    return [state.params["embed_table"], state.opt[1], state.priority,
            state.accum.access, state.accum.field_score]


def _train_steps(mesh, steps: int, dev, state=None):
    """dlrm-rm2 smoke over ``mesh`` for ``steps`` steps: (setup, state,
    losses, (forward, bag_grad) launches a step)."""
    tr = setup.build_recsys_training(configs.get("dlrm-rm2"), batch=256,
                                     device=dev, model="smoke", mesh=mesh,
                                     state=state)
    st, losses, launches = tr.state, [], []
    for s in range(steps):
        kernel.reset_launches()
        st, m = tr.step(st, tr.batch_fn(s))
        losses.append(float(m["loss"]))
        launches.append((kernel.launches["float32"],
                         kernel.bag_grad_launches["float32"]))
    return tr, st, losses, launches


def test_train_over_devices_as_the_one_device_mesh(devs):
    """dlrm-rm2 smoke, the state placed one row shard a card
    (``make_mesh(n, devices=)``): shard i of the table, the adagrad
    accumulator, the priority and the access EMA on card i, each a tensor
    of its own; three steps, the forward and bag_grad once a shard a step;
    every row-aligned leaf, the field score and the loss equal to
    ``make_mesh(n)`` on the first card bit for bit after each step."""
    from repro_torch.dist import make_mesh
    from repro_torch.dist.packed import RowShards
    n = len(devs)
    _, one, l1, _ = _train_steps(make_mesh(n, device=devs[0]), 3, devs[0])
    tr, many, ln, launches = _train_steps(make_mesh(n, devices=devs), 3,
                                          devs[0])
    table = many.params["embed_table"]
    assert isinstance(table, RowShards) and table.base is None
    for leaf in _train_leaves(many)[:4]:
        assert [s.device for s in leaf.shards] == devs
    assert launches == [(n, n)] * 3
    assert ln == l1
    for a, b in zip(_train_leaves(one), _train_leaves(many)):
        assert torch.equal(_bits(a), _bits(b))


def test_train_checkpoint_over_devices_restores_onto_fewer_cards(devs,
                                                                 tmp_path):
    """A state placed over n cards, saved after two steps, writes the
    arrays the one-card mesh's save writes; restored onto two cards, its
    next step equals the n-card state's next step bit for bit."""
    import numpy as np

    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.dist import make_mesh
    n = len(devs)
    tr, many, _, _ = _train_steps(make_mesh(n, devices=devs), 2, devs[0])
    _, one, _, _ = _train_steps(make_mesh(n, device=devs[0]), 2, devs[0])
    for label, st in (("many", many), ("one", one)):
        CheckpointManager(str(tmp_path / label)).save(2, st)
    files = [np.load(tmp_path / label / f"step_{2:010d}" / "host_0.npz")
             for label in ("many", "one")]
    assert sorted(files[0].files) == sorted(files[1].files)
    for k in files[0].files:
        assert files[0][k].tobytes() == files[1][k].tobytes(), k
    batch = tr.batch_fn(2)
    want, wm = tr.step(many, batch)
    two = setup.build_recsys_training(
        configs.get("dlrm-rm2"), batch=256, device=devs[0], model="smoke",
        mesh=make_mesh(2, devices=devs[:2]))
    restored, step = CheckpointManager(str(tmp_path / "many")).restore(
        two.state)
    assert step == 2
    assert [s.device for s in restored.params["embed_table"].shards] == (
        devs[:2])
    got, gm = two.step(restored, batch)
    assert float(gm["loss"]) == float(wm["loss"])
    for a, b in zip(_train_leaves(want), _train_leaves(got)):
        assert torch.equal(_bits(a), _bits(b))


def test_hashed_train_over_devices_as_the_one_device_mesh(devs):
    """The hashed step (``make_compressed_train_step(hashed_cfg=,
    mesh=)``): the pool whole on the first card, each shard's window
    copied to its card for the plan entry, its ``bag_grad`` rows copied
    back into the one pool gradient; three steps equal to the one-card
    mesh's bit for bit (pool, its accumulator, priority, access EMA,
    loss), the plan entry once a shard a step."""
    from repro_torch.dist import make_mesh
    from repro_torch.models import embedding as E
    from repro_torch.models import recsys as R
    from repro_torch.optim import optimizers as opt
    from repro_torch.store import hashed as H
    from repro_torch.train.steps import make_compressed_train_step
    cards = (50, 80, 30, 120)
    dim, n = 16, len(devs)
    vocab = sum(cards)
    hcfg = H.HashedConfig(vocab=vocab, dim=dim, chunk_dim=8, num_hashes=4,
                          num_slots=H.plan_pool_slots(vocab, dim, 8, 4.0))
    model = R.make_dlrm(R.DLRMConfig(cardinalities=cards, embed_dim=dim,
                                     num_dense=4, bot_mlp=(32, dim),
                                     top_mlp=(64, 1)))
    g = torch.Generator(device=devs[0])
    g.manual_seed(5)
    batches = [{"indices": torch.stack([torch.randint(
        0, c, (128,), generator=g, device=devs[0]) for c in cards], 1),
        "dense": torch.randn((128, 4), generator=g, device=devs[0]),
        "labels": torch.randint(0, 2, (128,), generator=g,
                                device=devs[0]).float()} for _ in range(3)]

    def run(mesh):
        step = make_compressed_train_step(
            model.loss_from_emb, lambda b: E.globalize(b["indices"],
                                                       model.spec),
            lambda b: b["labels"], "embed_table", 0.2, len(cards),
            hashed_cfg=hcfg, dense_optimizer=opt.adam(0.05), mesh=mesh)
        gen = torch.Generator(device=devs[0])
        gen.manual_seed(0)
        params = dict(model.init(gen, devs[0]))
        params["embed_table"] = H.init_hashed(hcfg, seed=0,
                                              device=devs[0]).pool
        st, out = step.init_state(params), []
        for b in batches:
            hg_kernel.reset_launches()
            st, m = step(st, b)
            out.append((float(m["loss"]), hg_kernel.total_launches()))
        return st, out

    one, o1 = run(make_mesh(n, device=devs[0]))
    many, on = run(make_mesh(n, devices=devs))
    assert on == o1 and all(k == n for _, k in on)
    for a, b in zip(_train_leaves(one), _train_leaves(many)):
        assert torch.equal(_bits(a), _bits(b))


def test_shard_packed_over_devices_copies_every_window(devs):
    """Across cards every shard's payloads and scales are copies of its
    own window, shard 0's on the store's card too: no shard's storage is
    larger than its window, so no card keeps the whole store alive once
    the caller drops it; on one card they stay views of the store."""
    from repro_torch.dist import make_mesh
    from repro_torch.dist import packed as dp
    store, cfg, _ = _mesh_store(devs[0], 13)
    packed = tps.pack(store, cfg)
    whole = {leaf.untyped_storage().data_ptr() for leaf in packed}
    multi = dp.shard_packed(packed, make_mesh(len(devs), devices=devs))
    assert multi.base is None
    for sh, d in zip(multi.shards, devs):
        for leaf in list(sh)[:5]:
            assert leaf.device == d
            assert leaf.untyped_storage().nbytes() == (
                leaf.numel() * leaf.element_size())
            assert leaf.untyped_storage().data_ptr() not in whole
    one = dp.shard_packed(packed, make_mesh(len(devs), device=devs[0]))
    assert one.base is packed
    assert all(torch.equal(_bytes(a), _bytes(b))
               for a, b in zip(dp.unshard_packed(multi), packed))


@pytest.mark.parametrize("backend", ["packed", "hashed"])
def test_pipeline_over_devices_as_the_one_device_mesh(devs, tmp_path,
                                                      backend):
    """``launch.pipeline --device cuda:0,...,cuda:n-1 --mesh n`` (smoke
    size, ``--fast``): every verify flag true; the losses, the gradcheck's
    error, the tier rows, the bytes, the eval losses and AUCs, the
    re-tiers, the hit rate, the final store's digest and every stage's
    launches equal to ``--mesh n`` on the first card's; the fp32 eval one
    float32 ``dequant_bag`` a shard a batch; a peak reported a card."""
    import contextlib
    import io

    from repro_torch.launch import pipeline
    n = len(devs)
    recs = {}
    for label, device in (("one", str(devs[0])),
                          ("many", ",".join(str(d) for d in devs))):
        with contextlib.redirect_stdout(io.StringIO()):
            recs[label] = pipeline.main([
                "--model", "smoke", "--fast", "--mesh", str(n), "--device",
                device, "--store-backend", backend, "--ckpt-dir",
                str(tmp_path / label)])
        torch.cuda.empty_cache()
    one, many = recs["one"], recs["many"]
    assert pipeline.verify_failures(many) == []
    for k in ("train_losses", "finetune_losses", "gradcheck_max_abs_err",
              "tier_rows_int8", "tier_rows_half", "tier_rows_fp32",
              "bytes_packed", "eval_loss_fp32", "eval_loss_packed",
              "eval_auc_fp32", "eval_auc_packed", "retiers",
              "cache_hit_rate", "final_pack_digest", "kernel_launches"):
        assert many[k] == one[k], k
    assert many["devices"] == [str(d) for d in devs]
    assert one["devices"] == [str(devs[0])] * n
    assert len(many["device_peak_bytes_each"]) == n
    assert all(p > 0 for p in many["stage_peak_bytes_each"])
    fast = pipeline.fast_config()
    kl = many["kernel_launches"]["eval"]["dequant_bag"]
    assert kl == n * fast.eval_batches * (2 if backend == "packed" else 1)
