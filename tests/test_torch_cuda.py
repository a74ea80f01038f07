"""The port's CUDA kernels on the card: each against its plain version.

Marked ``cuda``; each test skips where there is no GPU (decided inside
the fixture, never at import).  Run on a machine with an H100 with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import pytest
import torch

from repro_torch.core import packed_store as tps
from repro_torch.core import qat_store as tqs
from repro_torch.core.tiers import TierConfig
from repro_torch.kernels.dequant_bag import kernel, ops, ref
from repro_torch.launch import serve

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
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


def test_strict_fp16_store_is_refused_on_card(dev):
    pri = torch.rand(64, device=dev) * 2e5
    cfg = tqs.FQuantConfig(tiers=TierConfig(5e4, 1.5e5), strict_fp16=True)
    with pytest.raises(ValueError, match="strict_fp16"):
        tps.build_chunked(lambda r0, r1: torch.zeros((r1 - r0, 8),
                                                     device=dev),
                          pri, 8, cfg, chunk_rows=32)


def test_serve_smoke_launches_the_kernel(dev):
    rec = serve.run(serve.parse_args(
        ["--model", "smoke", "--requests", "3", "--batch", "64"])).record
    assert rec["device"] == "cuda" and rec["kernel_launches"] == 9
