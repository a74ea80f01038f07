"""``repro_torch.dist.collectives`` and ``optim.grad_compress`` against the
reference's ``repro.dist.collectives`` and ``repro.optim.grad_compress``.

The reference's two multi-device functions run in ONE subprocess on 4
forced host devices (the device count must be set before JAX starts, as
``tests/test_sharding_hlo.py`` does): ``split_kv_decode_attention`` over a
4-device mesh, and ``error_feedback_allreduce`` inside a jitted
``shard_map`` for 3 steps carrying the residual.  The inputs come from a
numpy seed.  Tolerances: split-KV within 2e-5 (the reference test's) of
the reference and of the full softmax; ``compress_int8`` /
``decompress_int8`` and ``error_feedback_allreduce`` bit-equal (0).
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads

from repro.optim.grad_compress import compress_int8 as r_compress
from repro.optim.grad_compress import decompress_int8 as r_decompress
from repro_torch.dist import make_mesh
from repro_torch.dist.collectives import (shard_sequence,
                                          split_kv_decode_attention)
from repro_torch.launch import op_analysis
from repro_torch.optim import (compress_int8, decompress_int8,
                               error_feedback_allreduce)

ROOT = Path(__file__).resolve().parents[1]
B, S, H, D = 2, 32, 4, 16
CACHE_LEN = 19
W, N, STEPS = 4, 1000, 3

_REF = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.dist.collectives import split_kv_decode_attention
from repro.optim.grad_compress import error_feedback_allreduce
d = dict(np.load(sys.argv[1]))
mesh = jax.make_mesh((4,), ("model",))
out = split_kv_decode_attention(mesh, d["q"], d["k"], d["v"],
                                np.int32(d["cache_len"]), float(d["scale"]))
def body(g, r):
    m, nr = error_feedback_allreduce(g[0], r[0], "model")
    return m[None], nr[None]
ef = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("model"), P("model")),
                       out_specs=(P("model"), P("model")), check_rep=False))
r = d["r0"]
means, res = [], []
for t in range(d["grads"].shape[0]):
    m, r = ef(d["grads"][t], r)
    means.append(np.asarray(m)); res.append(np.asarray(r))
np.savez(sys.argv[2], split_kv=np.asarray(out), means=np.stack(means),
         residuals=np.stack(res))
print("REF_OK")
"""


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    f32 = np.float32
    return {"q": rng.standard_normal((B, H, D)).astype(f32),
            "k": rng.standard_normal((B, S, H, D)).astype(f32),
            "v": rng.standard_normal((B, S, H, D)).astype(f32),
            "cache_len": np.int32(CACHE_LEN), "scale": f32(D ** -0.5),
            "grads": (rng.standard_normal((STEPS, W, N)) * 0.01).astype(f32),
            "r0": np.zeros((W, N), f32)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    inp = _inputs()
    np.savez(tmp / "in.npz", **inp)
    env = torch_threads.subprocess_env()
    env["PYTHONPATH"] = "src"
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", _REF, str(tmp / "in.npz"),
                        str(tmp / "out.npz")], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=300)
    assert "REF_OK" in r.stdout, r.stderr[-3000:]
    return inp, dict(np.load(tmp / "out.npz"))


def _full_softmax(q, k, v, cache_len, scale):
    sc = np.einsum("bhd,bkhd->bhk", q.astype(np.float64),
                   k.astype(np.float64)) * scale
    sc = np.where((np.arange(k.shape[1]) <= cache_len)[None, None], sc,
                  -1e30)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhk,bkhd->bhd", p, v.astype(np.float64))


def test_split_kv_matches_the_reference_on_4_devices(ref):
    inp, out = ref
    mesh = make_mesh(4, device="cpu")
    got = split_kv_decode_attention(
        mesh, torch.from_numpy(inp["q"]), torch.from_numpy(inp["k"]),
        torch.from_numpy(inp["v"]), CACHE_LEN, float(inp["scale"]))
    np.testing.assert_allclose(got.numpy(), out["split_kv"], rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("cache_len", [0, 19, 31])
def test_split_kv_matches_the_full_softmax(n, cache_len):
    inp = _inputs()
    mesh = make_mesh(n, device="cpu")
    got = split_kv_decode_attention(
        mesh, torch.from_numpy(inp["q"]), torch.from_numpy(inp["k"]),
        torch.from_numpy(inp["v"]), cache_len, float(inp["scale"]))
    assert got.dtype == torch.float32 and got.shape == (B, H, D)
    np.testing.assert_allclose(
        got.numpy(), _full_softmax(inp["q"], inp["k"], inp["v"], cache_len,
                                   float(inp["scale"])),
        rtol=2e-5, atol=2e-5)


def test_split_kv_takes_placed_shards_and_refuses_uneven_caches():
    inp = _inputs()
    mesh = make_mesh(4, device="cpu")
    k, v = torch.from_numpy(inp["k"]), torch.from_numpy(inp["v"])
    q = torch.from_numpy(inp["q"])
    whole = split_kv_decode_attention(mesh, q, k, v, CACHE_LEN, 0.25)
    shards = split_kv_decode_attention(mesh, q, shard_sequence(mesh, k),
                                       shard_sequence(mesh, v), CACHE_LEN,
                                       0.25)
    assert torch.equal(whole, shards)
    assert shard_sequence(mesh, k)[1].data_ptr() == k[:, 8:].data_ptr()
    with pytest.raises(ValueError, match="not divisible"):
        split_kv_decode_attention(make_mesh(3, device="cpu"), q, k, v, 5,
                                  0.25)


def test_split_kv_reports_its_all_reduces():
    """Under the dry run's counter the combine reports a pmax and two
    psums (result bytes on each of the n shards)."""
    inp = _inputs()
    mesh = make_mesh(4, device="cpu")
    with op_analysis.OpCounter() as c:
        split_kv_decode_attention(
            mesh, torch.from_numpy(inp["q"]), torch.from_numpy(inp["k"]),
            torch.from_numpy(inp["v"]), CACHE_LEN, 0.25)
    assert c.stats.collective == {"all-reduce": 4 * 4 * (B * H * 2
                                                         + B * H * D)}


@pytest.mark.parametrize("shape", [(1000,), (256,), (4097,), (3, 5, 7)])
def test_compress_int8_bit_equal_to_the_reference(shape):
    x = (np.random.default_rng(1).standard_normal(shape) * 3.0
         ).astype(np.float32)
    q, scale, pad = compress_int8(torch.from_numpy(x))
    rq_, rs, rpad = r_compress(jnp.asarray(x))
    assert pad == rpad
    assert q.dtype == torch.int8 and scale.shape == (q.shape[0], 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq_))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(rs))
    y = decompress_int8(q, scale, pad, shape)
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(r_decompress(rq_, rs, rpad, shape)))


def test_compress_roundtrip_error_bounded():
    x = torch.from_numpy((np.random.default_rng(0).standard_normal(1000)
                          * 3.0).astype(np.float32))
    q, scale, pad = compress_int8(x)
    y = decompress_int8(q, scale, pad, x.shape)
    assert float((y - x).abs().max()) <= float(scale.max()) * 0.51 + 1e-6


def test_error_feedback_allreduce_bit_equal_to_the_reference(ref):
    """Three steps at W = 4, the residual carried: every shard's mean and
    new residual equal the jitted reference's bit for bit."""
    inp, out = ref
    mesh = make_mesh(W, device="cpu")
    res = [torch.from_numpy(r) for r in inp["r0"]]
    for t in range(STEPS):
        grads = [torch.from_numpy(g) for g in inp["grads"][t]]
        means, res = error_feedback_allreduce(grads, res, mesh)
        for i in range(W):
            np.testing.assert_array_equal(means[i].numpy(),
                                          out["means"][t, i])
            np.testing.assert_array_equal(res[i].numpy(),
                                          out["residuals"][t, i])


def test_error_feedback_allreduce_reports_its_all_gather():
    mesh = make_mesh(W, device="cpu")
    g = [torch.ones(N) * i for i in range(W)]
    with op_analysis.OpCounter() as c:
        means, _ = error_feedback_allreduce(g, [torch.zeros(N)] * W, mesh)
    blocks = -(-N // 256)
    assert c.stats.collective == {"all-gather": W * W * blocks * (256 + 4)}
    assert means[0] is means[3]        # one device: one mean, shared
    torch.testing.assert_close(means[0], torch.full((N,), 1.5),
                               rtol=1e-2, atol=0)


def test_error_feedback_reduces_bias():
    """The reference's ``tests/test_optim.py`` case on the port: with error
    feedback, the accumulated compressed sum tracks the true sum much
    better than without."""
    rng = np.random.default_rng(0)
    true_sum = np.zeros(512, np.float32)
    fed_sum = np.zeros(512, np.float32)
    plain_sum = np.zeros(512, np.float32)
    residual = torch.zeros(512)
    for _ in range(50):
        g = torch.from_numpy(rng.standard_normal(512).astype(np.float32)
                             * 0.01)
        true_sum += g.numpy()
        corrected = g + residual
        q, s, pad = compress_int8(corrected)
        deq = decompress_int8(q, s, pad, g.shape)
        residual = corrected - deq
        fed_sum += deq.numpy()
        q2, s2, pad2 = compress_int8(g)
        plain_sum += decompress_int8(q2, s2, pad2, g.shape).numpy()
    err_fed = np.abs(fed_sum - true_sum).mean()
    err_plain = np.abs(plain_sum - true_sum).mean()
    assert err_fed <= err_plain * 1.05
    assert err_fed < 0.02


def test_error_feedback_refuses_a_wrong_shard_count():
    mesh = make_mesh(W, device="cpu")
    with pytest.raises(ValueError, match="for a mesh of 4"):
        error_feedback_allreduce([torch.zeros(8)] * 3, [torch.zeros(8)] * 3,
                                 mesh)
