"""Time the SPMD layer's two collectives over the cards of one host against
the same mesh on one card.

    python3 scripts/spmd_cards.py

For a mesh of N shards (N = the CUDA devices present, at least 2; at most
4) it runs, first on ``make_mesh(N)`` (every shard on card 0) and then on
``make_mesh(N, devices=cards)`` (shard i on card i):

  * ``optim.error_feedback_allreduce``: one seeded fp32 gradient a shard
    the size of smollm-135m's parameter vector (``param_count``,
    134,515,008), ``STEPS`` steps carrying the residual; each step timed
    on the host around a synchronise of every card (a step on several
    cards spans them all);
  * ``dist.collectives.split_kv_decode_attention`` at qwen3-8b's decode
    width (batch 4, 32 heads, head dim 128, 32,768 fp32 slots, position
    16,384), the cache's shards placed on their cards before the clock
    starts; 5 calls timed the same way.

The two meshes' means and residuals must be equal bit for bit, and the
split-KV outputs within 2e-5.  Prints the card's name and power limit,
then one JSON line: each mesh's step and call ms, the bytes each step
copies between cards (every shard's int8 payload and scales to every
other card), and the ratio of the cross-card step to the one-card step.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


STEPS = 3        # exchange steps, as chip_smoke.py's SPMD_STEPS


def _sync_all(torch, devices) -> None:
    for d in devices:
        torch.cuda.synchronize(d)


def exchange(torch, mesh, n: int, steps: int, devices) -> tuple:
    """(step ms, final means on the CPU, final residuals on the CPU)."""
    from repro_torch.optim import error_feedback_allreduce
    gen = torch.Generator(device=devices[0])
    gen.manual_seed(22)
    res = [torch.zeros(n, device=mesh.devices[i]) for i in range(mesh.size)]
    ms = []
    for _ in range(steps):
        grads = [(torch.randn(n, generator=gen, device=devices[0]) * 1e-2
                  ).to(mesh.devices[i]) for i in range(mesh.size)]
        _sync_all(torch, devices)
        t0 = time.perf_counter()
        means, res = error_feedback_allreduce(grads, res, mesh)
        _sync_all(torch, devices)
        ms.append((time.perf_counter() - t0) * 1e3)
        del grads
    return ms, [m.cpu() for m in means], [r.cpu() for r in res]


def split_kv(torch, mesh, devices) -> tuple:
    from repro_torch.dist.collectives import (shard_sequence,
                                              split_kv_decode_attention)
    gen = torch.Generator(device=devices[0])
    gen.manual_seed(23)
    b, h, d, s = 4, 32, 128, 32768
    q = torch.randn((b, h, d), generator=gen, device=devices[0])
    k = torch.randn((b, s, h, d), generator=gen, device=devices[0])
    v = torch.randn((b, s, h, d), generator=gen, device=devices[0])
    ks, vs = shard_sequence(mesh, k), shard_sequence(mesh, v)
    del k, v
    out = split_kv_decode_attention(mesh, q, ks, vs, s // 2, d ** -0.5)
    ms = []
    for _ in range(5):
        _sync_all(torch, devices)
        t0 = time.perf_counter()
        split_kv_decode_attention(mesh, q, ks, vs, s // 2, d ** -0.5)
        _sync_all(torch, devices)
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, out.cpu()


def main() -> int:
    import torch
    if torch.cuda.device_count() < 2:
        print("spmd_cards: needs two or more CUDA devices", file=sys.stderr)
        return 1
    from repro_torch import configs
    from repro_torch.dist import make_mesh
    from repro_torch.models import transformer as T
    elements = T.param_count(configs.get("smollm-135m").lm_cfg)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    cards = [torch.device("cuda", i)
             for i in range(min(4, torch.cuda.device_count()))]
    n = len(cards)
    rec = {"cards": n, "elements": elements, "device": smi.splitlines()}
    meshes = {"one_card": (make_mesh(n, device=cards[0]), cards[:1]),
              "over_cards": (make_mesh(n, devices=cards), cards)}
    results = {}
    for label, (mesh, devs) in meshes.items():
        step_ms, means, res = exchange(torch, mesh, elements, STEPS,
                                       cards)
        kv_ms, out = split_kv(torch, mesh, cards)
        results[label] = (means, res, out)
        rec[label] = {"exchange_step_ms": step_ms, "split_kv_ms": kv_ms}
        torch.cuda.empty_cache()
    (m1, r1, o1), (m2, r2, o2) = results["one_card"], results["over_cards"]
    if not all(torch.equal(a, b) for a, b in zip(m1 + r1, m2 + r2)):
        raise SystemExit("the exchange over the cards != on one card")
    if float((o1 - o2).abs().max()) > 2e-5:
        raise SystemExit("split-KV over the cards != on one card")
    blocks = -(-elements // 256)
    rec["copied_bytes_per_step"] = n * (n - 1) * blocks * (256 + 4)
    rec["exchange_ratio"] = (min(rec["over_cards"]["exchange_step_ms"])
                             / min(rec["one_card"]["exchange_step_ms"]))
    rec["split_kv_ratio"] = (min(rec["over_cards"]["split_kv_ms"])
                             / min(rec["one_card"]["split_kv_ms"]))
    print(json.dumps({"spmd_cards": rec}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
