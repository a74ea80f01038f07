"""Train dlrm-rm2 at its published widths with the train state placed over
the cards of one host, against the step on one card.

    python3 scripts/train_cards.py [--out chiprun_out/train_cards.json]

Needs four CUDA devices with 80 GB each.  It prints the cards' name and
power limit (``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader``), then drives ``setup.step`` directly (as
``chip_smoke.py::train_full`` does; no checkpoint: one over all rows is
~55 GB) at batch 65,536:

  (a) 124,185,088 rows (every field capped at 24,000,000, the train CLI's
      one-card cap), 3 steps on one card (no mesh), then on four cards
      (``make_mesh(4, devices=cards)``, the state placed a row shard a
      card): the state's 64-bit digests (table, adagrad accumulator,
      priority, access EMA, every bit) and the losses equal after each
      step;
  (b) all 204,185,088 rows on four cards, 5 steps: losses finite;
  (c) the serve CLI, ``--arch dlrm-rm2 --model full --mesh 4 --device
      cuda:0,cuda:1,cuda:2,cuda:3`` against ``--mesh 1``: the logits of 4
      requests of batch 512 bit-equal;
  (d) all rows on two cards, 3 steps: digests and losses equal to (b)'s
      first 3 (last: its set-up holds the whole table and its half on the
      first card, ~81 GB).

Each run reports its step ms (host clock around a synchronise of every
card), each card's peak (``max_memory_allocated``) during the set-up (the
whole state is made on the first card, then placed) and during the
steps, and, from CUDA events
recorded on every card at each of the step's stage marks, each card's
ms a stage (median over the steps after the first).  The last line is one
JSON object; ``--out`` writes it to a file too.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

BATCH = 65_536
CAP = 24_000_000           # launch/train.py's FULL_MAX_IND_RANGE
SERVE_REQUESTS = 4
SERVE_BATCH = 512


def _sync_all(torch, cards) -> None:
    for d in cards:
        torch.cuda.synchronize(d)


def _digest_rows(torch, t, row0: int) -> int:
    """``chip_smoke.py::digest`` of rows ``row0 ..`` of a leaf: each 32-bit
    word times a weight of its global row and column, summed mod 2^64 on
    the tensor's card."""
    rows = t.shape[0]
    words = t.reshape(rows, -1).view(torch.int32)
    colw = torch.arange(words.shape[1], device=t.device,
                        dtype=torch.int64) * 7919 + 1
    acc = torch.zeros((), dtype=torch.int64, device=t.device)
    for r0 in range(0, rows, 1 << 21):
        r1 = min(rows, r0 + (1 << 21))
        roww = torch.arange(row0 + r0, row0 + r1, device=t.device,
                            dtype=torch.int64) * 1000003 + 12345
        acc += ((words[r0:r1].to(torch.int64) * roww[:, None])
                * colw[None, :]).sum()
    return int(acc)


def digest(torch, leaf) -> int:
    """A leaf's digest, a placed leaf's shard by shard on its own card (the
    whole of one does not fit beside a card's shards): equal to the whole
    leaf's, the sum being taken mod 2^64."""
    from repro_torch.dist.packed import RowShards
    if not isinstance(leaf, RowShards):
        return _digest_rows(torch, leaf, 0)
    total = sum(_digest_rows(torch, s, f)
                for s, (f, _) in zip(leaf.shards, leaf.windows))
    return (total + 2 ** 63) % 2 ** 64 - 2 ** 63


def state_digests(torch, state) -> dict:
    return {"table": digest(torch, state.params["embed_table"]),
            "adagrad": digest(torch, state.opt[1]),
            "priority": digest(torch, state.priority),
            "access": digest(torch, state.accum.access)}


def train(torch, cards: list, n: int, cap: int | None, steps: int) -> dict:
    """dlrm-rm2 full widths over ``n`` of ``cards`` (no mesh at 1) for
    ``steps`` steps: losses, step ms, digests after each step, each card's
    peak and its ms a stage."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.dist import make_mesh
    from repro_torch.kernels.dequant_bag import kernel
    from repro_torch.train.setup import build_recsys_training
    used = cards[:n]
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    t0 = time.perf_counter()
    tr = build_recsys_training(
        configs.get("dlrm-rm2"), batch=BATCH, device=used[0], model="full",
        max_ind_range=cap,
        mesh=None if n == 1 else make_mesh(n, devices=used))
    batches = [tr.batch_fn(s) for s in range(steps)]
    _sync_all(torch, cards)
    setup_s = time.perf_counter() - t0
    # the set-up's peaks (the whole state made on the first card, then
    # placed), then the steps' own
    setup_peak = [torch.cuda.max_memory_allocated(d) for d in used]
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    state = tr.state
    losses, step_ms, digests, stages = [], [], [], []
    kernel.reset_launches()
    for b in batches:
        marks = []

        def mark(stage, marks=marks):
            evs = []
            for d in used:
                e = torch.cuda.Event(enable_timing=True)
                e.record(torch.cuda.current_stream(d))
                evs.append(e)
            marks.append((stage, evs))

        _sync_all(torch, cards)
        t = time.perf_counter()
        mark("start")
        state, m = tr.step(state, b, mark=mark)
        mark("end")
        _sync_all(torch, cards)
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(m["loss"]))
        stages.append([{name: a[i].elapsed_time(e[i])
                        for (_, a), (name, e) in zip(marks, marks[1:])}
                       for i in range(n)])
        digests.append(state_digests(torch, state))
    names = list(stages[-1][0])
    later = stages[1:] or stages
    rec = {"cards": n, "rows": tr.spec.total_rows, "reduced": tr.reduced,
           "setup_s": setup_s, "losses": losses, "step_ms": step_ms,
           "step_ms_p50": float(np.median(step_ms[1:] or step_ms)),
           "stage_ms_p50": [{k: float(np.median([st[i][k] for st in later]))
                             for k in names} for i in range(n)],
           "setup_peak_bytes": setup_peak,
           "peak_bytes": [torch.cuda.max_memory_allocated(d) for d in used],
           "launches": {"dequant_bag": kernel.launches["float32"],
                        "bag_grad": kernel.bag_grad_launches["float32"]},
           "digests": digests}
    if rec["launches"] != {"dequant_bag": n * steps, "bag_grad": n * steps}:
        raise SystemExit(f"{n} cards: launches {rec['launches']}, want "
                         f"{n} a step")
    del tr, state, batches
    torch.cuda.empty_cache()
    print(json.dumps({k: v for k, v in rec.items() if k != "digests"}),
          flush=True)
    return rec


def serve_logits(torch, argv: list) -> tuple:
    """The serve CLI's offline run in process: the logits of its first
    ``SERVE_REQUESTS`` requests on the CPU, and its record's timings."""
    from repro_torch.launch import serve
    served = serve.run(serve.parse_args(
        ["--arch", "dlrm-rm2", "--model", "full", "--batch",
         str(SERVE_BATCH), "--requests", str(SERVE_REQUESTS)] + argv))
    out = []
    with torch.inference_mode():
        for r in range(SERVE_REQUESTS):
            batch = {k: v.to("cuda:0")     # the first listed card
                     for k, v in served.make_request(r).items()}
            out.append(serve.serve_request(served.model, served.params,
                                           served.packed, batch).cpu())
    rec = served.record
    del served
    torch.cuda.empty_cache()
    return out, {k: rec[k] for k in ("mesh", "p50_us", "p99_us",
                                     "kernel_launches", "build_s")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if torch.cuda.device_count() < 4:
        print("train_cards: needs four CUDA devices", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    from repro_torch import resolve_device
    cards = [resolve_device(f"cuda:{i}") for i in range(4)]
    for d in cards:     # each card's allocator, before its stats are reset
        torch.zeros(1, device=d)
    rec = {"device": smi.splitlines(), "batch": BATCH}
    one = train(torch, cards, 1, CAP, 3)
    four = train(torch, cards, 4, CAP, 3)
    if one["digests"] != four["digests"] or one["losses"] != four["losses"]:
        raise SystemExit(f"four cards at {CAP:,} a field != one card: "
                         f"{four['digests']} / {one['digests']}")
    full4 = train(torch, cards, 4, None, 5)
    if full4["reduced"] or not all(math.isfinite(x)
                                   for x in full4["losses"]):
        raise SystemExit(f"all rows on four cards: reduced "
                         f"{full4['reduced']}, losses {full4['losses']}")
    l1, s1 = serve_logits(torch, ["--device", "cuda:0"])
    l4, s4 = serve_logits(torch, ["--device",
                                  "cuda:0,cuda:1,cuda:2,cuda:3",
                                  "--mesh", "4"])
    if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(l1, l4)):
        raise SystemExit("serve over four cards != mesh 1")
    rec["serve"] = {"mesh1": s1, "mesh4_cards": s4,
                    "bit_equal_requests": len(l4)}
    print(json.dumps({"serve": rec["serve"]}), flush=True)
    # last: its set-up holds the whole table and half of it on card 0
    full2 = train(torch, cards, 2, None, 3)
    if (full2["digests"] != full4["digests"][:3]
            or full2["losses"] != full4["losses"][:3]):
        raise SystemExit("all rows on two cards != on four cards")
    for label, r in (("capped_one_card", one), ("capped_four_cards", four),
                     ("full_four_cards", full4), ("full_two_cards", full2)):
        rec[label] = {k: v for k, v in r.items() if k != "digests"}
    rec["bit_equal"] = {"capped_four_vs_one": len(four["digests"]),
                        "full_two_vs_four": len(full2["digests"])}
    line = json.dumps(rec)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
