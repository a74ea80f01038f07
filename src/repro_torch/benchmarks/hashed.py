"""Hashed-store compression sweep: AUC and serving latency against the
pool ratio, as the ``bench_hash/v1`` record, on the card.

    python -m repro_torch.benchmarks.hashed [--fast] [--emit PATH] \\
        [--device cpu]

Port of ``benchmarks/hashed.py``.  The bench DLRM of ``common.make_setup``
(10 fields, 184,320 rows x 16, the reference's size) is trained end to
end at each target ratio by the compressed train step's ``hashed_cfg=``
branch (the pool is the trained parameter: ``hashed_gather``'s plan entry
forward, ``bag_grad`` into the pool backward), and once densely by the
same step on the fp32 table (``dequant_bag`` forward, ``bag_grad``
backward), the baseline.  Per ratio the record has:

  * the eval AUC of the virtual table materialised from the pool
    (``gather_rows_host``) against the dense baseline's (``auc_gap``);
  * the pool's bytes, and the combined SHARK-rowwise x hashing mode's
    (``quantize_pool``: an int8 pool with per-slot scales) bytes and AUC;
  * online serving through ``OnlineServer`` and ``serve_forward`` on the
    hashed backend: the percentiles (wall time on the device it ran on,
    each batch ending when its device work has) and the counters.

The pool's table learning rate runs hotter than the dense baseline's
(shared slots collect squared gradient from every colliding row); the
head's Adam is the same in both arms.  The steps run eagerly (the
reference jits its step).  Each arm starts from ``setup.params`` (or
``params=``), the hashed arms' pools from ``init_pool(hcfg)`` (default
``store.hashed.init_hashed``, a torch draw; the tests pass the
reference's).  ``tools/check_bench_schema.py`` holds the record to its
rules (bytes falling with the ratio, the int8 pool below the fp32 one,
percentiles in order, a sweep reaching 100x).  ``--emit PATH`` writes it;
nothing is written without it (the repository's ``BENCH_hash.json`` is
the JAX package's record).
"""

from __future__ import annotations

import argparse
import json
from typing import Callable

import torch

from repro_torch.benchmarks.common import (BenchSetup, device_batch,
                                           eval_auc, make_setup)
from repro_torch.benchmarks.qps import write_bench_json
from repro_torch.models import embedding as E
from repro_torch.optim import optimizers as opt_lib
from repro_torch.serve.loop import serve_forward
from repro_torch.serve.online import OnlineConfig, OnlineServer
from repro_torch.store import api as store_api
from repro_torch.store import hashed as H
from repro_torch.train.steps import make_compressed_train_step

BENCH_SCHEMA = "bench_hash/v1"

SWEEP_KEYS = ("qps", "steady_qps", "p50_us", "p95_us", "p99_us",
              "latency_p50", "latency_p95", "latency_p99",
              "p99_retier_attributed", "p99_while_retiering",
              "lookups", "hits", "cache_hit_rate", "retiers")

FULL_RATIOS = (1.0, 4.0, 20.0, 100.0, 1000.0)
FAST_RATIOS = (4.0, 100.0)


def _train(setup: BenchSetup, hcfg: H.HashedConfig | None, steps: int,
           table_lr: float, head_lr: float,
           init_pool: Callable[[H.HashedConfig], torch.Tensor] | None = None,
           audit: Callable | None = None):
    """One training arm (dense when ``hcfg`` is None) through the
    compressed step, from a copy of ``setup.params``; the final
    ``TrainState``.  ``audit(model, hcfg, params, batch)`` sees a hashed
    arm's initial params (the pool included) and first batch before its
    first step."""
    spec = setup.model.spec
    step = make_compressed_train_step(
        setup.model.loss_from_emb,
        lambda b: E.globalize(b["indices"], spec),
        lambda b: b["labels"], "embed_table", table_lr, spec.num_fields,
        hashed_cfg=hcfg, dense_optimizer=opt_lib.adam(head_lr),
        with_accum=False)
    params = opt_lib.tree_map(torch.clone, setup.params)
    if hcfg is not None:
        pool = (init_pool(hcfg) if init_pool is not None
                else H.init_hashed(hcfg, device=setup.device).pool)
        params["embed_table"] = pool.to(setup.device, torch.float32)
    state = step.init_state(params)
    for i in range(steps):
        batch = device_batch(setup.ds.batch(setup.batch_size, i),
                             setup.device)
        if i == 0 and hcfg is not None and audit is not None:
            audit(setup.model, hcfg, state.params, batch)
        state, _ = step(state, batch)
    return state


def _materialized_auc(setup: BenchSetup, state, hs: H.HashedStore,
                      hcfg: H.HashedConfig) -> float:
    """Eval AUC with the virtual table materialised from the pool."""
    spec = setup.model.spec
    mat = H.gather_rows_host(hs, hcfg, range(spec.total_rows))
    p = dict(state.params)
    p["embed_table"] = torch.from_numpy(mat).to(setup.device)
    return eval_auc(setup, p)


def run_hashed_sweep(ratios=FULL_RATIOS, train_steps=700, requests=96,
                     serve_batch=8, cache_rows=256, retier_every=32,
                     chunk_dim=8, num_hashes=4, table_lr=0.2, head_lr=0.05,
                     drift=4.0, a=1.2, eval_batches=16, seed=0, *,
                     params: dict | None = None,
                     init_pool: Callable | None = None,
                     audit: Callable | None = None,
                     device: str | torch.device | None = None) -> dict:
    """One ``bench_hash/v1`` record over the target compression ratios;
    ``audit`` as ``_train``'s."""
    setup = make_setup(seed=seed, params=params, device=device)
    setup.eval_batches = eval_batches
    spec = setup.model.spec
    bytes_fp32 = spec.total_rows * spec.dim * 4

    base = _train(setup, None, train_steps, head_lr, head_lr)
    auc_fp32 = eval_auc(setup, base.params)
    del base

    sweep = []
    for ratio in ratios:
        slots = H.plan_pool_slots(spec.total_rows, spec.dim, chunk_dim,
                                  float(ratio))
        hcfg = H.HashedConfig(vocab=spec.total_rows, dim=spec.dim,
                              chunk_dim=chunk_dim, num_slots=slots,
                              num_hashes=num_hashes)
        state = _train(setup, hcfg, train_steps, table_lr, head_lr,
                       init_pool, audit)
        pool = state.params["embed_table"]
        hs = H.HashedStore(pool=pool,
                           pool_scale=torch.ones((slots,),
                                                 dtype=torch.float32,
                                                 device=pool.device),
                           priority=state.priority)
        auc = _materialized_auc(setup, state, hs, hcfg)

        # SHARK-rowwise x hashing combined mode: int8 pool + scales
        q = H.quantize_pool(hs)
        auc_combined = _materialized_auc(setup, state, q, hcfg)

        backend = store_api.build("hashed", hs, hcfg)
        server = OnlineServer(
            backend=backend,
            online=OnlineConfig(cache_rows=cache_rows,
                                retier_every=retier_every))
        result = serve_forward(
            server, setup.model, spec, state.params,
            serve_batch=serve_batch, requests=requests, drift=drift,
            num_dense=setup.ds.cfg.num_dense, a=a, seed=seed)

        entry = {
            "ratio_target": float(ratio),
            "pool_slots": int(slots),
            "bytes": int(backend.nbytes()),
            "ratio_actual": round(bytes_fp32 / backend.nbytes(), 2),
            "bytes_combined": int(q.nbytes()),
            "auc": round(float(auc), 5),
            "auc_gap": round(float(auc_fp32 - auc), 5),
            "auc_combined": round(float(auc_combined), 5),
        }
        d = result.as_dict()
        entry.update({k: d[k] for k in SWEEP_KEYS})
        sweep.append(entry)
        del state, hs, q, backend, server

    return {"schema": BENCH_SCHEMA, "benchmark": "hashed_ratio_sweep",
            "vocab": int(spec.total_rows), "dim": int(spec.dim),
            "chunk_dim": int(chunk_dim), "num_hashes": int(num_hashes),
            "train_steps": int(train_steps),
            "table_lr": float(table_lr), "head_lr": float(head_lr),
            "requests": int(requests), "serve_batch": int(serve_batch),
            "cache_rows": int(cache_rows),
            "retier_every": int(retier_every), "drift": float(drift),
            "retier_async": False,
            "bytes_fp32": int(bytes_fp32),
            "auc_fp32": round(float(auc_fp32), 5),
            "device": setup.device.type,
            "device_name": (torch.cuda.get_device_name(setup.device)
                            if setup.device.type == "cuda" else "cpu"),
            "sweep": sweep}


def sweep_budgets(fast: bool) -> dict:
    """The reference's budgets (``--fast``: its reduced ones)."""
    return dict(ratios=FAST_RATIOS if fast else FULL_RATIOS,
                train_steps=120 if fast else 700,
                requests=32 if fast else 96,
                eval_batches=4 if fast else 16)


def run(fast: bool = False, device=None) -> list[dict]:
    """The runner's job: CSV rows from the sweep."""
    rec = run_hashed_sweep(**sweep_budgets(fast), device=device)
    return [{"metric": f"hash_ratio{e['ratio_target']:g}",
             "value": e["steady_qps"], "auc": e["auc"],
             "auc_gap": e["auc_gap"], "bytes": e["bytes"]}
            for e in rec["sweep"]]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="Hashed-store ratio sweep (bench_hash/v1).")
    ap.add_argument("--fast", action="store_true",
                    help="the reference's reduced budgets")
    ap.add_argument("--ratios", default=None, metavar="R[,R...]")
    ap.add_argument("--train-steps", type=int, default=None)
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--serve-batch", type=int, default=8)
    ap.add_argument("--emit", default=None, metavar="PATH",
                    help="write the bench_hash/v1 record here (nothing is "
                         "written without it)")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises when absent)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """The CLI: prints the record (and writes it with ``--emit``)."""
    args = parse_args(argv)
    budgets = sweep_budgets(args.fast)
    if args.ratios:
        budgets["ratios"] = tuple(float(x) for x in args.ratios.split(","))
    budgets["train_steps"] = args.train_steps or budgets["train_steps"]
    budgets["requests"] = args.requests or budgets["requests"]
    rec = run_hashed_sweep(serve_batch=args.serve_batch, device=args.device,
                           **budgets)
    print(json.dumps(rec))
    if args.emit:
        write_bench_json(rec, args.emit)
        print(f"wrote {args.emit}")
    return rec


if __name__ == "__main__":
    main()
