"""Where a hierarchical store's time goes at full width: build, a
micro-batch, one synchronous migration by piece, and one verify block.

    python3 scripts/hier_profile.py [--arch wide-deep] [--fraction 0.1]
        [--hbm-mb MB --host-mb MB] [--requests 64] [--profile 25]

Builds ``--arch``'s online store at its published widths (the serve
CLI's table, priorities and 50% thresholds), places it under the hot and
warm budgets (``--fraction`` of the fully packed bytes each, or MiB
given), the rest in cold shards of 1,048,576 rows under a temporary
directory, serves ``--requests`` drifting-zipf requests by 8 (no
re-tier), then runs one migration piece by piece, each piece timed to the
end of its device work: the plan, the hot and warm levels, the cold
level's build, its shards' write, their open, the commit.  Then one
``--verify-hier`` block (4,194,304 ids through the staging path against
the pack of their own rows), its host stage timed apart, and the
whole ``--verify-hier`` check by level (``HierStore.mismatch_pack``).
The serve runs with metrics on: the record has its spans' p50s.  With
``--profile N`` the migration and the verify block also run under
``cProfile``, whose N costliest functions by own time go to stderr.  The
last stdout line is a JSON record of the seconds.  Runs on the card
(``--device cpu`` for a smoke check at ``--model smoke``).
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import resource
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "..", "src"))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="wide-deep")
    ap.add_argument("--model", default="full", choices=("full", "smoke"))
    ap.add_argument("--fraction", type=float, default=0.1)
    ap.add_argument("--hbm-mb", type=float, default=None)
    ap.add_argument("--host-mb", type=float, default=None)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--rows-per-shard", type=int, default=1 << 20)
    ap.add_argument("--profile", type=int, default=0, metavar="N")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch import configs, obs, resolve_device, sync
    from repro_torch.core import packed_store as ps
    from repro_torch.core.qat_store import (CHUNK_ROWS, QATStore,
                                            current_tiers)
    from repro_torch.core.tiers import memory_bytes
    from repro_torch.launch import serve
    from repro_torch.serve.loop import serve_forward
    from repro_torch.serve.online import OnlineConfig, OnlineServer
    from repro_torch.store.budget import HOT, WARM
    from repro_torch.store.hier import HierConfig, hier_lookup
    from repro_torch.store.manifest import ColdShards, write_cold_shards

    dev = resolve_device(args.device)
    arch = configs.get(args.arch)
    model = arch.model if args.model == "full" else arch.smoke_model
    num_dense = (arch.num_dense if args.model == "full"
                 else arch.smoke_num_dense)
    spec = model.spec
    out = {"arch": args.arch, "model": args.model, "device": dev.type,
           "device_name": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu")}

    def timed(name, fn, *a, **kw):
        sync(dev)
        t0 = time.perf_counter()
        res = fn(*a, **kw)
        sync(dev)
        out[name] = time.perf_counter() - t0
        return res

    params, store, cfg = timed("table_s", serve.online_store, model, spec,
                               dev)
    total = memory_bytes(current_tiers(store, cfg), spec.dim)
    hbm = (args.hbm_mb * 2 ** 20 if args.hbm_mb is not None
           else args.fraction * total)
    host = (args.host_mb * 2 ** 20 if args.host_mb is not None
            else args.fraction * total)
    tmp = tempfile.TemporaryDirectory()
    hcfg = HierConfig(int(hbm), int(host), args.rows_per_shard,
                      os.path.join(tmp.name, "cold"))
    server = timed("build_s", OnlineServer, store, cfg,
                   OnlineConfig(cache_rows=256), hier=hcfg)
    hier = server.hier
    out.update(packed_bytes=int(total), levels=hier.counts(),
               level_bytes=hier.nbytes())
    obs.enable()
    res = timed("serve_s", serve_forward, server, model, spec, params,
                serve_batch=8, requests=args.requests, num_dense=num_dense)
    hists = obs.snapshot()["histograms"]
    out["span_p50_us"] = {k: hists[f"{k}_us"]["p50"] for k in (
        "serve.request", "serve.stage", "store.stage", "serve.synth",
        "serve.lookup", "serve.combine") if f"{k}_us" in hists}
    obs.disable()
    obs.get_registry().reset()
    out.update(p50_us=res.p50_us, p99_us=res.p99_us,
               miss_rate=res.stats["hier_miss_rate"])

    def migrate_by_piece():
        rp = timed("plan_s", hier.plan_retier, server.store, cfg)
        plan = rp.plan
        out["crossed"] = int(rp.crossed.sum())
        new_hot = timed("hot_level_s", hier.build_level, rp, cfg, HOT)
        new_warm = timed("warm_level_s", hier.build_level, rp, cfg, WARM)
        new_cold = hier.cold
        out["cold_changed"] = hier.cold_changed(rp)
        if plan.cold_ids.size and out["cold_changed"]:
            cold = timed("cold_level_s", hier.build_rows, plan.cold_ids, rp,
                         cfg)
            timed("cold_write_s", write_cold_shards, hcfg.store_dir, cold,
                  plan.cold_ids, hcfg.rows_per_shard)
            new_cold = timed("cold_open_s", ColdShards, hcfg.store_dir)
        moved = timed("commit_s", hier.commit_retier, rp, new_hot, new_warm,
                      new_cold)
        out.update(moved)

    def verify_block():
        n = min(CHUNK_ROWS, hier.vocab)
        ids = np.arange(n)
        timed("verify_stage_s", hier.stage, ids)
        got = timed("verify_lookup_s", hier_lookup, hier, ids)
        ref = timed("verify_ref_s", lambda: ps.lookup(ps.pack(QATStore(
            server.store.table[:n], server.store.priority[:n]), cfg),
            torch.arange(n, device=dev)))
        out["verify_block_rows"] = n
        out["verify_block_equal"] = bool(torch.equal(
            got.view(torch.int32), ref.view(torch.int32)))

    def verify_levels():
        out["verify_levels_equal"] = not bool(timed(
            "verify_levels_s", hier.mismatch_pack, server.store, cfg,
            ps.lookup_fused))

    for name, fn in (("migrate", migrate_by_piece),
                     ("verify", verify_block),
                     ("verify_levels", verify_levels)):
        prof = cProfile.Profile() if args.profile else None
        t0 = time.perf_counter()
        if prof:
            prof.enable()
        fn()
        if prof:
            prof.disable()
            buf = io.StringIO()
            pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(
                args.profile)
            print(f"== {name} ({args.arch})\n{buf.getvalue()}",
                  file=sys.stderr)
        out[f"{name}_s"] = time.perf_counter() - t0
    out["host_peak_rss_bytes"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss * 1024
    if dev.type == "cuda":
        out["device_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    tmp.cleanup()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
