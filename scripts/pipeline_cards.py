"""Run the SHARK pipeline (``repro_torch.launch.pipeline``) over the four
cards of one host, against the pipeline on one card.

    python3 scripts/pipeline_cards.py [--out chiprun_out/pipeline_cards.json]
                                      [--ckpt-root DIR]

Needs four CUDA devices with 80 GB each.  It prints the cards' name and
power limit (``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader``) and the free disk under the checkpoint root,
then runs the pipeline CLI in process (``pipeline.main``) on dlrm-rm2 at
its published widths, ``--model full --batch 65536 --steps 40``:

  (a) 124,185,088 rows (``--max-ind-range 24000000``, the one-card cap)
      on one card (``--device cuda:0``), then over four (``--device
      cuda:0,cuda:1,cuda:2,cuda:3 --mesh 4``): the record's integer
      fields, the losses, the gradcheck's error, the eval losses and
      AUCs, the tier rows, the bytes, ``retiers``, ``cache_hit_rate`` and
      the final pack's 64-bit digest (``final_pack_digest``) equal;
  (b) all 204,185,088 rows over four cards, packed then hashed: every
      ``verify_*`` true and ``reduced == []``.  A run writes a train
      checkpoint and a store checkpoint, whose bytes a row (a) measured
      (the pack's with 15% to spare; the hashed pool's ~7 a row); when
      the disk under the checkpoint root cannot hold both, the run takes
      the largest ``--max-ind-range`` (a million rows a step) whose
      checkpoints fit, and its record lists the cut in ``reduced``.

The checkpoint root (``--ckpt-root``; default the one of the temporary
directory and the repo's ignored ``build/`` with more free space) holds
one run's directory at a time: each is removed before the next run.
For each run it prints one JSON line: the stage seconds, each card's peak
during the set-up and during the stages, the checkpoints' bytes and write
seconds, the launches by stage and the wall time.  The last line is one
JSON object; ``--out`` writes it to a file too.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CAP = 24_000_000               # launch/pipeline.py's FULL_MAX_IND_RANGE
COMMON = ["--model", "full", "--batch", "65536", "--steps", "40"]
FOUR = ["--device", "cuda:0,cuda:1,cuda:2,cuda:3", "--mesh", "4"]
# the hashed store's checkpoint bytes a row: the pool at ratio 100 and
# the priority; the packed one's and the train state's come from (a)
HASHED_BYTES_A_ROW = 7
PACK_SPARE = 1.15
DISK_MARGIN = 2 << 30
# (a): equal between one card and four
EQUAL = ("train_steps", "batch", "rows", "fields_total", "fields_pruned",
         "tier_rows_int8", "tier_rows_half", "tier_rows_fp32", "bytes_fp32",
         "bytes_packed", "serve_requests", "serve_batch", "retiers",
         "final_pack_digest", "train_losses", "finetune_losses",
         "train_loss_first", "train_loss_last", "gradcheck_max_abs_err",
         "kept_memory_fraction", "compression_ratio", "eval_loss_fp32",
         "eval_loss_packed", "eval_auc_fp32", "eval_auc_packed",
         "cache_hit_rate", "reduced")
VERIFY = ("verify_pack_bit_identical", "verify_serve_bit_identical",
          "verify_grad_fp32_tolerance", "verify_accum_checkpointed")


def rows_at(cap: int | None) -> int:
    """dlrm-rm2's table rows with every field capped at ``cap``."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models.recsys import make_dlrm
    cfg = configs.get("dlrm-rm2").cfg
    if cap is not None:
        cfg = dataclasses.replace(cfg, cardinalities=tuple(
            min(int(c), cap) for c in cfg.cardinalities))
    return int(make_dlrm(cfg).spec.total_rows)


def fitting_cap(free: int, bytes_a_row: float) -> int | None:
    """None when all rows' two checkpoints (``bytes_a_row`` together) fit
    in ``free`` bytes, else the largest cap (a million rows a step) whose
    do."""
    def need(cap):
        return rows_at(cap) * bytes_a_row + DISK_MARGIN
    if need(None) <= free:
        return None
    cap = 40_000_000
    while cap > 1_000_000 and need(cap) > free:
        cap -= 1_000_000
    return cap


def ckpt_root(arg: str | None) -> Path:
    if arg:
        return Path(arg)
    candidates = [Path(tempfile.gettempdir()), ROOT / "build"]
    for c in candidates:
        c.mkdir(parents=True, exist_ok=True)
    return max(candidates, key=lambda c: shutil.disk_usage(c).free)


def run(torch, label: str, argv: list, root: Path) -> tuple[dict, dict]:
    """One pipeline CLI run, its checkpoints under ``root/label`` (removed
    after); the record and a summary line."""
    from repro_torch.launch import pipeline
    ckpt = root / f"pipeline_cards_{label}"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rec = pipeline.main([*COMMON, *argv, "--ckpt-dir", str(ckpt)])
    finally:
        sys.stdout.write(out.getvalue())
        shutil.rmtree(ckpt, ignore_errors=True)
        torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    writes = rec["checkpoints"]["train"] + rec["checkpoints"]["pack"]
    summary = {
        "label": label, "argv": argv, "wall_s": wall, "rows": rec["rows"],
        "reduced": rec["reduced"], "devices": rec["devices"],
        "store_backend": rec["store_backend"],
        "stage_seconds": rec["stage_seconds"],
        "fit_s": rec.get("fit_s"), "fit_chunks": rec.get("fit_chunks"),
        "setup_peak_bytes_each": rec["setup_peak_bytes_each"],
        "stage_peak_bytes_each": rec["stage_peak_bytes_each"],
        "checkpoints": [dict(w, write_gb_per_s=w["bytes"] / w["write_s"]
                             / 1e9) for w in writes],
        "kernel_launches": rec["kernel_launches"],
        "serve_p50_us": rec["serve_p50_us"],
        "serve_p99_us": rec["serve_p99_us"],
        "compression_ratio": rec["compression_ratio"],
        "eval_auc_fp32": rec["eval_auc_fp32"],
        "eval_auc_packed": rec["eval_auc_packed"],
        "verify": {k: rec[k] for k in VERIFY},
        "final_pack_digest": rec["final_pack_digest"]}
    print(json.dumps({"pipeline_cards": summary}), flush=True)
    return rec, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--ckpt-root", default=None,
                    help="where each run's checkpoints go (one run's at a "
                         "time)")
    args = ap.parse_args(argv)
    import torch
    if torch.cuda.device_count() < 4:
        print("pipeline_cards: needs four CUDA devices", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    root = ckpt_root(args.ckpt_root)
    free = shutil.disk_usage(root).free
    disk = {"ckpt_root": str(root), "free_bytes": free,
            "tmp_free_bytes": shutil.disk_usage(tempfile.gettempdir()).free,
            "build_free_bytes": shutil.disk_usage(ROOT / "build").free}
    print(json.dumps({"disk": disk}), flush=True)
    rec = {"device": smi.splitlines(), "disk": disk, "runs": {}}

    # (a) the one-card cap on one card, then over four
    one, rec["runs"]["capped_one_card"] = run(
        torch, "capped_one_card",
        ["--device", "cuda:0", "--max-ind-range", str(CAP)], root)
    four, rec["runs"]["capped_four_cards"] = run(
        torch, "capped_four_cards", [*FOUR, "--max-ind-range", str(CAP)],
        root)
    differ = {k: (four[k], one[k]) for k in EQUAL if four[k] != one[k]}
    if differ or one["rows"] != rows_at(CAP):
        raise SystemExit(f"four cards at {CAP:,} a field != one card: "
                         f"{differ}")
    rec["capped_equal_keys"] = list(EQUAL)

    # (b) every row over four cards, packed then hashed
    def ckpt_bytes(kind):
        return sum(w["bytes"] for w in one["checkpoints"][kind]) / one["rows"]
    train_a_row = ckpt_bytes("train")
    store_a_row = {"packed": PACK_SPARE * ckpt_bytes("pack"),
                   "hashed": HASHED_BYTES_A_ROW}
    rec["ckpt_bytes_a_row"] = {"train": train_a_row, **store_a_row}
    for backend in ("packed", "hashed"):
        cap = fitting_cap(shutil.disk_usage(root).free,
                          train_a_row + store_a_row[backend])
        extra = [] if cap is None else ["--max-ind-range", str(cap)]
        full, rec["runs"][f"full_four_cards_{backend}"] = run(
            torch, f"full_four_cards_{backend}",
            [*FOUR, "--store-backend", backend, *extra], root)
        failed = [k for k in VERIFY if not full[k]]
        if failed or (cap is None and (full["reduced"]
                                       or full["rows"] != rows_at(None))):
            raise SystemExit(f"all rows over four cards ({backend}): "
                             f"verify {failed}, reduced {full['reduced']}")
        if not all(math.isfinite(x) for x in full["train_losses"]):
            raise SystemExit(f"non-finite loss ({backend})")
    line = json.dumps(rec)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
