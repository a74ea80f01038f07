"""LM training with F-Quantization on the token-embedding table.

Trains a small decoder-only transformer (the family of the LM configs)
on synthetic zipf token streams through the fault-tolerant loop
(checkpoint / restart, NaN guard), with Eq. 7 priorities accumulating on
the token rows, then prints the token table's tier report: the LM face
of the paper's technique (token frequency == row priority).

Port of ``examples/train_lm.py``.  Run:

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 120]
        [--resume-demo] [--device cpu]
"""

from __future__ import annotations

import argparse
import shutil
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.core.qat_store import FQuantConfig
from repro_torch.core.tiers import assign_tiers, plan_thresholds_for_ratio
from repro_torch.data.lm import LMConfig as DataConfig
from repro_torch.data.lm import LMSynth
from repro_torch.examples.common import compression_ratio
from repro_torch.models import transformer as T
from repro_torch.models.layers import count_params
from repro_torch.optim import adam
from repro_torch.train.loop import LoopConfig, run
from repro_torch.train.steps import FQuantHook, init_state, make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--resume-demo", action="store_true",
                    help="interrupt at 2/3 and resume from the checkpoint")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises when absent)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = T.LMConfig(name="lm-demo", n_layers=4, d_model=128, n_heads=8,
                     n_kv_heads=4, head_dim=16, d_ff=512, vocab=8192,
                     tie_embeddings=True, max_seq=128)
    data = LMSynth(DataConfig(vocab=8192, seq_len=128))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = T.init_params(gen, cfg, dev)
    n_params = count_params(params)
    print(f"transformer: {cfg.n_layers}L d{cfg.d_model} "
          f"{n_params / 1e6:.1f}M params, vocab {cfg.vocab}")

    optimizer = adam(3e-3)
    hook = FQuantHook(
        cfg=FQuantConfig(), table_path="embed",
        indices_fn=lambda b: b["tokens"],
        labels_fn=lambda b: torch.ones(b["tokens"].shape[0],
                                       dtype=torch.float32, device=dev))
    step = make_train_step(lambda p, b: T.lm_loss(p, cfg, b["tokens"]),
                           optimizer, hook)
    state = init_state(params, optimizer, hook)

    def batch_fn(i):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in data.batch(8, i).items()}

    ckpt_dir = tempfile.mkdtemp(prefix="lm_demo_")
    loop_cfg = LoopConfig(total_steps=args.steps, ckpt_every=40,
                          ckpt_dir=ckpt_dir, log_every=20)

    def cb(step_i, metrics):
        print(f"  step {step_i:4d} loss {float(metrics['loss']):.3f}")

    try:
        if args.resume_demo:
            first = LoopConfig(total_steps=args.steps * 2 // 3,
                               ckpt_every=40, ckpt_dir=ckpt_dir,
                               log_every=20)
            run(state, step, batch_fn, first, cb)
            print("-- simulated preemption; relaunching --")
        res = run(state, step, batch_fn, loop_cfg, cb)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    if res.resumed_from:
        print(f"resumed from checkpointed step {res.resumed_from}")
    first_loss = res.losses[0] if res.losses else float("nan")
    last_loss = res.losses[-1] if res.losses else float("nan")
    print(f"loss {first_loss:.3f} -> {last_loss:.3f} over {res.steps_run} "
          f"steps ({res.stragglers} straggler steps, {res.nan_skips} NaN "
          "skips)")

    # token-table tier report (zipf head -> fp32, tail -> int8)
    pri = res.state.priority
    planned = plan_thresholds_for_ratio(pri, cfg.d_model, 0.5)
    tiers = assign_tiers(pri, planned)
    ratio = compression_ratio(tiers, cfg.d_model)
    print("token-embedding memory at thresholds for 50% budget: "
          f"{ratio:.1%} of fp32")
    return {"loss_first": first_loss, "loss_last": last_loss,
            "steps_run": res.steps_run, "resumed_from": res.resumed_from,
            "memory_ratio": ratio, "params": n_params}


if __name__ == "__main__":
    main()
