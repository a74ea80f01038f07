"""Fault-tolerant training loop.

Port of ``repro/train/loop.py``:

  * **checkpoint/restart**: atomic versioned checkpoints every
    ``ckpt_every`` steps (async: the write overlaps the next steps); on
    (re)start the loop restores the newest valid checkpoint and resumes
    at its step;
  * **data determinism across restarts**: batches are a pure function of
    the step index, so a resume replays the exact stream;
  * **straggler count**: steps slower than ``straggler_factor`` x the
    trailing median of the last 20 are counted;
  * **NaN guard**: a non-finite loss keeps the last good state (the
    step returns it untouched, see ``train.steps``) and is counted;
    ``max_consecutive_nans`` in a row abort.

A step is timed from its call to ``torch.cuda.synchronize()`` on every
card the state lives on (``state_devices``: a placed state's shards run
on their own cards, and the loss readback alone would leave the tail
kernels out), as the ``train.step`` timeblock.  With metrics on
(``obs``) the loop records the reference's metrics: ``train.step_us``, the ``train.steps`` and
``train.stragglers`` counters, the ``train.loss`` gauge, one
``obs.tick()`` a step, and the ``train.ckpt_save`` / ``train.ckpt_drain``
spans.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Callable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.ckpt.manager import CheckpointManager, tree_paths
from repro_torch.dist.packed import RowShards
from repro_torch.train.steps import TrainState


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 100
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep: int = 3
    log_every: int = 50
    straggler_factor: float = 3.0
    max_consecutive_nans: int = 5
    async_ckpt: bool = True


@dataclasses.dataclass
class LoopResult:
    state: TrainState
    steps_run: int
    resumed_from: int | None
    losses: list
    stragglers: int
    nan_skips: int
    step_seconds: list        # wall time of each step run here
    ckpt_writes: list = dataclasses.field(default_factory=list)
                              # CheckpointManager.writes of this run


def state_devices(state) -> list[torch.device]:
    """The CUDA devices a train state lives on, each once: every tensor
    leaf's and every shard of a placed (``RowShards``) leaf's."""
    devs = []
    for _, leaf in tree_paths(state):
        if isinstance(leaf, RowShards):
            found = leaf.mesh.distinct_devices()
        elif isinstance(leaf, torch.Tensor):
            found = [leaf.device]
        else:
            found = []
        devs += [d for d in found if d.type == "cuda" and d not in devs]
    return devs


def run(state: TrainState, step_fn: Callable, batch_fn: Callable,
        cfg: LoopConfig, metrics_cb: Callable | None = None) -> LoopResult:
    """batch_fn(step: int) -> batch dict on the device; step_fn(state,
    batch) -> (state, metrics)."""
    mgr = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep)
    resumed_from = None
    start = 0
    try:
        state, restored_step = mgr.restore(state)
        start = restored_step
        resumed_from = restored_step
    except FileNotFoundError:
        pass
    cards = state_devices(state)

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)

    losses, step_seconds = [], []
    durations: list[float] = []
    stragglers = nan_skips = consecutive_nans = 0

    for step in range(start, cfg.total_steps):
        batch = batch_fn(step)
        sync()
        with obs.timeblock("train.step") as tb:
            new_state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            sync()
        dt = tb.seconds

        if np.isfinite(loss):
            state = new_state
            consecutive_nans = 0
        else:
            nan_skips += 1
            consecutive_nans += 1
            if consecutive_nans >= cfg.max_consecutive_nans:
                raise FloatingPointError(
                    f"{consecutive_nans} consecutive non-finite losses "
                    f"at step {step}")

        step_seconds.append(dt)
        durations.append(dt)
        if len(durations) > 20:
            durations.pop(0)
        med = float(np.median(durations))
        if len(durations) >= 5 and dt > cfg.straggler_factor * med:
            stragglers += 1
            if obs.enabled():
                obs.inc("train.stragglers")

        losses.append(loss)
        if obs.enabled():
            obs.inc("train.steps")
            obs.gauge("train.loss", loss)
        obs.tick()
        if metrics_cb and step % cfg.log_every == 0:
            metrics_cb(step, metrics)
        if (step + 1) % cfg.ckpt_every == 0:
            with obs.span("train.ckpt_save"):
                mgr.save(step + 1, state, blocking=not cfg.async_ckpt)

    # drain an in-flight async save before deciding whether the final
    # step is already on disk (latest_step sees only published manifests)
    with obs.span("train.ckpt_drain"):
        mgr.wait()
    if mgr.latest_step() != cfg.total_steps:
        with obs.span("train.ckpt_save"):
            mgr.save(cfg.total_steps, state, blocking=True)
    return LoopResult(state=state, steps_run=cfg.total_steps - start,
                      resumed_from=resumed_from, losses=losses,
                      stragglers=stragglers, nan_skips=nan_skips,
                      step_seconds=step_seconds, ckpt_writes=mgr.writes)
