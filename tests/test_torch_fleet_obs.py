"""The port's fleet metrics (``repro_torch.obs.fleet``) against
``repro.obs.fleet``, on the CPU.

Registries filled from the same latency streams in both packages (one
replica with ten times the traffic at ten times the latency, one with a
single request, one empty): the merged snapshot, the fleet percentiles,
the statsd lines and ``merge_snapshots`` are equal (tolerance 0), also
from the snapshots of either package.  On the port's own streams:
cumulative JSONL streams re-merge from their last lines to the live
merge, ``last_snapshot`` reads the last line and refuses an empty
stream, and the reference's ``tools/summarize_metrics.py --statsd``, run
on the port-written streams in a subprocess, prints what the port's
``FleetAggregator.statsd()`` prints.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import torch_threads

from repro import obs as jobs
from repro_torch import obs as tobs

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _clean():
    for o in (jobs, tobs):
        o.disable()
        o.get_registry().reset()
        o.set_sink(None)


@pytest.fixture(autouse=True)
def _clean_registries():
    _clean()
    yield
    _clean()


def _streams():
    rng = np.random.default_rng(3)
    return [rng.uniform(100, 200, 1000) * 10,
            rng.uniform(100, 200, 100),
            np.array([2.5e4]),
            np.array([])]


def _regs(o, streams, named=True):
    """One registry a stream in package ``o``: the latencies, a request
    counter, a fractional counter, a queue gauge and an occupancy gauge."""
    regs = []
    for i, vals in enumerate(streams):
        reg = o.Registry(enabled=True, name=f"replica{i}" if named else None)
        reg.inc("serve.requests", len(vals))
        reg.inc("serve.retier.rows_moved", 3 * i)
        reg.inc("frac", 0.25 * i)
        reg.gauge("fleet.queue", float(i))
        reg.gauge("store.tier_rows_int8", 100.0 - i)
        reg.histogram("serve.request_us").record_many(np.asarray(vals))
        reg.histogram("serve.lookup_us").record_many(np.asarray(vals) / 3)
        reg.ticks = 7 * i
        regs.append(reg)
    return regs


@pytest.mark.parametrize("named", [True, False], ids=["named", "unnamed"])
def test_fleet_aggregator_equals_the_reference(named):
    streams = _streams()
    jagg = jobs.FleetAggregator(_regs(jobs, streams, named))
    tagg = tobs.FleetAggregator(_regs(tobs, streams, named))
    assert tagg.snapshot() == jagg.snapshot()
    assert tagg.statsd() == jagg.statsd()
    for name in ("serve.request_us", "serve.lookup_us", "absent_us"):
        for qs in ((50, 95, 99), (0, 1, 99.9, 100)):
            assert tagg.percentiles(name, qs) == jagg.percentiles(name, qs)
    merged = tagg.merged()
    assert merged.name == "fleet"
    assert merged.counters["serve.requests"] == 1101
    label = "replica1" if named else "r1"
    assert merged.gauges[f"{label}.fleet.queue"] == 1.0
    assert merged.ticks == 42
    # the union stream's percentiles, not a mean of the replicas'
    union = tobs.Histogram()
    union.record_many(np.concatenate(streams))
    assert tagg.percentiles("serve.request_us") == tuple(
        union.percentile(q) for q in (50, 95, 99))


def test_merge_snapshots_reads_either_package():
    streams = _streams()
    jsnaps = [json.loads(json.dumps(jobs.snapshot(r)))
              for r in _regs(jobs, streams)]
    tsnaps = [json.loads(json.dumps(tobs.snapshot(r)))
              for r in _regs(tobs, streams)]
    assert tsnaps == jsnaps
    want = jobs.merge_snapshots(jsnaps)
    assert tobs.merge_snapshots(tsnaps) == want
    assert tobs.merge_snapshots(jsnaps) == want
    assert jobs.merge_snapshots(tsnaps) == want
    assert (tobs.FleetAggregator.from_snapshots(tsnaps).statsd()
            == jobs.FleetAggregator.from_snapshots(jsnaps).statsd())
    assert want["source"] == "fleet"


def _write_streams(tmp_path, streams, splits=3):
    """Per-replica cumulative JSONL streams from the port's sink: each
    replica's values arrive in ``splits`` parts with a snapshot line after
    each part.  Returns (paths, the live registries)."""
    paths, regs = [], []
    for i, vals in enumerate(streams):
        reg = tobs.Registry(enabled=True, name=f"replica{i}")
        path = str(tmp_path / f"replica{i}.jsonl")
        sink = tobs.JsonlSink(path)
        for part in np.array_split(np.asarray(vals), splits):
            reg.inc("serve.requests", len(part))
            reg.gauge("fleet.queue", float(len(part)))
            reg.histogram("serve.request_us").record_many(part)
            reg.ticks += 1
            sink.write(reg)
        paths.append(path)
        regs.append(reg)
    return paths, regs


def test_split_streams_remerge_from_their_last_lines(tmp_path):
    paths, regs = _write_streams(tmp_path, _streams())
    lines = [p for p in pathlib.Path(paths[0]).read_text().splitlines()
             if p.strip()]
    assert len(lines) == 3
    snaps = [tobs.last_snapshot(p) for p in paths]
    assert snaps[0] == json.loads(lines[-1])
    assert [s["source"] for s in snaps] == [f"replica{i}"
                                            for i in range(4)]
    live = tobs.FleetAggregator(regs)
    assert tobs.merge_snapshots(snaps) == live.snapshot()
    assert tobs.FleetAggregator.from_snapshots(snaps).percentiles(
        "serve.request_us") == live.percentiles("serve.request_us")
    # summing every line would count the cumulative snapshots again
    every = [json.loads(ln) for p in paths
             for ln in pathlib.Path(p).read_text().splitlines()]
    assert (tobs.merge_snapshots(every)["counters"]["serve.requests"]
            > live.merged().counters["serve.requests"])
    assert jobs.last_snapshot(paths[1]) == snaps[1]
    empty = tmp_path / "empty.jsonl"
    empty.write_text("\n")
    with pytest.raises(ValueError, match="no metrics_snapshot"):
        tobs.last_snapshot(str(empty))


def test_summarize_metrics_statsd_prints_the_ports_merge(tmp_path):
    paths, regs = _write_streams(tmp_path, _streams()[:3])
    env = torch_threads.subprocess_env()
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "summarize_metrics.py"),
         "--statsd", *paths], capture_output=True, text=True, env=env,
        timeout=300, check=True)
    assert out.stdout.splitlines() == tobs.FleetAggregator(regs).statsd()
    assert any(ln.startswith("serve.request_us") for ln in
               out.stdout.splitlines())
