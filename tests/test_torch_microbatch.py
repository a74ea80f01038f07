"""The port's micro-batched serving against the JAX package, on the CPU.

``MicroBatcher`` emits the reference's batches; ``serve_forward`` on the
smoke dlrm-rm2 store, from the same snapped store and weights, gives the
reference's counters (requests, lookups, cache hits, re-tiers, rows
moved), the same live priorities and pack afterwards (bit for bit), and
logits within ``1e-5 * max(1, |ref|)`` (GEMMs and the Gram interaction
sum in other orders); ``stream_bytes_per_request`` and the serve CLI's
``--serve-batch`` record equal the reference's.  ``OnlineServer.observe``
counts a batch's valid lookups from the batcher's numpy mask.
"""

from __future__ import annotations

import contextlib
import io
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro import configs as jconfigs
from repro.core import packed_store as jps
from repro.core import qat_store as jqs
from repro.core.tiers import plan_thresholds_for_ratio
from repro.launch import serve as jserve_cli
from repro.serve import OnlineConfig as JOnlineConfig
from repro.serve import OnlineServer as JOnlineServer
from repro.serve import loop as jloop
from repro_torch import configs as tconfigs
from repro_torch import kernels as tkernels
from repro_torch.convert import params_from_jax, qat_store_from_jax
from repro_torch.core import packed_store as tps
from repro_torch.core import qat_store as tqs
from repro_torch.launch import serve as tserve
from repro_torch.serve import loop as tloop
from repro_torch.serve.online import OnlineConfig, OnlineServer

TOL = 1e-5


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        x = x.detach().cpu().numpy()
    a = np.asarray(x)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def test_microbatcher_emits_the_reference_batches():
    rng = np.random.default_rng(0)
    reqs = rng.integers(0, 50, (11, 4)).astype(np.int32)
    jb, tb = jloop.MicroBatcher(3, 4), tloop.MicroBatcher(3, 4)
    jout, tout = [], []
    for r in reqs:
        jout.append(jb.add(r))
        tout.append(tb.add(r))
        assert len(tb) == len(jb)
    jout.append(jb.flush())
    tout.append(tb.flush())
    assert tb.flush() is None and jb.flush() is None
    assert [x is None for x in tout] == [x is None for x in jout]
    for j, t in zip(jout, tout):
        if j is not None:
            np.testing.assert_array_equal(t.indices, j.indices)
            np.testing.assert_array_equal(t.valid, j.valid)
            assert t.count == j.count
    assert tout[-1].count == 2 and not tout[-1].valid[2]
    with pytest.raises(ValueError):
        tloop.MicroBatcher(0, 4)
    with pytest.raises(ValueError, match="fields"):
        tloop.MicroBatcher(2, 4).add(np.zeros(3, np.int32))


def _spy(module, outs):
    """Wrap ``module.run_microbatched_loop`` so each batch's output is
    kept; returns the original for the caller to restore."""
    orig = module.run_microbatched_loop

    def spy(server, serve_fn, make_request, requests, serve_batch, **kw):
        def recorded(mb):
            out = serve_fn(mb)
            outs.append(np.array(out))
            return out
        return orig(server, recorded, make_request, requests, serve_batch,
                    **kw)

    module.run_microbatched_loop = spy
    return orig


@pytest.fixture(scope="module")
def served():
    """The reference CLI's online start at smoke size (dlrm-rm2), then
    ``serve_forward`` in both packages from that store."""
    requests, serve_batch, online = 14, 4, dict(cache_rows=4096,
                                                retier_every=3)
    model = jconfigs.get("dlrm-rm2").smoke_model
    spec = model.spec
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    pri = jnp.asarray((rng.pareto(1.2, spec.total_rows) * 10)
                      .astype(np.float32))
    cfg = jqs.FQuantConfig(tiers=plan_thresholds_for_ratio(pri, spec.dim,
                                                           0.5),
                           stochastic=False)
    store = jqs.QATStore(params["embed_table"], pri)
    store = store._replace(table=jqs.snap(
        store.table, jqs.current_tiers(store, cfg), cfg))
    jserver = JOnlineServer(store, cfg, JOnlineConfig(**online))
    jouts: list = []
    orig = _spy(jloop, jouts)
    try:
        jres = jloop.serve_forward(jserver, model, spec, params,
                                   serve_batch=serve_batch,
                                   requests=requests, num_dense=5)
    finally:
        jloop.run_microbatched_loop = orig

    tmodel = tconfigs.get("dlrm-rm2").smoke_model
    tparams = params_from_jax(jax.tree.map(np.asarray, params))
    tparams.pop("embed_table")
    tcfg = tqs.FQuantConfig(tiers=cfg.tiers, stochastic=False)
    tserver = OnlineServer(qat_store_from_jax(store), tcfg,
                           OnlineConfig(**online))
    touts: list = []
    orig = _spy(tloop, touts)
    tkernels.reset_launches()
    try:
        tres = tloop.serve_forward(tserver, tmodel, tmodel.spec, tparams,
                                   serve_batch=serve_batch,
                                   requests=requests, num_dense=5)
    finally:
        tloop.run_microbatched_loop = orig
    return {"jres": jres, "tres": tres, "jouts": jouts, "touts": touts,
            "jserver": jserver, "tserver": tserver, "spec": spec,
            "requests": requests, "launches": tkernels.launch_counts()}


def test_serve_forward_counters_match_jax(served):
    js, ts = served["jres"].stats, served["tres"].stats
    for key in ("requests", "lookups", "hits", "retiers", "rows_moved",
                "cache_hit_rate", "shadow_builds", "swaps"):
        assert ts[key] == js[key], key
    assert ts["requests"] == served["requests"] and ts["retiers"] == 3
    assert ts["lookups"] == served["requests"] * served["spec"].num_fields
    assert ts["hits"] > 0 and ts["rows_moved"] > 0
    assert len(served["tres"].lat_s) == len(served["jres"].lat_s) == 4
    assert set(served["launches"].values()) == {0}      # CPU: plain versions


def test_serve_forward_logits_match_jax(served):
    assert len(served["touts"]) == len(served["jouts"]) == 4
    for want, got in zip(served["jouts"], served["touts"]):
        want = np.asarray(want, np.float64)
        got = got.astype(np.float64)
        assert want.shape == got.shape == (4,)
        assert np.all(np.abs(got - want)
                      <= TOL * np.maximum(1.0, np.abs(want)))


def test_serve_forward_leaves_the_reference_state(served):
    js, ts = served["jserver"], served["tserver"]
    np.testing.assert_array_equal(bits(ts.store.priority),
                                  bits(js.store.priority))
    jp = js.host_packed
    for name in jps.PackedStore._fields:
        want = np.asarray(getattr(jp, name))
        if want.dtype.kind == "V":
            want = want.view(np.uint16)
        np.testing.assert_array_equal(bits(getattr(ts.host_packed, name)),
                                      bits(want), err_msg=name)


def test_stream_bytes_per_request_matches_jax(served):
    spec, tiers = served["spec"], served["tserver"].packed
    tiers = tps.packed_tiers(served["tserver"].host_packed)
    want = jloop.stream_bytes_per_request(tiers.numpy(), spec, 20)
    assert tloop.stream_bytes_per_request(tiers, spec, 20) == want
    assert tloop.stream_bytes_per_request(tiers.numpy(), spec, 20,
                                          drift=0.0) == \
        jloop.stream_bytes_per_request(tiers.numpy(), spec, 20, drift=0.0)


def test_observe_counts_valid_lookups_on_the_host():
    model = tconfigs.get("dlrm-rm2").smoke_model
    spec = model.spec
    table = torch.zeros((spec.total_rows, spec.dim))
    pri = torch.zeros(spec.total_rows)
    server = OnlineServer(tqs.QATStore(table, pri), tqs.FQuantConfig(
        stochastic=False), OnlineConfig(retier_every=4))
    idx = torch.arange(3 * spec.num_fields).reshape(3, -1)
    valid = np.array([True, True, False])
    assert server.observe(idx, 0, valid=valid[:, None], count=2) is False
    assert server.stats.lookups == 2 * spec.num_fields
    assert server.stats.requests == 2
    # the padded row's ids are not folded
    assert float(server.store.priority[idx[2]].abs().sum()) == 0.0
    assert float(server.store.priority[idx[0]].min()) > 0.0
    # a batch spanning two boundaries re-tiers once
    server.observe(idx, 0, valid=np.ones((3, 1), bool), count=7)
    assert server.stats.retiers == 1


def test_observe_takes_a_device_mask_with_its_host_count():
    model = tconfigs.get("dlrm-rm2").smoke_model
    spec = model.spec
    idx = torch.arange(3 * spec.num_fields).reshape(3, -1)
    valid = np.array([True, False, True])
    servers = [OnlineServer(
        tqs.QATStore(torch.zeros((spec.total_rows, spec.dim)),
                     torch.zeros(spec.total_rows)),
        tqs.FQuantConfig(stochastic=False), OnlineConfig(retier_every=4))
        for _ in range(2)]
    servers[0].observe(idx, 1, valid=valid[:, None], count=2)
    servers[1].observe(idx, 1, valid=torch.from_numpy(valid)[:, None],
                       count=2, lookups=2 * spec.num_fields)
    assert servers[0].stats.as_dict() == servers[1].stats.as_dict()
    assert torch.equal(servers[0].store.priority, servers[1].store.priority)
    with pytest.raises(ValueError, match="lookups"):
        servers[1].observe(idx, 0, valid=torch.from_numpy(valid)[:, None])


def test_serve_batch_cli_matches_the_reference_cli():
    argv = ["--arch", "dlrm-rm2", "--online", "--serve-batch", "4",
            "--requests", "10", "--cache-rows", "32", "--retier-every", "3"]
    out, old = io.StringIO(), sys.argv
    sys.argv = ["serve", *argv]
    try:
        with contextlib.redirect_stdout(out):
            jserve_cli.main()
    finally:
        sys.argv = old
    jrec = json.loads(out.getvalue().strip().splitlines()[-1])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve.main([*argv, "--model", "smoke", "--device", "cpu"])
    rec = json.loads(out.getvalue().strip().splitlines()[-1])
    for key in ("requests", "lookups", "hits", "retiers", "rows_moved",
                "cache_hit_rate", "serve_batch", "bytes_per_request_fp32",
                "bytes_per_request_packed", "packed_mib",
                "packed_fp32_ratio", "retier_every", "cache_rows"):
        assert rec[key] == jrec[key], key
    assert rec["serve_batch"] == 4 and rec["retiers"] == 3
    assert set(rec["kernel_launches"].values()) == {0}


def test_serve_batch_needs_online_and_staging_is_refused():
    with pytest.raises(SystemExit):
        tserve.parse_args(["--serve-batch", "4"])

    class Staged:
        needs_staging = True

    class Server:
        backend = Staged()

    # the staged pipeline is ported (tests/test_torch_serve_hier.py); what
    # it refuses is the fused head, which needs a fully resident store,
    # and the hier shim refuses a backend that does not stage
    with pytest.raises(ValueError, match="fully resident"):
        tloop.serve_forward(Server(), None, None, None, serve_batch=2,
                            requests=2, fuse_matmul=True)
    Server.backend = type("Resident", (), {"needs_staging": False})()
    with pytest.raises(ValueError, match="hier=HierConfig"):
        tloop.serve_forward_hier(Server(), None, None, None, serve_batch=2,
                                 requests=2)
