"""The port's DLRM head and served request against the JAX package.

Params and the packed store are made by the reference and carried across
with ``repro_torch.convert``.  Embeddings are compared bit for bit; logits
within ``|d| <= 1e-5 * max(1, |ref|)``, because the fp32 MLP products and
the Gram reduce in another order in XLA than in torch.
"""

from __future__ import annotations

import contextlib
import io
import json

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
from repro.models import embedding as jE
from repro_torch import configs as tconfigs
from repro_torch.convert import packed_from_jax, params_from_jax
from repro_torch.core import packed_store as tps
from repro_torch.kernels.dequant_bag import kernel as tkernel
from repro_torch.launch import serve as tserve

TOL = 1e-5


def _close(want, got):
    want = np.asarray(want, np.float64)
    got = got.detach().cpu().numpy().astype(np.float64)
    assert want.shape == got.shape
    assert np.all(np.abs(got - want) <= TOL * np.maximum(1.0, np.abs(want)))


@pytest.fixture(scope="module")
def smoke():
    """The flat packed branch of the reference CLI at smoke size, up to
    its jitted ``serve`` (repro/launch/serve.py:227-243, 410-426)."""
    arch = jconfigs.get("dlrm-rm2")
    model = arch.smoke_model
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
    packed = jps.pack(store, cfg)
    host = jps.PackedStore(*(np.asarray(x) for x in packed))
    host = host._replace(payload16=host.payload16.view(np.uint16))
    return {"arch": arch, "model": model, "spec": spec, "params": params,
            "packed": packed, "tparams": params_from_jax(
                jax.tree.map(np.asarray, params)),
            "tpacked": packed_from_jax(host)}


def test_dlrm_head_matches_jax(smoke):
    model = smoke["model"]
    b, f, d = 33, model.spec.num_fields, model.spec.dim
    rng = np.random.default_rng(7)
    emb = rng.standard_normal((b, f, d)).astype(np.float32) * 0.1
    dense = rng.standard_normal((b, 5)).astype(np.float32)
    want = model.head(smoke["params"], jnp.asarray(emb),
                      {"dense": jnp.asarray(dense)})
    tmodel = tconfigs.get("dlrm-rm2").smoke_model
    got = tmodel.head(smoke["tparams"], torch.from_numpy(emb),
                      {"dense": torch.from_numpy(dense)})
    _close(want, got)


@pytest.mark.parametrize("r", [0, 5])
def test_served_request_matches_jax(smoke, r):
    model, spec = smoke["model"], smoke["spec"]
    batch_size = 48
    # the request draw of repro/launch/serve.py
    rr = np.random.default_rng(r)
    cards = np.asarray(spec.cardinalities, np.int64)
    idx = (rr.random((batch_size, spec.num_fields)) * cards[None, :]
           ).astype(np.int32)
    dense = np.random.default_rng(10_000 + r).standard_normal(
        (batch_size, 5)).astype(np.float32)
    jbatch = {"indices": jnp.asarray(idx), "dense": jnp.asarray(dense)}
    gidx = jE.globalize(jbatch["indices"], spec)
    jemb = jps.lookup_fused(smoke["packed"], gidx)
    want = model.head(smoke["params"], jemb, jbatch)

    tarch = tconfigs.get("dlrm-rm2")
    tbatch = tserve.request_maker(tarch.smoke_model.spec, batch_size,
                                  tarch.smoke_num_dense)(r)
    np.testing.assert_array_equal(tbatch["indices"].numpy(), idx)
    np.testing.assert_array_equal(tbatch["dense"].numpy(), dense)
    tkernel.reset_launches()
    got = tserve.serve_request(tarch.smoke_model, smoke["tparams"],
                               smoke["tpacked"], tbatch)
    assert tkernel.total_launches() == 0
    _close(want, got)
    gidx_t = tbatch["indices"] + torch.from_numpy(spec.offsets())[None, :]
    temb = tps.lookup_fused(smoke["tpacked"], gidx_t)
    np.testing.assert_array_equal(np.asarray(jemb).view(np.uint32),
                                  temb.numpy().view(np.uint32))


def test_driver_plans_the_reference_tiers(smoke):
    """The port's store build draws the reference CLI's priorities and
    plans the same Eq. 8 tiers (its table is its own random draw)."""
    spec = smoke["spec"]
    packed, _ = tserve.build_store(tconfigs.get("dlrm-rm2").smoke_model.spec,
                                   torch.device("cpu"), chunk_rows=50_000)
    np.testing.assert_array_equal(tps.packed_tiers(packed).numpy(),
                                  jps.packed_tiers(smoke["packed"]))
    assert packed.nbytes() == smoke["packed"].nbytes()
    assert packed.vocab == spec.total_rows


def test_serve_cli_on_cpu_records_zero_launches():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve.main(["--model", "smoke", "--device", "cpu", "--requests",
                     "3", "--batch", "32"])
    rec = json.loads(out.getvalue().strip().splitlines()[-1])
    for key in ("qps", "p50_us", "p99_us", "packed_mib",
                "packed_fp32_ratio", "device", "kernel_launches"):
        assert key in rec
    assert rec["device"] == "cpu" and rec["kernel_launches"] == 0
    assert rec["model"] == "smoke" and rec["requests"] == 3
    assert 0.5 < rec["packed_fp32_ratio"] < 0.7
