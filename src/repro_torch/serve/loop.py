"""Online request loop over a synthetic drifting-zipf workload.

Port of the request-at-a-time part of ``repro/serve/loop.py``.
``drifting_zipf_batch`` draws per-field zipf-ranked ids whose hot set
moves ``drift`` ids per request (the same numpy draws as the reference);
``run_loop`` times a request stream; ``serve_forward_loop`` is the online
serving loop behind ``repro_torch.launch.serve --online``: cache-first forward
(or the model's fused head with ``fuse_matmul``) + priority fold +
synchronous re-tiers.

Timing: a request's window covers building its batch on the device, the
forward, the fold and any re-tier, and ends after
``torch.cuda.synchronize()`` on the card.  Percentiles come from the
streaming ``obs.registry.Histogram``, as in the reference.  The
micro-batched loops (``MicroBatcher``, ``serve_forward``) come with a
later slice (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import sync
from repro_torch.models import embedding as E
from repro_torch.obs.registry import Histogram
from repro_torch.serve.cache import cached_lookup
from repro_torch.serve.online import OnlineServer


class LoopResult(NamedTuple):
    lat_s: tuple          # per-request wall seconds
    qps: float            # whole stream minus the first request
    steady_qps: float     # second half, re-tier-affected requests excluded
    p50_us: float         # histogram-derived
    p95_us: float
    p99_us: float
    p99_retier_attributed: float  # share of the p99 tail's wall time
                                  # spent inside retier
    p99_while_retiering: float    # p99 over the requests that re-tiered
    stats: dict           # ServeStats.as_dict() snapshot

    def as_dict(self) -> dict:
        d = {"qps": round(self.qps, 1),
             "steady_qps": round(self.steady_qps, 1),
             "p50_us": round(self.p50_us, 1),
             "p95_us": round(self.p95_us, 1),
             "p99_us": round(self.p99_us, 1),
             "latency_p50": round(self.p50_us, 1),
             "latency_p95": round(self.p95_us, 1),
             "latency_p99": round(self.p99_us, 1),
             "p99_retier_attributed": round(
                 self.p99_retier_attributed, 4),
             "p99_while_retiering": round(self.p99_while_retiering, 1)}
        d.update(self.stats)
        return d


def _latency_summary(lat_us: np.ndarray, retier_us: np.ndarray,
                     warm: slice, window=None
                     ) -> tuple[float, float, float, float, float]:
    """(p50, p95, p99, p99_retier_attributed, p99_while_retiering) over
    the warm window; see ``repro/serve/loop.py::_latency_summary``."""
    lw, rw = lat_us[warm], retier_us[warm]
    hist = Histogram()
    hist.record_many(lw)
    p50, p95, p99 = (hist.percentile(q) for q in (50, 95, 99))
    tail = lw >= p99
    denom = float(lw[tail].sum())
    attributed = float(rw[tail].sum()) / denom if denom > 0 else 0.0
    p99_while = 0.0
    if window is not None:
        ww = np.asarray(window, bool)[warm]
        if ww.any():
            wh = Histogram()
            wh.record_many(lw[ww])
            p99_while = float(wh.percentile(99))
    return (p50, p95, p99, float(min(max(attributed, 0.0), 1.0)),
            p99_while)


def drifting_zipf_batch(cardinalities, batch: int, request: int,
                        num_requests: int, *, a: float = 1.2,
                        drift: float = 4.0, seed: int = 0) -> np.ndarray:
    """Field-local int32 (batch, F) ids, zipf-ranked with a moving hot
    set: rank r of field f maps to id ``(r + floor(drift * request)) %
    card_f``.  ``num_requests`` is unused (kept for the reference's
    signature)."""
    del num_requests
    cards = np.asarray(cardinalities, np.int64)
    rng = np.random.default_rng(seed * 1_000_003 + request)
    ranks = rng.zipf(a, size=(batch, cards.size)).astype(np.int64) - 1
    shift = np.int64(np.floor(drift * request))
    return ((ranks + shift) % cards[None, :]).astype(np.int32)


def run_loop(server: OnlineServer, serve_fn: Callable[[np.ndarray], object],
             make_batch: Callable[[int], np.ndarray], requests: int,
             batch: int, audit: Callable | None = None) -> LoopResult:
    """Drive ``requests`` batches through ``serve_fn`` and time them.

    ``serve_fn`` gets the (batch, F) field-local ids and runs the forward
    and ``server.observe``.  ``audit(r, idx)``, if given, runs before
    request ``r`` outside its timed window and may return a callable that
    gets the request's output after the window.  Requests that re-tiered,
    and their successors, are left out of the steady-state window.
    """
    device = server.device
    lat, retiered, retier_s = [], [], []
    for r in range(requests):
        idx = make_batch(r)
        after = audit(r, idx) if audit is not None else None
        n_retiers = server.stats.retiers
        r0 = server.stats.retier_seconds
        sync(device)
        t0 = time.perf_counter()
        out = serve_fn(idx)
        sync(device)
        lat.append(time.perf_counter() - t0)
        retiered.append(server.stats.retiers > n_retiers)
        retier_s.append(server.stats.retier_seconds - r0)
        if after is not None:
            after(out)
    lat_arr = np.asarray(lat)
    warm_sl = slice(1, None) if len(lat) > 1 else slice(None)
    warm = lat_arr[warm_sl]
    steady = [lat_arr[i] for i in range(len(lat) // 2, len(lat))
              if not (i == 0 or retiered[i] or retiered[i - 1])]
    steady = np.asarray(steady) if steady else lat_arr[len(lat) // 2:]
    p50, p95, p99, attributed, p99_while = _latency_summary(
        lat_arr * 1e6, np.asarray(retier_s) * 1e6, warm_sl, retiered)
    return LoopResult(
        lat_s=tuple(lat), qps=batch / float(warm.mean()),
        steady_qps=batch / float(steady.mean()),
        p50_us=p50, p95_us=p95, p99_us=p99,
        p99_retier_attributed=attributed, p99_while_retiering=p99_while,
        stats=server.stats.as_dict())


def _fused_entry(server: OnlineServer, model, fuse_matmul: bool):
    """(fused_head | None, needs_emb, bag_matmul_fn | None) for the
    ``fuse_matmul`` serving mode; raises for a model without a fused
    head (DLRM: its first consumer of emb is the Gram interaction)."""
    if not fuse_matmul:
        return None, False, None
    fused = model.extras.get("fused_head")
    if fused is None:
        raise ValueError(f"model {model.name!r} has no fused head "
                         "(extras['fused_head']); serve without fuse_matmul")
    return (fused, bool(model.extras.get("fused_needs_emb")),
            server.bag_matmul_fn())


def request_batch(idx: np.ndarray, r: int, num_dense: int,
                  device: torch.device) -> dict:
    """Request ``r``'s batch on ``device``: the ids, zero labels and, for
    ``num_dense > 0``, standard-normal dense features drawn from seed
    ``10_000 + r`` (the reference's draw)."""
    b = {"indices": torch.from_numpy(idx).to(device),
         "labels": torch.zeros((idx.shape[0],), device=device)}
    if num_dense:
        rr = np.random.default_rng(10_000 + r)
        b["dense"] = torch.from_numpy(rr.standard_normal(
            (idx.shape[0], num_dense)).astype(np.float32)).to(device)
    return b


def serve_forward_loop(server: OnlineServer, model, spec, params, *,
                       batch: int, requests: int, drift: float = 4.0,
                       num_dense: int = 0, a: float = 1.2, seed: int = 0,
                       fuse_matmul: bool = False,
                       audit: Callable | None = None) -> LoopResult:
    """The online serving loop: serve ``requests`` drifting-zipf batches through
    ``model.head(params, cached_lookup(...), batch)``, or with
    ``fuse_matmul`` through ``extras["fused_head"]`` (the deep branch's
    first matmul fused with the gather; heads that take no raw
    embeddings skip the cache, hits = 0), then fold each batch.
    ``audit`` as in ``run_loop``, except that the callable it returns
    gets ``(out, emb)``: the request's output and the embeddings it was
    served (None when the fused head took none)."""
    lfn = server.lookup_fn()
    fused, needs_emb, bmfn = _fused_entry(server, model, fuse_matmul)
    device = server.device

    def fwd(packed, cache, net, b):
        gidx = E.globalize(b["indices"], spec)
        if fused is not None:
            def bm(w):
                return bmfn(packed, gidx, w)
            if needs_emb:
                emb, hits = cached_lookup(packed, cache, gidx, lfn)
                return fused(net, b, bm, emb), hits, gidx, emb
            return fused(net, b, bm), 0, gidx, None
        emb, hits = cached_lookup(packed, cache, gidx, lfn)
        return model.head(net, emb, b), hits, gidx, emb

    counter = {"r": 0}
    served = {"emb": None}

    def serve_fn(idx: np.ndarray):
        r = counter["r"]
        counter["r"] += 1
        b = request_batch(idx, r, num_dense, device)
        with torch.inference_mode():
            out, hits, gidx, served["emb"] = fwd(server.packed,
                                                 server.cache, params, b)
            server.observe(gidx, int(hits))
        return out

    def audit_emb(r: int, idx: np.ndarray):
        after = audit(r, idx)
        if after is None:
            return None
        return lambda out: after(out, served["emb"])

    cards = np.asarray(spec.cardinalities, np.int64)
    return run_loop(
        server, serve_fn,
        lambda r: drifting_zipf_batch(cards, batch, r, requests, a=a,
                                      drift=drift, seed=seed),
        requests, batch, audit=None if audit is None else audit_emb)
