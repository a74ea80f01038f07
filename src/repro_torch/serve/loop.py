"""Online request loops over a synthetic drifting-zipf workload.

Port of ``repro/serve/loop.py``.  ``drifting_zipf_batch`` draws
per-field zipf-ranked ids whose hot set moves ``drift`` ids per request
(the same numpy draws as the reference); ``run_loop`` times a request
stream; ``serve_forward_loop`` is the online serving loop behind
``repro_torch.launch.serve --online``: cache-first forward (or the
model's fused head with ``fuse_matmul``) + priority fold + re-tiers
(synchronous, or shadow builds with ``OnlineConfig.retier_async``).

Micro-batching (``MicroBatcher``, ``run_microbatched_loop``,
``serve_forward_microbatched``, and ``serve_forward``, the one entry
point for every backend, behind ``--serve-batch``): single-user requests
accumulate into fixed-shape (N, F) batches, padded with row 0 and a
validity mask when the stream ends mid-batch, and each batch runs one
forward, one vectorised fold and one cache pass (``microbatch_serve_fn``,
which the fleet's replicas run too).  The staged branch of
``serve_forward`` (``_serve_forward_staged``, for a backend whose misses
stage through the host: the hier store) splits each batch's forward into
the host stage (``HierStore.stage``: the levels resolved, the warm and
cold misses dequantized into one staging buffer, one copy to the device),
the combine with the hot level's fused gather and the cache-first select,
then the head; its ``LoopResult.stats`` add the hier counters
(``warm_hits``, ``cold_hits``, ``staged_rows``, ``migrations``,
``promoted``, ``demoted``, ``hier_miss_rate`` and the rows of each
level).  ``stream_bytes_per_request`` is the
``bench_qps/v1`` byte account of the stream against a tier vector.

Timing: a request's (or micro-batch's) window covers building its batch
on the device, the forward, the fold and any re-tier or shadow step, and
ends when the serving stream is idle on the card (``obs.timeblock``'s
``sync``; a shadow re-tier's staging stream is not waited for).
Percentiles come from the streaming ``obs.registry.Histogram``, as in
the reference.  ``p99_while_retiering`` is the p99 over the requests
that overlapped re-tier work: a synchronous re-tier, or a shadow build
in flight when the request started, a shadow step or a swap during it.
The loops register no ``warmup_fn`` on the server: the reference's
warm-up compiles the jitted forward for a staged store's new shapes, and
eager torch has nothing to compile.

Metrics (``obs``, on with ``--metrics-out``): each request's window is
the ``serve.request`` timeblock, followed by one ``obs.tick()``; inside
it the ``serve_fn`` closures time ``serve.synth`` (the batch on the
device), ``serve.lookup`` (the forward, drained by the span's ``sync``)
and ``serve.combine`` (``server.observe``: the fold and any re-tier).
With metrics off those spans are the shared no-op span: no clock and no
sync, so the request path is what it was (its one sync is the hit
count's readback, or the window's end).  ``SERVE_PHASES`` is the
reference's span catalog, which the drivers pre-register.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import obs, sync
from repro_torch.models import embedding as E
from repro_torch.obs.registry import Histogram
from repro_torch.serve.cache import cache_select, cached_lookup
from repro_torch.serve.online import OnlineServer

# the serving span taxonomy (docs/observability.md), pre-registered by the
# drivers when metrics are on, so every snapshot carries the whole
# per-phase histogram catalog, phases that never fire included (the
# stage and migrate phases fire on the hier store, serve.shadow.build
# and serve.shadow.warmup on nothing in the port)
SERVE_PHASES = ("serve.request", "serve.synth", "serve.stage",
                "serve.lookup", "serve.combine", "serve.retier",
                "serve.shadow.plan", "serve.shadow.chunk",
                "serve.shadow.build", "serve.shadow.stage",
                "serve.shadow.verify", "serve.shadow.warmup",
                "serve.shadow.swap", "store.stage", "store.migrate")


class LoopResult(NamedTuple):
    lat_s: tuple          # per-request wall seconds
    qps: float            # whole stream minus the first request
    steady_qps: float     # second half, re-tier-affected requests excluded
    p50_us: float         # histogram-derived
    p95_us: float
    p99_us: float
    p99_retier_attributed: float  # share of the p99 tail's wall time
                                  # spent inside retier
    p99_while_retiering: float    # p99 over the requests that overlapped
                                  # re-tier work (shadow steps included)
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


def _shadow_mark(server: OnlineServer) -> tuple:
    """The counters a request's accounting diffs, read before it runs."""
    st = server.stats
    return (st.retiers, st.retier_seconds, st.shadow_chunks, st.swaps,
            server.shadow is not None)


def _account(server: OnlineServer, mark: tuple, retiered: list,
             retier_s: list, window: list) -> None:
    """Append a finished request's re-tier flag, its seconds inside
    re-tier work, and whether it overlapped re-tier work (the
    ``p99_while_retiering`` window: a re-tier, a shadow build in flight
    at its start, a shadow step or a swap), as the reference's loops
    do."""
    n_retiers, r0, c0, s0, active0 = mark
    st = server.stats
    retiered.append(st.retiers > n_retiers)
    retier_s.append(st.retier_seconds - r0)
    window.append(active0 or retiered[-1] or st.shadow_chunks > c0
                  or st.swaps > s0)


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
    lat, retiered, retier_s, window = [], [], [], []
    for r in range(requests):
        idx = make_batch(r)
        after = audit(r, idx) if audit is not None else None
        mark = _shadow_mark(server)
        sync(device)
        with obs.timeblock("serve.request") as tb:
            out = serve_fn(idx)
            sync(device)
        lat.append(tb.seconds)
        _account(server, mark, retiered, retier_s, window)
        obs.tick()
        if after is not None:
            after(out)
    lat_arr = np.asarray(lat)
    warm_sl = slice(1, None) if len(lat) > 1 else slice(None)
    warm = lat_arr[warm_sl]
    steady = [lat_arr[i] for i in range(len(lat) // 2, len(lat))
              if not (i == 0 or retiered[i] or retiered[i - 1])]
    steady = np.asarray(steady) if steady else lat_arr[len(lat) // 2:]
    p50, p95, p99, attributed, p99_while = _latency_summary(
        lat_arr * 1e6, np.asarray(retier_s) * 1e6, warm_sl, window)
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


def _forward(server: OnlineServer, model, spec, fuse_matmul: bool):
    """The online forward, ``fwd(packed, cache, net, b, valid=None) ->
    (logits, hits, gidx, emb)``: cache-first gather and ``model.head``,
    or with ``fuse_matmul`` the model's fused head (the deep branch's
    first matmul fused with the gather; heads that take no raw
    embeddings skip the cache: hits 0, emb None).  ``valid`` masks
    padded slots out of the hit count."""
    lfn = server.lookup_fn()
    fused, needs_emb, bmfn = _fused_entry(server, model, fuse_matmul)

    def fwd(packed, cache, net, b, valid=None):
        gidx = E.globalize(b["indices"], spec)
        if fused is not None:
            def bm(w):
                return bmfn(packed, gidx, w)
            if needs_emb:
                emb, hits = cached_lookup(packed, cache, gidx, lfn, valid)
                return fused(net, b, bm, emb), hits, gidx, emb
            return fused(net, b, bm), 0, gidx, None
        emb, hits = cached_lookup(packed, cache, gidx, lfn, valid)
        return model.head(net, emb, b), hits, gidx, emb
    return fwd


def request_batch(idx: np.ndarray, r: int, num_dense: int,
                  device: torch.device, dense_seed: int = 10_000) -> dict:
    """Request ``r``'s batch on ``device``: the ids, zero labels and, for
    ``num_dense > 0``, standard-normal dense features drawn from seed
    ``dense_seed + r`` (the reference's draws: 10_000 + r a request,
    20_000 + r a micro-batch)."""
    b = {"indices": torch.from_numpy(idx).to(device),
         "labels": torch.zeros((idx.shape[0],), device=device)}
    if num_dense:
        rr = np.random.default_rng(dense_seed + r)
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
    fwd = _forward(server, model, spec, fuse_matmul)
    device = server.device
    counter = {"r": 0}
    served = {"emb": None}

    def serve_fn(idx: np.ndarray):
        r = counter["r"]
        counter["r"] += 1
        with obs.span("serve.synth"):
            b = request_batch(idx, r, num_dense, device)
        with torch.inference_mode():
            with obs.span("serve.lookup") as sp:
                out, hits, gidx, served["emb"] = fwd(server.packed,
                                                     server.cache, params, b)
                sp.sync(out)
            with obs.span("serve.combine"):
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


class MicroBatch(NamedTuple):
    indices: np.ndarray   # (N, F) int32; padded slots hold row 0
    valid: np.ndarray     # (N,) bool; False marks padding
    count: int            # live requests in this batch


class MicroBatcher:
    """Accumulates single-request index vectors into fixed-shape batches.

    ``add`` returns a full ``MicroBatch`` every ``capacity`` requests and
    ``None`` otherwise; ``flush`` pads a partial tail batch (row 0
    indices, ``valid=False``), so every batch has the same (capacity, F)
    shape.
    """

    def __init__(self, capacity: int, num_fields: int):
        if capacity < 1:
            raise ValueError("micro-batch capacity must be >= 1")
        self.capacity = int(capacity)
        self.num_fields = int(num_fields)
        self._buf = np.zeros((self.capacity, self.num_fields), np.int32)
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def add(self, request) -> MicroBatch | None:
        req = np.asarray(request, np.int32).reshape(-1)
        if req.shape[0] != self.num_fields:
            raise ValueError(f"request has {req.shape[0]} fields, expected "
                             f"{self.num_fields}")
        self._buf[self._n] = req
        self._n += 1
        return self.flush() if self._n == self.capacity else None

    def flush(self) -> MicroBatch | None:
        if self._n == 0:
            return None
        n = self._n
        valid = np.zeros((self.capacity,), bool)
        valid[:n] = True
        batch = MicroBatch(indices=self._buf.copy(), valid=valid, count=n)
        self._buf[:] = 0
        self._n = 0
        return batch


def run_microbatched_loop(server: OnlineServer,
                          serve_fn: Callable[[MicroBatch], object],
                          make_request: Callable[[int], np.ndarray],
                          requests: int, serve_batch: int,
                          after: Callable[[bool], None] | None = None
                          ) -> LoopResult:
    """Drive ``requests`` single-user requests through ``serve_fn`` in
    fixed-shape micro-batches of ``serve_batch`` and time the batches.

    ``make_request(r)`` yields one (F,) index vector; ``serve_fn`` gets a
    ``MicroBatch`` and runs the forward and ``server.observe(...,
    valid=..., count=...)``; the window ends when its output's device is
    idle.  QPS counts requests, not batches.  The steady window is the
    second half of the batch stream without the batches that re-tiered
    and their successors.  ``after(retiered)``, when given, runs after
    each batch's window, outside it.
    """
    first = np.asarray(make_request(0), np.int32).reshape(-1)
    batcher = MicroBatcher(serve_batch, first.shape[0])
    lat, counts, retiered, retier_s, window = [], [], [], [], []

    def run_batch(mb: MicroBatch) -> None:
        mark = _shadow_mark(server)
        sync(server.device)
        with obs.timeblock("serve.request") as tb:
            tb.sync(serve_fn(mb))
        lat.append(tb.seconds)
        counts.append(mb.count)
        _account(server, mark, retiered, retier_s, window)
        obs.tick()
        if after is not None:
            after(retiered[-1])

    pending = batcher.add(first)
    if pending is not None:
        run_batch(pending)
    for r in range(1, requests):
        pending = batcher.add(make_request(r))
        if pending is not None:
            run_batch(pending)
    tail = batcher.flush()
    if tail is not None:
        run_batch(tail)

    lat_arr = np.asarray(lat)
    cnt_arr = np.asarray(counts, np.float64)
    warm = slice(1, None) if len(lat) > 1 else slice(None)
    half = len(lat) // 2
    steady = [i for i in range(half, len(lat))
              if not (i == 0 or retiered[i] or retiered[i - 1])]
    if not steady:
        steady = list(range(half, len(lat)))
    p50, p95, p99, attributed, p99_while = _latency_summary(
        lat_arr * 1e6, np.asarray(retier_s) * 1e6, warm, window)
    return LoopResult(
        lat_s=tuple(lat),
        qps=float(cnt_arr[warm].sum() / lat_arr[warm].sum()),
        steady_qps=float(cnt_arr[steady].sum() / lat_arr[steady].sum()),
        p50_us=p50, p95_us=p95, p99_us=p99,
        p99_retier_attributed=attributed, p99_while_retiering=p99_while,
        stats=server.stats.as_dict())


def microbatch_serve_fn(server: OnlineServer, model, spec, params, *,
                        num_dense: int = 0, fuse_matmul: bool = False,
                        served: dict | None = None
                        ) -> Callable[[MicroBatch], torch.Tensor]:
    """The micro-batched loops' ``serve_fn(mb) -> logits``: batch ``r``
    (a counter of this closure) goes to the device with dense features
    from seed ``20_000 + r`` (``serve.synth``), runs the cache-first
    forward through ``model.head`` or the fused head (``serve.lookup``,
    drained by the span's ``sync``) and folds into the server
    (``serve.combine``: ``server.observe`` with the batch's device mask
    and its live lookups counted on the host).
    ``serve_forward_microbatched`` and each replica of ``launch.fleet``
    run it.
    ``served``, when given, receives the batch's ``packed`` (the store
    the forward read), ``gidx``, ``emb`` (None when the fused head took
    none) and ``logits``."""
    fwd = _forward(server, model, spec, fuse_matmul)
    device = server.device
    counter = {"b": 0}

    def serve_fn(mb: MicroBatch) -> torch.Tensor:
        r = counter["b"]
        counter["b"] += 1
        with obs.span("serve.synth"):
            b = request_batch(mb.indices, r, num_dense, device,
                              dense_seed=20_000)
            # one upload of the batcher's mask serves the hit count and
            # the fold; the lookups are counted on the host
            valid = torch.from_numpy(mb.valid).to(device)[:, None]
        with torch.inference_mode():
            with obs.span("serve.lookup") as sp:
                packed = server.packed
                out, hits, gidx, emb = fwd(packed, server.cache, params, b,
                                           valid)
                sp.sync(out)
            if served is not None:
                served.update(packed=packed, gidx=gidx, emb=emb,
                              logits=out)
            with obs.span("serve.combine"):
                server.observe(gidx, int(hits), valid=valid, count=mb.count,
                               lookups=int(mb.valid.sum()) * gidx.shape[1])
        return out
    return serve_fn


def serve_forward_microbatched(server: OnlineServer, model, spec, params, *,
                               serve_batch: int, requests: int,
                               drift: float = 4.0, num_dense: int = 0,
                               a: float = 1.2, seed: int = 0,
                               fuse_matmul: bool = False,
                               audit: Callable | None = None) -> LoopResult:
    """Micro-batched online loop: one forward per ``serve_batch`` requests.

    Single-user drifting-zipf requests accumulate into (serve_batch, F)
    batches; each runs one cache-first forward through ``model.head``
    (or the fused head, as in ``serve_forward_loop``) and one
    ``server.observe`` fold, with padded slots masked out of the hit
    count and the priority EMA.  Dense features of batch ``r`` come from
    seed ``20_000 + r`` (the reference's draw).  The request stream
    depends only on the seed, not on ``serve_batch``.

    ``audit(packed, gidx, emb)``, when given, gets each batch that did
    not re-tier after its timed window: the store the forward read (not
    repacked since), the batch's global ids and the embeddings it was
    served (None when the fused head took none).
    """
    served: dict = {}
    serve_fn = microbatch_serve_fn(server, model, spec, params,
                                   num_dense=num_dense,
                                   fuse_matmul=fuse_matmul,
                                   served=None if audit is None else served)

    def after(retiered: bool) -> None:
        if not retiered:
            audit(served["packed"], served["gidx"], served["emb"])
        served.clear()

    cards = np.asarray(spec.cardinalities, np.int64)
    return run_microbatched_loop(
        server, serve_fn,
        lambda r: drifting_zipf_batch(cards, 1, r, requests, a=a,
                                      drift=drift, seed=seed)[0],
        requests, serve_batch, after=None if audit is None else after)


def serve_forward(server: OnlineServer, model, spec, params, *,
                  serve_batch: int, requests: int, drift: float = 4.0,
                  num_dense: int = 0, a: float = 1.2, seed: int = 0,
                  fuse_matmul: bool = False,
                  audit: Callable | None = None) -> LoopResult:
    """The one micro-batched entry point for every store backend,
    dispatched on the backend's ``needs_staging``: fully resident
    backends (packed, hashed) run ``serve_forward_microbatched``, a
    backend whose misses stage through the host (hier) runs
    ``_serve_forward_staged`` (``audit`` as each says)."""
    if server.backend.needs_staging:
        if fuse_matmul:
            raise ValueError("fuse_matmul needs a fully resident packed "
                             "store (backend stages misses)")
        return _serve_forward_staged(
            server, model, spec, params, serve_batch=serve_batch,
            requests=requests, drift=drift, num_dense=num_dense, a=a,
            seed=seed, audit=audit)
    return serve_forward_microbatched(
        server, model, spec, params, serve_batch=serve_batch,
        requests=requests, drift=drift, num_dense=num_dense, a=a, seed=seed,
        fuse_matmul=fuse_matmul, audit=audit)


def serve_forward_hier(server: OnlineServer, model, spec, params,
                       **kw) -> LoopResult:
    """The reference's shim: ``serve_forward`` on a staging backend."""
    if not server.backend.needs_staging:
        raise ValueError("serve_forward_hier needs an OnlineServer built "
                         "with hier=HierConfig(...)")
    return serve_forward(server, model, spec, params, **kw)


def _serve_forward_staged(server: OnlineServer, model, spec, params, *,
                          serve_batch: int, requests: int,
                          drift: float = 4.0, num_dense: int = 0,
                          a: float = 1.2, seed: int = 0,
                          audit: Callable | None = None) -> LoopResult:
    """Micro-batched online loop over a staging backend: the stream and
    cadence of ``serve_forward_microbatched``, each batch's forward split
    into

      1. host (``serve.stage``): each index's level resolved, the warm and
         cold misses dequantized into one staging buffer and copied to the
         device with one non-blocking transfer; positions the fp32 cache
         serves (``server.cache_mask``) are skipped;
      2. device (``serve.lookup``): the hot level's fused gather (one
         tiered ``dequant_bag`` launch), the staged rows where staged, the
         cache-first select, the head: bit-identical to a fully resident
         ``cached_lookup``;
      3. the fold (``serve.combine``): warm and cold misses enter the Eq. 7
         EMA like every access, so pressured rows climb the ranking and the
         next re-tier migrates them onto the device.

    ``audit(hot, staged, gidx, emb)``, when given, gets each batch that did
    not re-tier after its timed window: the hot level the forward read,
    the ``StagedBatch``, the global ids and the embeddings the head got.
    The stats add the hier counters and ``hier_miss_rate`` (warm + cold
    hits over lookups).
    """
    from repro_torch.store.hier import combine_rows

    backend = server.backend
    lfn = server.lookup_fn()
    offsets = np.asarray(spec.offsets(), np.int64)
    device = server.device
    counter = {"b": 0}
    served: dict = {}

    def serve_fn(mb: MicroBatch):
        r = counter["b"]
        counter["b"] += 1
        with obs.span("serve.stage"):
            g = mb.indices.astype(np.int64) + offsets[None, :]
            mask = server.cache_mask
            sb = backend.stage_host(g, skip=None if mask is None else mask[g],
                                    valid=mb.valid[:, None])
        with obs.span("serve.synth"):
            b = request_batch(mb.indices, r, num_dense, device,
                              dense_seed=20_000)
            valid = torch.from_numpy(mb.valid).to(device)[:, None]
        with torch.inference_mode():
            with obs.span("serve.lookup") as sp:
                hot = server.packed
                gidx = E.globalize(b["indices"], spec)
                rows = combine_rows(hot, sb.hot_local, sb.stage_slot,
                                    sb.staging, lfn)
                emb, hits = cache_select(server.cache, gidx, rows, valid)
                out = model.head(params, emb, b)
                sp.sync(out)
            if audit is not None:
                served.update(hot=hot, sb=sb, gidx=gidx, emb=emb)
            with obs.span("serve.combine"):
                server.observe(gidx, int(hits), valid=valid, count=mb.count,
                               lookups=int(mb.valid.sum()) * gidx.shape[1])
        return out

    def after(retiered: bool) -> None:
        if not retiered:
            audit(served["hot"], served["sb"], served["gidx"], served["emb"])
        served.clear()

    cards = np.asarray(spec.cardinalities, np.int64)
    result = run_microbatched_loop(
        server, serve_fn,
        lambda r: drifting_zipf_batch(cards, 1, r, requests, a=a,
                                      drift=drift, seed=seed)[0],
        requests, serve_batch, after=None if audit is None else after)
    hier = server.hier
    lookups = max(server.stats.lookups, 1)
    hstats = hier.stats.as_dict()
    hstats["hier_miss_rate"] = round(
        (hier.stats.warm_hits + hier.stats.cold_hits) / lookups, 4)
    hstats.update(hier.counts())
    return result._replace(stats={**result.stats, **hstats})


def stream_bytes_per_request(tiers, spec, requests: int, drift: float = 4.0,
                             a: float = 1.2, seed: int = 0) -> dict:
    """Mean bytes per single-user request over the drifting-zipf stream,
    against a fixed per-row tier vector ``tiers`` (V,): fp32 bytes and
    packed bytes (payload + scale + indirection word a row, as
    ``repro/core/tiers.py::row_bytes`` counts them)."""
    cards = np.asarray(spec.cardinalities, np.int64)
    idx = np.stack([drifting_zipf_batch(cards, 1, r, requests, a=a,
                                        drift=drift, seed=seed)[0]
                    for r in range(requests)])              # (R, F)
    gidx = idx.astype(np.int64) + np.asarray(spec.offsets(),
                                             np.int64)[None, :]
    t = (tiers.cpu().numpy() if isinstance(tiers, torch.Tensor)
         else np.asarray(tiers))
    per_row = np.array([spec.dim + 8, 2 * spec.dim + 8, 4 * spec.dim + 4],
                       np.int64)
    packed_bytes = int(per_row[t[gidx.reshape(-1)].astype(np.int64)].sum())
    return {"bytes_per_request_fp32": int(gidx.size * spec.dim * 4
                                          // requests),
            "bytes_per_request_packed": packed_bytes // requests}
