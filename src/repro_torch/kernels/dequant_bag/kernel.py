"""The CUDA dequant-bag kernels bound to PyTorch.

``dequant_bag_cuda`` (``csrc/dequant_bag.cu``) replaces
``repro/kernels/dequant_bag/kernel.py::dequant_bag_pallas`` on one
payload; ``dequant_bag_tiered_cuda`` (the same source) runs it over a
packed store's three tiers in one launch, what the reference's
``packed_bag_lookup`` computes with one kernel call a tier (with a shard
window, over one shard of a row-sharded store: the reference's
``_local_bags_fused``);
``bag_grad_cuda`` (``csrc/bag_grad.cu``) replaces ``bag_grad_pallas``,
its scatter-add backward.  ``dequant_bag_rowgrid_cuda``
(``csrc/dequant_bag_rowgrid.cu``) and ``bag_grad_rowgrid_cuda``
(``csrc/bag_grad_rowgrid.cu``) replace ``dequant_bag_pallas_rowgrid`` and
``bag_grad_pallas_rowgrid``, the reference's (B, K)-grid tiling oracles
of the two, each in a Hopper design of its own (vector loads a lane
group a bag; a stable partition of the slots by row mod P and warp
chains over 32-slot windows); no entry point runs them, tests and
``chip_smoke.py`` hold the tiled kernels to them.  ``plan_slots`` is the grouping ``bag_grad_cuda``
accumulates by (the stable sort of the flat indices); a caller that
scatters over the same indices many times makes it once and passes it
back in.  Each library is built at first call
(``kernels.build``) and loaded with ``ctypes``; a launch goes on
PyTorch's current stream and does not synchronise.  ``launches`` counts
the dequant-bag launches this process made, by payload dtype (each dtype
is its own instantiation of the kernel) and, under ``tiered``, the
packed store's one-launch entry; ``bag_grad_launches`` the
backward's and ``rowgrid_launches`` the two oracles', so a run can show
which kernels its path went through.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

_DTYPE_CODE = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2,
               torch.float16: 3}

launches = {**{str(dt).removeprefix("torch."): 0 for dt in _DTYPE_CODE},
            "tiered": 0}
bag_grad_launches = {"float32": 0}
# runs of more slots than this take bag_grad's block-a-run path
HEAVY_RUN = 256
rowgrid_launches = {"dequant_bag_rowgrid": 0, "bag_grad_rowgrid": 0}


def reset_launches() -> None:
    for counts in (launches, bag_grad_launches, rowgrid_launches):
        for key in counts:
            counts[key] = 0


def total_launches() -> int:
    return sum(launches.values())


@functools.cache
def _launcher():
    fn = build.load("dequant_bag").dequant_bag_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, i, p, p, p, p, ll, i, ll, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


# The single-tier entry's tiling (block_b, block_d): bags and columns a
# block of 256 lanes, 4 columns a lane.  block_d = 4 * lanes a bag group
# (1 to 256 lanes), block_b = nb * (256 // lanes), nb the bags a group
# walks at once: 1, 2 or 4 at K = 1, 1 or 2 at K > 1.  (0, 0) is the
# analytic pick.  Every tiling gives each output element one lane's FMA
# chain over k in order, so all of them are bit-equal.
THREADS = 256
COLS = 4
H100_SMS = 132          # the plain versions' stand-in for the card's SMs


@functools.cache
def _tiling_fn(lib: str, name: str, *argtypes):
    fn = getattr(build.load(lib), name)
    fn.argtypes = [*argtypes, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


def _tiling_query(lib: str, name: str, *args) -> tuple[int, int]:
    """A C entry's analytic tiling, ``name(*args, int out[2])``; args are
    ctypes scalars (their types are the entry's argtypes)."""
    out = (ctypes.c_int * 2)()
    rc = _tiling_fn(lib, name, *(type(a) for a in args))(*args, out)
    if rc != 0:
        raise RuntimeError(f"{name}{args}: cudaError {rc}")
    return int(out[0]), int(out[1])


def dequant_bag_analytic(b: int, k: int, d: int,
                         device: torch.device | None = None
                         ) -> tuple[int, int]:
    """The single-tier entry's analytic tiling at (B, K, D): on CUDA the
    kernel's own rule for ``device`` (``dequant_bag_tiling``); elsewhere
    its mirror for an H100's 132 SMs."""
    if device is not None and torch.device(device).type == "cuda":
        with torch.cuda.device(device):
            return _tiling_query("dequant_bag", "dequant_bag_tiling",
                                 ctypes.c_longlong(b), ctypes.c_int(k),
                                 ctypes.c_longlong(d))
    lanes = min(-(-d // COLS), THREADS)
    groups = THREADS // lanes
    nb = 4 if k == 1 and -(-b // (groups * 4)) >= 2 * H100_SMS else 1
    return nb * groups, lanes * COLS


def dequant_bag_tilings(b: int, k: int, d: int) -> list[tuple[int, int]]:
    """The single-tier entry's built tilings near its analytic lanes (that
    many, half and a quarter), each with every built ``nb``."""
    lanes = min(-(-d // COLS), THREADS)
    out = []
    for ln in sorted({lanes, max(1, lanes // 2), max(1, lanes // 4)}):
        for nb in ((1, 2, 4) if k == 1 else (1, 2)):
            out.append((nb * (THREADS // ln), ln * COLS))
    return out


def _check(name: str, t: torch.Tensor, dtype, ndim: int,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype or t.dim() != ndim:
        raise TypeError(f"{name} must be a {ndim}-d {dtype} tensor, got "
                        f"{t.dim()}-d {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_bag_inputs(fn: str, payload: torch.Tensor,
                      scales: torch.Tensor | None, indices: torch.Tensor,
                      weights: torch.Tensor) -> None:
    dev = payload.device
    if payload.dtype not in _DTYPE_CODE:
        raise TypeError("payload must be int8, bfloat16, float16 or "
                        "float32, got "
                        f"{payload.dtype}")
    _check("payload", payload, payload.dtype, 2, dev)
    _check("indices", indices, torch.int32, 2, dev)
    _check("weights", weights, torch.float32, 2, dev)
    if weights.shape != indices.shape:
        raise ValueError(f"weights {tuple(weights.shape)} != indices "
                         f"{tuple(indices.shape)}")
    if scales is not None:
        _check("scales", scales, torch.float32, 1, dev)
        if scales.shape[0] != payload.shape[0]:
            raise ValueError(f"scales has {scales.shape[0]} rows, payload "
                             f"{payload.shape[0]}")
    if dev.type != "cuda":           # last, so the CPU tests reach the rest
        raise ValueError(f"{fn} needs CUDA tensors, got {dev}")


def dequant_bag_cuda(payload: torch.Tensor, scales: torch.Tensor | None,
                     indices: torch.Tensor, weights: torch.Tensor,
                     tiling: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Launch the kernel: payload (V, D) int8|bf16|fp16|fp32, scales (V,) fp32
    or None, indices (B, K) int32 in [0, V), weights (B, K) fp32 -> (B, D)
    fp32, at ``tiling`` ((0, 0): the analytic pick; an unbuilt tiling
    raises).  All on one CUDA device and contiguous; raises otherwise."""
    _check_bag_inputs("dequant_bag_cuda", payload, scales, indices, weights)
    dev = payload.device
    b, k = indices.shape
    d = payload.shape[1]
    out = torch.empty((b, d), dtype=torch.float32, device=dev)
    if b == 0 or d == 0:
        return out
    itemsize = payload.element_size()
    vec = 16 // itemsize if ((d * itemsize) % 16 == 0
                             and payload.data_ptr() % 16 == 0) else 1
    launch = _launcher()
    with torch.cuda.device(dev):
        rc = launch(
            payload.data_ptr(), _DTYPE_CODE[payload.dtype],
            None if scales is None else scales.data_ptr(),
            indices.data_ptr(), weights.data_ptr(), out.data_ptr(),
            b, k, d, vec, int(tiling[0]), int(tiling[1]),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dequant_bag launch failed: cudaError {rc} "
                           f"(B={b}, K={k}, D={d}, {payload.dtype}, tiling "
                           f"{tuple(tiling)})")
    launches[str(payload.dtype).removeprefix("torch.")] += 1
    return out


@functools.cache
def _tiered_launcher():
    fn = build.load("dequant_bag").dequant_bag_tiered_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, ll, ll, p, i, p, ll, ll, p, ll, ll, p, i, p, p,
                   ll, i, ll, p]
    fn.restype = ctypes.c_int
    return fn


def dequant_bag_tiered_cuda(indirect: torch.Tensor, payload8: torch.Tensor,
                            scale8: torch.Tensor, payload16: torch.Tensor,
                            scale16: torch.Tensor, payload32: torch.Tensor,
                            ids: torch.Tensor,
                            weights: torch.Tensor | None = None,
                            firsts: tuple[int, int, int] = (0, 0, 0)
                            ) -> torch.Tensor:
    """Launch the tiered entry over a packed store's leaves: indirect (V,)
    int32 (tier << 28 | local row), payload8 (V8, D) int8 + scale8 (V8,),
    payload16 (V16, D) bf16 or fp16 + scale16 (V16,), payload32 (V32, D)
    fp32, ids (B, K) int32 or int64 in [0, V), weights (B, K) fp32 or
    None (ones) -> (B, D) fp32.  All on one CUDA device and contiguous;
    raises otherwise.

    ``firsts`` (the int8, half and fp32 tiers' first local rows) is the
    shard window: each payload and scale holds local rows ``[first, first
    + rows)`` of its tier (``rows`` may be 0), and a slot outside its
    tier's window weighs 0 and reads nothing.  A whole store is the window
    ``(0, 0, 0)``, the default.
    """
    if len(firsts) != 3 or min(firsts) < 0:
        raise ValueError(f"firsts must be three rows >= 0, got {firsts}")
    dev = indirect.device
    if dev.type != "cuda":
        raise ValueError(f"dequant_bag_tiered_cuda needs CUDA tensors, got "
                         f"{dev}")
    _check("indirect", indirect, torch.int32, 1, dev)
    _check("payload8", payload8, torch.int8, 2, dev)
    if payload16.dtype not in (torch.bfloat16, torch.float16):
        raise TypeError(f"payload16 must be bfloat16 or float16, got "
                        f"{payload16.dtype}")
    _check("payload16", payload16, payload16.dtype, 2, dev)
    _check("payload32", payload32, torch.float32, 2, dev)
    d = payload32.shape[1]
    for name, payload, scale in (("8", payload8, scale8),
                                 ("16", payload16, scale16)):
        _check(f"scale{name}", scale, torch.float32, 1, dev)
        if payload.shape[1] != d or scale.shape[0] != payload.shape[0]:
            raise ValueError(f"payload{name} {tuple(payload.shape)} / "
                             f"scale{name} {tuple(scale.shape)} do not match "
                             f"D = {d}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"ids must be int32 or int64, got {ids.dtype}")
    _check("ids", ids, ids.dtype, 2, dev)
    if weights is not None:
        _check("weights", weights, torch.float32, 2, dev)
        if weights.shape != ids.shape:
            raise ValueError(f"weights {tuple(weights.shape)} != ids "
                             f"{tuple(ids.shape)}")
    b, k = ids.shape
    out = torch.empty((b, d), dtype=torch.float32, device=dev)
    if b == 0 or d == 0:
        return out
    f8, f16, f32 = (int(f) for f in firsts)
    with torch.cuda.device(dev):
        rc = _tiered_launcher()(
            indirect.data_ptr(), payload8.data_ptr(), scale8.data_ptr(), f8,
            payload8.shape[0], payload16.data_ptr(),
            _DTYPE_CODE[payload16.dtype], scale16.data_ptr(), f16,
            payload16.shape[0], payload32.data_ptr(), f32,
            payload32.shape[0], ids.data_ptr(),
            int(ids.dtype == torch.int64),
            None if weights is None else weights.data_ptr(), out.data_ptr(),
            b, k, d, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dequant_bag_tiered launch failed: cudaError {rc} "
                           f"(B={b}, K={k}, D={d})")
    launches["tiered"] += 1
    return out


def _check_grad_inputs(fn: str, g: torch.Tensor, indices: torch.Tensor,
                       coeff: torch.Tensor, out: torch.Tensor) -> None:
    dev = g.device
    _check("g", g, torch.float32, 2, dev)
    _check("indices", indices, torch.int32, 2, dev)
    _check("coeff", coeff, torch.float32, 2, dev)
    _check("out", out, torch.float32, 2, dev)
    if coeff.shape != indices.shape or indices.shape[0] != g.shape[0]:
        raise ValueError(f"indices {tuple(indices.shape)}, coeff "
                         f"{tuple(coeff.shape)} and g {tuple(g.shape)} "
                         "disagree")
    if out.shape[1] != g.shape[1]:
        raise ValueError(f"out has {out.shape[1]} columns, g {g.shape[1]}")
    if dev.type != "cuda":           # last, so the CPU tests reach the rest
        raise ValueError(f"{fn} needs CUDA tensors, got {dev}")


@functools.cache
def _grad_launcher():
    fn = build.load("bag_grad").bag_grad_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, p, ll, i, ll, i, i, p, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


# bag_grad's tiling (block_b, block_d) is its light rows' (runs of at most
# HEAVY_RUN slots): G lanes a group, block_b = 32 // G runs a warp takes
# at once (1, 2 or 4), and VEC columns a lane (1, 2 or 4, at most the
# access width g and out allow), block_d = G * VEC columns a group pass.
# The heavy runs' blocks keep their own.  Each row keeps one owner lane a
# column, chaining its run in sorted order, so all tilings are bit-equal.


def access_width(d: int, *tensors: torch.Tensor) -> int:
    """The widest fp32 vector (4, 2 or 1) that D and every tensor's
    address allow."""
    return next(v for v in (4, 2, 1)
                if d % v == 0 and all(t.data_ptr() % (4 * v) == 0
                                      for t in tensors))


def bag_grad_analytic(d: int, vec: int | None = None,
                      device: torch.device | None = None) -> tuple[int, int]:
    """The light rows' analytic tiling at D for access width ``vec``
    (default: D's own, 4, 2 or 1): on CUDA the kernel's own rule
    (``bag_grad_tiling``), elsewhere its mirror."""
    vec = vec or next(v for v in (4, 2, 1) if d % v == 0)
    if device is not None and torch.device(device).type == "cuda":
        with torch.cuda.device(device):
            return _tiling_query("bag_grad", "bag_grad_tiling",
                                 ctypes.c_int(vec), ctypes.c_longlong(d))
    if d >= 32:
        p1, p2, p4 = -(-d // 32), -(-d // 64), -(-d // 128)
        v = 4 if vec == 4 and p4 < p2 else 2 if vec >= 2 and p2 < p1 else 1
        return 1, 32 * v
    g = 32 if d > 16 else 16 if d > 8 else 8
    return 32 // g, g


def bag_grad_tilings(d: int, vec: int | None = None
                     ) -> list[tuple[int, int]]:
    """Every built light tiling at D for access width ``vec``."""
    vec = vec or next(v for v in (4, 2, 1) if d % v == 0)
    return [(32 // g, g * v) for g in (32, 16, 8) for v in (1, 2, 4)
            if v <= vec]


def bag_grad_tiling_ok(tiling: tuple[int, int], vec: int) -> bool:
    """Whether ``tiling`` is (0, 0) or built for access width ``vec``."""
    bb, bd = tiling
    if (bb, bd) == (0, 0):
        return True
    if bb not in (1, 2, 4) or bd % (32 // bb):
        return False
    return bd // (32 // bb) in (1, 2, 4) and bd // (32 // bb) <= vec


class SlotPlan(NamedTuple):
    """The slots of a (B, K) index array grouped by row: ``rows`` the flat
    indices sorted stably (int32), ``slots`` their flat positions ``b * K +
    k`` (int64, the sort's permutation), so each row's slots stay in (b,
    k) order."""
    rows: torch.Tensor
    slots: torch.Tensor


def plan_slots(indices: torch.Tensor) -> SlotPlan:
    """The grouping ``bag_grad_cuda`` accumulates by, on ``indices``'
    device: one stable sort of the flat indices."""
    rows, slots = torch.sort(indices.to(torch.int32).reshape(-1),
                             stable=True)
    return SlotPlan(rows, slots)


def _check_plan(plan: SlotPlan, n: int, device: torch.device) -> None:
    _check("plan.rows", plan.rows, torch.int32, 1, device)
    _check("plan.slots", plan.slots, torch.int64, 1, device)
    if plan.rows.shape[0] != n or plan.slots.shape[0] != n:
        raise ValueError(f"plan has {plan.rows.shape[0]} rows and "
                         f"{plan.slots.shape[0]} slots, the indices {n}")


def bag_grad_cuda(g: torch.Tensor, indices: torch.Tensor,
                  coeff: torch.Tensor, out: torch.Tensor,
                  plan: SlotPlan | None = None,
                  accumulate: bool = False,
                  tiling: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Launch the scatter-add backward into ``out`` and return it.

    g (B, D) fp32, indices (B, K) int32 in [0, V), coeff (B, K) fp32,
    out (V, D) fp32 and zero on entry (the caller's zero fill, the
    reference's aliased zeros operand): every touched row of ``out`` is
    overwritten with its (b, k)-ordered FMA sum.  With ``accumulate`` each
    touched row's FMA chain starts from its value in ``out`` instead of 0,
    so consecutive calls over consecutive runs of bags sum each row as one
    call over all of them does, bit for bit.  All on one CUDA device
    and contiguous; raises otherwise.  The slots are grouped by row with
    one stable sort here, unless ``plan`` (``plan_slots(indices)``, made
    once by a caller that scatters over the same indices again) is given;
    the kernel does the accumulation.  Nothing here waits on the device.
    ``tiling`` is the light rows' ((0, 0): the analytic pick; one not
    built for this launch's access width raises).
    """
    _check_grad_inputs("bag_grad_cuda", g, indices, coeff, out)
    dev = g.device
    b, k = indices.shape
    d = g.shape[1]
    n = b * k
    if n == 0 or d == 0:
        return out
    if n >= 2**31 - 1:
        raise ValueError(f"bag_grad_cuda takes fewer than 2**31 - 1 slots, "
                         f"got {n}")
    if plan is None:
        plan = plan_slots(indices)
    else:
        _check_plan(plan, n, dev)
    vec = access_width(d, g, out)
    if not bag_grad_tiling_ok(tiling, vec):
        raise ValueError(f"bag_grad tiling {tuple(tiling)} is not built for "
                         f"access width {vec}")
    # the heavy-run list: 4 counters, then room for every run that can be
    # longer than HEAVY_RUN
    cap = n // (HEAVY_RUN + 1) + 1
    scratch = torch.empty(4 + cap, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _grad_launcher()(
            g.data_ptr(), plan.rows.data_ptr(), plan.slots.data_ptr(),
            coeff.data_ptr(), out.data_ptr(), n, k, d, vec, HEAVY_RUN,
            scratch.data_ptr(), cap, int(accumulate), int(tiling[0]),
            int(tiling[1]), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bag_grad launch failed: cudaError {rc} "
                           f"(B={b}, K={k}, D={d}, V={out.shape[0]})")
    bag_grad_launches["float32"] += 1
    return out


@functools.cache
def _rowgrid_launcher():
    fn = build.load("dequant_bag_rowgrid").dequant_bag_rowgrid_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, i, p, p, p, p, ll, i, ll, p]
    fn.restype = ctypes.c_int
    return fn


def dequant_bag_rowgrid_cuda(payload: torch.Tensor,
                             scales: torch.Tensor | None,
                             indices: torch.Tensor, weights: torch.Tensor
                             ) -> torch.Tensor:
    """Launch the (B, K)-grid oracle: the inputs and output of
    ``dequant_bag_cuda``; every slot is read, zero weights included."""
    _check_bag_inputs("dequant_bag_rowgrid_cuda", payload, scales, indices,
                      weights)
    dev = payload.device
    b, k = indices.shape
    d = payload.shape[1]
    out = torch.empty((b, d), dtype=torch.float32, device=dev)
    if b == 0 or d == 0:
        return out
    with torch.cuda.device(dev):
        rc = _rowgrid_launcher()(
            payload.data_ptr(), _DTYPE_CODE[payload.dtype],
            None if scales is None else scales.data_ptr(),
            indices.data_ptr(), weights.data_ptr(), out.data_ptr(), b, k, d,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dequant_bag_rowgrid launch failed: cudaError "
                           f"{rc} (B={b}, K={k}, D={d}, {payload.dtype})")
    rowgrid_launches["dequant_bag_rowgrid"] += 1
    return out


# bag_grad_rowgrid's pass 1 cuts the slots into tiles of ROWGRID_TILE and
# partitions the live ones into rowgrid_buckets(n) buckets by row mod P
# (csrc/bag_grad_rowgrid.cu); its scratch holds the plan, the per-tile
# counts and each slot's row, bag and coefficient.
ROWGRID_TILE = 4096
ROWGRID_MAX_BUCKETS = 4096
ROWGRID_META = 4


def rowgrid_buckets(n: int) -> int:
    """P for a scatter of ``n`` slots: a power of two near one bucket a
    32-slot window, at most 4,096 (the pass-1 tile's shared histogram)."""
    p = 1
    while p < ROWGRID_MAX_BUCKETS and p * 32 < n:
        p *= 2
    return p


def rowgrid_scratch_words(n: int, buckets: int) -> int:
    """int32 words of ``bag_grad_rowgrid_cuda``'s scratch (the C entry's
    ``scratch_words``, which refuses less): the meta words, three per
    bucket (live slots, first place, the job list), a count a bucket a
    tile, and three a slot (its row, bag and coefficient in bucket
    order)."""
    tiles = -(-n // ROWGRID_TILE)
    return ROWGRID_META + 3 * buckets + tiles * buckets + 3 * n


@functools.cache
def _grad_rowgrid_launcher():
    fn = build.load("bag_grad_rowgrid").bag_grad_rowgrid_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, ll, i, ll, i, p, ll, p]
    fn.restype = ctypes.c_int
    return fn


def bag_grad_rowgrid_cuda(g: torch.Tensor, indices: torch.Tensor,
                          coeff: torch.Tensor, out: torch.Tensor
                          ) -> torch.Tensor:
    """Launch the (B, K)-grid scatter oracle into ``out`` and return it:
    the inputs and contract of ``bag_grad_cuda`` (``out`` zero on entry;
    each touched row's chain starts from its value there), without the
    sort by row: the kernel partitions the slots by row mod P, keeping
    their (b, k) order, and chains each bucket's rows window by window.
    The scratch (``rowgrid_scratch_words``) is allocated here."""
    _check_grad_inputs("bag_grad_rowgrid_cuda", g, indices, coeff, out)
    dev = g.device
    b, k = indices.shape
    d = g.shape[1]
    n = b * k
    if n == 0 or d == 0:
        return out
    if n >= 2**31 - 1:
        raise ValueError(f"bag_grad_rowgrid_cuda takes fewer than 2**31 - 1 "
                         f"slots, got {n}")
    buckets = rowgrid_buckets(n)
    words = rowgrid_scratch_words(n, buckets)
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _grad_rowgrid_launcher()(
            g.data_ptr(), indices.data_ptr(), coeff.data_ptr(),
            out.data_ptr(), n, k, d, buckets, scratch.data_ptr(), words,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bag_grad_rowgrid launch failed: cudaError {rc} "
                           f"(B={b}, K={k}, D={d}, V={out.shape[0]})")
    rowgrid_launches["bag_grad_rowgrid"] += 1
    return out
