"""Adversarial inputs for the card checks of ``bag_grad``, ``bag_matmul``,
``cin``, ``rowwise_quant``, ``dequant_bag`` and ``hashed_gather``.

``chip_smoke.py`` (phase 2) and ``tests/test_torch_cuda.py`` hold the
kernels to their plain versions on these, bit for bit.  The inputs are
drawn from a ``torch.Generator`` on the given device, so both callers see
the same numbers; nothing here launches a kernel.

``bag_grad_cases`` aims at the scatter's schedule: one row holding every
slot; runs of exactly ``heavy`` slots (the longest a group of lanes
walks) and one either side, and of 16 * ``heavy`` (the longest that is not
listed first) and one more; a long run with zero coefficients and a NaN
cotangent under them (the zeros must be skipped); D in {1, 8, 10, 33, 64,
128, 200} with ``g`` and ``out`` a float off 16-byte alignment.  And at
the (B, K)-grid oracle's (rows a multiple of ``BUCKET_STRIDE`` apart
share its bucket): one row's 65,536 slots beside rows of its bucket and
others; every slot in one bucket; 32-slot windows written out (a row
twice in a window, across a window's edge, absent from one window and
back in the next, a window of one row); runs of rows sharing a bucket at
K = 3 with 20% zero coefficients; and B = 0.
``bag_matmul_cases`` covers B in {1, 31, 512, 513}, K in {1, 39, 40}, D
in {1, 10, 32, 384} and H in {1, 63, 400, 1024}, and all-dead fields
with a NaN in ``w3`` under a dead slot (every slot is multiplied, so the
NaN reaches its column).
``cin_cases`` aims at the CIN kernel's 200 (o) x 40 (n) tiles and
32-deep k chunks: O of 17 (one partial o tile), 200 (one full tile), 201
(a second tile of one row) and 400 (two full tiles); a sample's columns
split across n tiles (D = 6, as 40 is no multiple of 6, and D = 128,
which spans four tiles; D = 10 divides 40, so its samples never
straddle); H * M of 72 (9 x 8), 1,521 and 7,800 (ragged last chunks);
H = M = 1; W one float off 16-byte alignment at H * M = 72 (a multiple
of 4, so only the pointer sends it to the shifted W reads); and a NaN in
W (its output channel NaN in both).
``quant_cases`` aims at the quantizer's vector, scalar and wide-row
paths: D in {64, 32, 10, 8, 3, 68, 133} at V = 1001 (no block's rows
divide it), each with an all-zero row (the 1e-12 floor), a row of exact
.5 multiples of its scale (half to even), and NaN, inf and all -inf rows
beside finite rows of the same warp step; and x or noise one float off
16-byte alignment (views a caller can pass), which take the scalar path.
``gather_cases`` aims at the dequant-bag kernel's lane groups (4 columns
a lane, ceil(D / 4) lanes a bag), its windows (4 bags at K = 1, 8 slots
at K > 1) and its load widths: every payload dtype at D 1/10/32/33/64/128
(a lane's last columns partial at D 1, 10 and 33, rows off 16-byte
alignment at D 10 and 33), K 1/8/40, B of 61, 37 and 64 (no block of 64
bags divides the first two), 30% zero weights and a NaN row (a NaN scale
for int8) under zero weights only (the bag stays finite); payload views
one element off 16-byte alignment at D 64 and 10; and, on the card, an
int8 payload over 2.1 GB with slots in rows whose byte offset passes
2^31.  ``tiered_cases`` holds the tiered entry: three live tiers at K = 1
(int32 and int64 ids), weighted K = 8 and K = 40 bags with zero weights,
fp16 half tiers, D 10 and 33, an empty int8 and an empty fp32 tier (the
one-row placeholder), and a NaN and an inf weight (their bags NaN).
``window_cases`` holds its shard window entry: stores cut into 2, 3 or 4
row shards at the reference's stride ``ceil(V_t / n)``, so windows cut
every tier; a one-row last shard and empty last windows (a tier of 9
rows over 4 shards: 3, 3, 3, 0); an empty int8 tier whose placeholder
row only the first shard holds; int32 and int64 ids; K 1, 8 and 40; and
NaN and inf weights, each on a slot outside all windows but one (the
bag is NaN in every shard, as the reference's ``mine * w``).
``hashed_cases`` covers Z 4/5/8, T = K * NH of 1, 2 and 6, int8 and fp32
pools of S rows that are no power of two, seeds 0 and 7, weighted K = 3
bags with zero weights, and int64 ids past 2^32 (their low 32 bits are
hashed); the ids entry is held to the plan entry on each.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


# rows this far apart share a bucket of the (B, K)-grid scatter oracle
# (kernels/dequant_bag/kernel.py: at most ROWGRID_MAX_BUCKETS buckets)
BUCKET_STRIDE = 4096


class GradCase(NamedTuple):
    name: str
    g: torch.Tensor          # (B, D) fp32
    indices: torch.Tensor    # (B, K) int32
    coeff: torch.Tensor      # (B, K) fp32
    vocab: int
    out: torch.Tensor        # (vocab, D) fp32 zeros, maybe misaligned


def _off_aligned(shape, device) -> torch.Tensor:
    """Zeros of ``shape``, contiguous, one float past 16-byte alignment."""
    n = math.prod(shape)
    return torch.zeros(n + 1, device=device)[1:].view(shape)


def _runs(lengths, k: int, gen, device) -> torch.Tensor:
    """(B, K) int32 indices in which row r holds ``lengths[r]`` slots, the
    slots of all rows shuffled together; B * K = sum(lengths)."""
    rows = torch.repeat_interleave(
        torch.arange(len(lengths), device=device),
        torch.tensor(lengths, device=device))
    perm = torch.randperm(rows.numel(), generator=gen, device=device)
    return rows[perm].to(torch.int32).reshape(-1, k)


def bag_grad_cases(device, heavy: int) -> list[GradCase]:
    gen = torch.Generator(device=device)
    gen.manual_seed(16)
    cases = []

    def add(name, idx, d, vocab, coeff=None, misaligned=False):
        b, k = idx.shape
        g = torch.randn((b, d), generator=gen, device=device)
        if misaligned:
            g = _off_aligned((b, d), device).copy_(g)
        if coeff is None:
            coeff = torch.rand((b, k), generator=gen, device=device) + 0.5
        out = (_off_aligned((vocab, d), device) if misaligned else
               torch.zeros((vocab, d), device=device))
        cases.append(GradCase(name, g, idx, coeff, vocab, out))

    # one row holds all 65,536 slots
    add("one_row", torch.full((65_536, 1), 3, dtype=torch.int32,
                              device=device), 64, 7,
        coeff=torch.ones((65_536, 1), device=device))
    # runs at the group / block boundary and at the front-list boundary,
    # among short ones
    big = 16 * heavy
    lengths = [heavy - 1, heavy, heavy + 1, big, big + 1, 1, 2, 3, 31, 32,
               33, 64]
    lengths.append(sum(lengths) % 2 or 2)           # an even slot count
    for d in (64, 8):
        add(f"threshold_d{d}", _runs(lengths, 2, gen, device), d,
            len(lengths))
    # a long run with 30% zero coefficients; one bag's cotangent is NaN
    # and both its coefficients are zero
    idx = _runs([3000, 500, 7, 1, 300], 2, gen, device)
    b = idx.shape[0]
    coeff = torch.rand((b, 2), generator=gen, device=device) + 0.5
    coeff[torch.rand((b, 2), generator=gen, device=device) < 0.3] = 0.0
    hot = int(torch.nonzero(idx[:, 0] == 0)[0])
    coeff[hot] = 0.0
    add("zeros_nan", idx, 64, 5, coeff=coeff)
    cases[-1].g[hot] = float("nan")
    # widths, with g and out off 16-byte alignment
    for d in (1, 8, 10, 33, 64, 128, 200):
        lengths = [1000, heavy + 1, heavy] + [1 + i % 7 for i in range(400)]
        lengths.append(sum(lengths) % 2)
        add(f"misaligned_d{d}", _runs([x for x in lengths if x], 2, gen,
                                      device), d, len(lengths),
            misaligned=True)
    # The (B, K)-grid oracle's schedule: rows that are multiples of
    # BUCKET_STRIDE share its bucket (row mod P, P a power of two dividing
    # it).  One row's 65,536 slots beside 8,192 slots of 32 rows of its
    # bucket and 8,192 over 4,000 other rows, all shuffled together
    ids = torch.cat([torch.arange(33, device=device) * BUCKET_STRIDE,
                     torch.arange(1, 4001, device=device)])
    lengths = [65_536] + [256] * 32 + [2] * 4000 + [192]
    ids = torch.cat([ids, torch.tensor([4001], device=device)])
    add("hot_bucket", ids[_runs(lengths, 1, gen, device).long()].to(
        torch.int32), 64, 32 * BUCKET_STRIDE + 1)
    # every slot in one bucket: 64 rows of 128 slots, shuffled, so every
    # 32-slot window repeats rows and rows leave and come back
    ids = torch.arange(64, device=device) * BUCKET_STRIDE
    add("one_bucket", ids[_runs([128] * 64, 2, gen, device).long()].to(
        torch.int32), 8, 63 * BUCKET_STRIDE + 1)
    # windows written out (rows A-H of one bucket, K = 1, every slot
    # live): a row twice inside a window; the same row at places 31 and 32
    # (a window's edge); a row in windows 0 and 2 but not 1; a window of
    # one row carried on from the last; then all eight rows in turn
    a, bb, c, d_, e, f, g_, h = range(1, 9)
    order = ([a, bb, a, c, d_] * 6 + [d_, e]
             + [e] + [f, g_, f, e] * 7 + [bb, bb, h]
             + [a] * 16 + [c, h] * 8
             + [h] * 32
             + [a, bb, c, d_, e, f, g_, h] * 4)
    idx = (torch.tensor(order, dtype=torch.int32, device=device)
           * BUCKET_STRIDE).reshape(-1, 1)
    for d in (33, 64):
        add(f"window_edges_d{d}", idx, d, 8 * BUCKET_STRIDE + 1)
    # runs of rows sharing a bucket, in order (not shuffled), K = 3, 20%
    # zero coefficients (dead slots shift the windows)
    lengths = [1 + (7 * i) % 40 for i in range(90)]
    lengths.append(-sum(lengths) % 3 or 3)
    rows = torch.repeat_interleave(
        torch.arange(len(lengths), device=device) % 6,
        torch.tensor(lengths, device=device))
    idx = (rows * BUCKET_STRIDE).to(torch.int32).reshape(-1, 3)
    coeff = torch.rand(idx.shape, generator=gen, device=device) + 0.5
    coeff[torch.rand(idx.shape, generator=gen, device=device) < 0.2] = 0.0
    add("shared_runs_k3", idx, 10, 5 * BUCKET_STRIDE + 1, coeff=coeff)
    # no bags at all
    add("empty", torch.zeros((0, 2), dtype=torch.int32, device=device), 64,
        10)
    return cases


class MatmulCase(NamedTuple):
    name: str
    payload: torch.Tensor     # (V, D)
    scales: torch.Tensor      # (V,) fp32
    indices: torch.Tensor     # (B, K) int32
    weights: torch.Tensor     # (B, K) fp32
    w3: torch.Tensor          # (K, D, H) fp32


# (B, K, D, H): every B, K, D and H of the docstring at least twice
MATMUL_SHAPES = ((1, 1, 1, 1), (31, 39, 10, 63), (512, 40, 32, 1024),
                 (513, 39, 10, 400), (513, 1, 384, 1024), (31, 40, 384, 1),
                 (1, 39, 32, 400), (512, 1, 1, 63))


def _payload(dtype, v, d, gen, device) -> torch.Tensor:
    if dtype == torch.int8:
        return torch.randint(-128, 128, (v, d), generator=gen, device=device,
                             dtype=torch.int8)
    return (torch.randn((v, d), generator=gen, device=device) * 0.1
            ).to(dtype)


def bag_matmul_cases(device, dtype) -> list[MatmulCase]:
    gen = torch.Generator(device=device)
    gen.manual_seed(17)
    v = 999
    cases = []
    for b, k, d, h in MATMUL_SHAPES:
        idx = torch.randint(0, v, (b, k), generator=gen, device=device,
                            dtype=torch.int32)
        w = torch.rand((b, k), generator=gen, device=device)
        w[torch.rand((b, k), generator=gen, device=device) < 0.3] = 0.0
        cases.append(MatmulCase(
            f"b{b}_k{k}_d{d}_h{h}", _payload(dtype, v, d, gen, device),
            torch.rand(v, generator=gen, device=device) * 0.01, idx, w,
            torch.randn((k, d, h), generator=gen, device=device)))
    # fields 2 and 5 dead in every bag; a NaN in w3 under field 5
    b, k, d, h = 64, 8, 10, 70
    idx = torch.randint(0, v, (b, k), generator=gen, device=device,
                        dtype=torch.int32)
    w = torch.rand((b, k), generator=gen, device=device) + 0.5
    w[:, 2] = w[:, 5] = 0.0
    w3 = torch.randn((k, d, h), generator=gen, device=device)
    w3[5, 3, 7] = float("nan")
    cases.append(MatmulCase("dead_fields_nan_w3",
                            _payload(dtype, v, d, gen, device),
                            torch.rand(v, generator=gen, device=device)
                            * 0.01, idx, w, w3))
    return cases


class CinCase(NamedTuple):
    name: str
    w: torch.Tensor           # (O, H, M) fp32
    xk: torch.Tensor          # (B, H, D) fp32
    x0: torch.Tensor          # (B, M, D) fp32


# (B, O, H, M, D)
CIN_SHAPES = ((13, 17, 9, 8, 6),        # O < a tile, K = 72, D = 6 straddles
              (70, 200, 39, 39, 10),    # 700 columns: a last n tile of 20
              (3, 17, 200, 39, 10),     # K = 7,800: a last chunk of 24
              (5, 3, 1, 1, 128),        # H = M = 1, D = 128
              (3, 200, 1, 1, 10),       # H = M = 1, O = 200
              (2, 70, 20, 39, 128),     # D = 128: a sample over four tiles
              (7, 201, 9, 8, 10),       # a second o tile of one row
              (5, 400, 39, 39, 6))      # two full o tiles, K = 1,521
CIN_CASE_NAMES = tuple(f"b{b}_o{o}_h{h}_m{m}_d{d}"
                       for b, o, h, m, d in CIN_SHAPES) + ("w_off_k72",
                                                           "nan_w")


def cin_cases(device) -> list[CinCase]:
    gen = torch.Generator(device=device)
    gen.manual_seed(18)
    cases = []

    def add(name, b, o, h, m, d):
        w = torch.randn((o, h, m), generator=gen, device=device) / (
            h * m) ** 0.5
        xk = torch.randn((b, h, d), generator=gen, device=device)
        x0 = torch.randn((b, m, d), generator=gen, device=device)
        cases.append(CinCase(name, w, xk, x0))

    for b, o, h, m, d in CIN_SHAPES:
        add(f"b{b}_o{o}_h{h}_m{m}_d{d}", b, o, h, m, d)
    # K = 72 is a multiple of 4, but W lies one float off alignment
    add("w_off_k72", 9, 200, 9, 8, 10)
    w = cases[-1].w
    cases[-1] = cases[-1]._replace(w=_off(w))
    # a NaN in W: output channel 5 is NaN for every (b, d)
    add("nan_w", 6, 200, 39, 39, 10)
    cases[-1].w[5, 3, 7] = float("nan")
    return cases


class QuantCase(NamedTuple):
    name: str
    x: torch.Tensor           # (V, D) fp32, maybe off alignment
    noise: torch.Tensor       # (V, D) fp32 uniforms, maybe off alignment


QUANT_DIMS = (64, 32, 10, 8, 3, 68, 133)
QUANT_OFF_DIMS = (64, 8)
QUANT_CASE_NAMES = (tuple(f"d{d}" for d in QUANT_DIMS)
                    + tuple(f"{what}_off_d{d}" for d in QUANT_OFF_DIMS
                            for what in ("x", "noise")))


def _quant_rows(v: int, d: int, gen, device) -> torch.Tensor:
    x = torch.randn((v, d), generator=gen, device=device) * (
        torch.rand((v, 1), generator=gen, device=device) * 10 + 1e-3)
    x[1] = 0.0                            # the 1e-12 floor
    half = (torch.arange(d, device=device) % 9 - 4).float() + 0.5
    x[2] = half * 0.25                    # exact .5 multiples of 0.25
    x[2, 0] = 127 * 0.25
    # non-finite rows beside finite rows of the same warp step
    x[5, d // 2] = float("nan")
    x[6, d - 1] = float("inf")
    x[9] = -float("inf")
    x[10, 0] = float("nan")
    x[10, d - 1] = -float("inf")
    return x


def _off(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t``, contiguous, one float past 16-byte alignment."""
    return _off_aligned(t.shape, t.device).copy_(t)


def quant_cases(device) -> list[QuantCase]:
    gen = torch.Generator(device=device)
    gen.manual_seed(19)
    v = 1001
    cases = []
    for d in QUANT_DIMS:
        x = _quant_rows(v, d, gen, device)
        noise = torch.rand((v, d), generator=gen, device=device)
        cases.append(QuantCase(f"d{d}", x, noise))
    for d in QUANT_OFF_DIMS:
        x = _quant_rows(v, d, gen, device)
        noise = torch.rand((v, d), generator=gen, device=device)
        cases.append(QuantCase(f"x_off_d{d}", _off(x), noise))
        cases.append(QuantCase(f"noise_off_d{d}", x, _off(noise)))
    return cases



class GatherCase(NamedTuple):
    name: str
    payload: torch.Tensor     # (V, D), maybe off 16-byte alignment
    scales: torch.Tensor | None   # (V,) fp32
    indices: torch.Tensor     # (B, K) int32
    weights: torch.Tensor     # (B, K) fp32, 30% zeros


GATHER_DTYPES = (torch.int8, torch.bfloat16, torch.float16, torch.float32)
# (D, K, B): every D, K and B of the docstring
GATHER_SHAPES = ((1, 1, 61), (10, 8, 37), (32, 40, 64), (33, 1, 37),
                 (64, 8, 61), (128, 40, 37), (64, 1, 64), (10, 1, 61))
GATHER_OFF = ((64, 1, 61), (10, 8, 37))
GATHER_BIG = "int8_big_offset"
GATHER_CASE_NAMES = tuple(
    f"{str(dt).removeprefix('torch.')}_{what}d{d}_k{k}_b{b}"
    for dt in GATHER_DTYPES
    for what, shapes in (("", GATHER_SHAPES), ("off_", GATHER_OFF))
    for d, k, b in shapes)


def _bag_slots(v: int, b: int, k: int, bad: int, gen, device):
    """(B, K) int32 ids in [0, v) and fp32 weights with 30% zeros; the
    ``bad`` row is reached by zero-weight slots only."""
    idx = torch.randint(0, v, (b, k), generator=gen, device=device,
                        dtype=torch.int32)
    w = torch.rand((b, k), generator=gen, device=device) + 0.25
    w[torch.rand((b, k), generator=gen, device=device) < 0.3] = 0.0
    idx[w != 0] = torch.where(idx[w != 0] == bad, bad + 1, idx[w != 0])
    idx[::3, 0] = bad
    w[::3, 0] = 0.0
    return idx, w


def _gather_payload(dtype, v: int, d: int, gen, device, off: bool
                    ) -> torch.Tensor:
    p = _payload(dtype, v, d, gen, device)
    if not off:
        return p
    flat = torch.empty(v * d + 1, dtype=dtype, device=device)
    return flat[1:].view(v, d).copy_(p)


def gather_cases(device) -> list[GatherCase]:
    """The dequant-bag cases; the 2.1 GB one only on a CUDA device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(20)
    v, bad = 301, 7
    cases = []
    for dt in GATHER_DTYPES:
        name = str(dt).removeprefix("torch.")
        for what, shapes in (("", GATHER_SHAPES), ("off_", GATHER_OFF)):
            for n, (d, k, b) in enumerate(shapes):
                payload = _gather_payload(dt, v, d, gen, device, bool(what))
                scales = torch.rand(v, generator=gen, device=device) * 0.01
                if dt == torch.int8:
                    scales[bad] = float("nan")
                else:
                    payload[bad] = float("nan")
                if dt == torch.float32 and n % 2:
                    scales = None             # the fp32 tier: unit scales
                idx, w = _bag_slots(v, b, k, bad, gen, device)
                cases.append(GatherCase(f"{name}_{what}d{d}_k{k}_b{b}",
                                        payload, scales, idx, w))
    if torch.device(device).type == "cuda":
        # rows past 2^31 bytes: 33,556,432 rows of 64 int8
        rows = (1 << 31) // 64 + 1000
        payload = torch.zeros((rows, 64), dtype=torch.int8, device=device)
        tail = rows - 2000
        payload[tail:] = _payload(torch.int8, 2000, 64, gen, device)
        scales = torch.rand(rows, generator=gen, device=device) * 0.01
        idx, w = _bag_slots(2000, 61, 8, 3, gen, device)
        cases.append(GatherCase(GATHER_BIG, payload, scales, idx + tail, w))
    return cases


class TieredCase(NamedTuple):
    name: str
    leaves: tuple             # PackedStore fields, in order
    ids: torch.Tensor         # (B, K) int32 or int64 global ids
    weights: torch.Tensor | None  # (B, K) fp32


TIERED_CASE_NAMES = ("k1_d64_int64", "k1_d64_int32", "k8_d10_weighted",
                     "k40_d33_fp16_weighted", "empty_int8_k1_d64",
                     "empty_fp32_k8_d10", "nan_inf_weights_d64")


def _packed_leaves(counts, d: int, half, gen, device) -> tuple:
    """PackedStore leaves (payload8, scale8, payload16, scale16,
    payload32, indirect) with ``counts`` rows a tier (0: the one-row
    placeholder of zeros), the rows of the vocabulary dealt to the tiers
    at random."""
    v = sum(counts)
    tiers = torch.repeat_interleave(torch.arange(3, device=device),
                                    torch.tensor(counts, device=device))
    tiers = tiers[torch.randperm(v, generator=gen, device=device)]
    loc = torch.zeros(v, dtype=torch.int32, device=device)
    leaves = []
    for t, dt in enumerate((torch.int8, half, torch.float32)):
        sel = torch.nonzero(tiers == t).reshape(-1)
        loc[sel] = torch.arange(sel.numel(), dtype=torch.int32,
                                device=device)
        n = max(counts[t], 1)
        payload = (_payload(dt, n, d, gen, device) if counts[t] else
                   torch.zeros((1, d), dtype=dt, device=device))
        leaves.append(payload)
        if t < 2:
            leaves.append(torch.rand(n, generator=gen, device=device) * 0.01)
    indirect = (tiers.to(torch.int32) << 28) | loc
    return (*leaves, indirect)


def tiered_cases(device) -> list[TieredCase]:
    gen = torch.Generator(device=device)
    gen.manual_seed(21)
    bf16, fp16 = torch.bfloat16, torch.float16
    cases = []

    def add(name, counts, d, half, b, k, weighted, ids_dtype=torch.int64):
        leaves = _packed_leaves(counts, d, half, gen, device)
        v = leaves[-1].shape[0]
        ids = torch.randint(0, v, (b, k), generator=gen, device=device,
                            dtype=ids_dtype)
        w = None
        if weighted:
            w = torch.randn((b, k), generator=gen, device=device)
            w[torch.rand((b, k), generator=gen, device=device) < 0.3] = 0.0
        cases.append(TieredCase(name, leaves, ids, w))

    add("k1_d64_int64", (150, 60, 90), 64, bf16, 61, 1, False)
    add("k1_d64_int32", (150, 60, 90), 64, bf16, 64, 1, False, torch.int32)
    add("k8_d10_weighted", (200, 50, 50), 10, bf16, 37, 8, True)
    add("k40_d33_fp16_weighted", (120, 120, 60), 33, fp16, 37, 40, True)
    add("empty_int8_k1_d64", (0, 80, 40), 64, bf16, 61, 1, False)
    add("empty_fp32_k8_d10", (90, 30, 0), 10, bf16, 37, 8, True)
    add("nan_inf_weights_d64", (150, 60, 90), 64, bf16, 37, 3, True)
    w = cases[-1].weights
    w[5, 1], w[9, 0] = float("nan"), float("inf")
    w[11, 2] = -float("inf")
    return cases


class WindowCase(NamedTuple):
    name: str
    leaves: tuple             # the whole store's PackedStore fields
    shards: int               # row shards at stride ceil(V_t / shards)
    ids: torch.Tensor         # (B, K) int32 or int64 global ids
    weights: torch.Tensor | None  # (B, K) fp32


WINDOW_CASE_NAMES = ("k1_d64_int64_n4", "k1_d64_int32_n3",
                     "k8_d10_weighted_n4", "k40_d33_fp16_n2",
                     "one_row_last_shard_n4", "empty_int8_n4",
                     "nan_inf_weights_n4")


def window_cases(device) -> list[WindowCase]:
    gen = torch.Generator(device=device)
    gen.manual_seed(25)
    bf16, fp16 = torch.bfloat16, torch.float16
    cases = []

    def add(name, counts, d, half, n, b, k, weighted,
            ids_dtype=torch.int64):
        leaves = _packed_leaves(counts, d, half, gen, device)
        v = leaves[-1].shape[0]
        ids = torch.randint(0, v, (b, k), generator=gen, device=device,
                            dtype=ids_dtype)
        w = None
        if weighted:
            w = torch.randn((b, k), generator=gen, device=device)
            w[torch.rand((b, k), generator=gen, device=device) < 0.3] = 0.0
        cases.append(WindowCase(name, leaves, n, ids, w))

    add("k1_d64_int64_n4", (150, 60, 90), 64, bf16, 4, 61, 1, False)
    add("k1_d64_int32_n3", (150, 60, 90), 64, bf16, 3, 64, 1, False,
        torch.int32)
    add("k8_d10_weighted_n4", (200, 50, 50), 10, bf16, 4, 37, 8, True)
    add("k40_d33_fp16_n2", (120, 120, 61), 33, fp16, 2, 37, 40, True)
    # int8 13 rows -> 4, 4, 4, 1; half 9 -> 3, 3, 3, 0; fp32 5 -> 2, 2, 1, 0
    add("one_row_last_shard_n4", (13, 9, 5), 64, bf16, 4, 61, 1, False)
    add("empty_int8_n4", (0, 7, 40), 10, bf16, 4, 37, 8, True, torch.int32)
    add("nan_inf_weights_n4", (150, 60, 90), 64, bf16, 4, 37, 3, True)
    w = cases[-1].weights
    w[5, 1], w[9, 0] = float("nan"), float("inf")
    w[11, 2] = -float("inf")
    return cases


class HashCase(NamedTuple):
    name: str
    pool: torch.Tensor        # (S, Z) fp32 or int8
    scales: torch.Tensor | None   # (S,) fp32
    ids: torch.Tensor         # (B, K) int64 or int32
    weights: torch.Tensor | None  # (B, K) fp32
    num_chunks: int
    num_hashes: int
    seed: int


# (Z, K, NH, C, S, seed, weighted): Z 4/5/8, T = K * NH 1/2/6
HASH_SHAPES = ((4, 1, 1, 3, 1797, 0, False), (5, 1, 2, 4, 211, 7, False),
               (8, 1, 2, 4, 4001, 0, False), (8, 3, 2, 4, 1797, 7, True),
               (5, 3, 2, 2, 4001, 0, True), (4, 3, 2, 3, 211, 7, True))
HASH_CASE_NAMES = tuple(
    f"{dt}_z{z}_t{k * nh}_c{c}_s{s}_seed{seed}"
    for dt in ("float32", "int8")
    for z, k, nh, c, s, seed, _ in HASH_SHAPES)


def hashed_cases(device) -> list[HashCase]:
    gen = torch.Generator(device=device)
    gen.manual_seed(22)
    cases = []
    for dt in (torch.float32, torch.int8):
        for n, (z, k, nh, c, s, seed, weighted) in enumerate(HASH_SHAPES):
            pool = _payload(dt, s, z, gen, device)
            scales = (torch.rand(s, generator=gen, device=device) * 0.02
                      + 1e-3)
            if dt == torch.float32 and n % 2:
                scales = None
            b = (61, 37, 64)[n % 3]
            ids = torch.randint(0, 1 << 40, (b, k), generator=gen,
                                device=device)
            if n % 2:
                ids = (ids & 0x7FFFFFFF).to(torch.int32)
            w = None
            if weighted:
                w = torch.randn((b, k), generator=gen, device=device)
                w[torch.rand((b, k), generator=gen, device=device) < 0.3] = 0
            cases.append(HashCase(
                f"{str(dt).removeprefix('torch.')}_z{z}_t{k * nh}_c{c}"
                f"_s{s}_seed{seed}", pool, scales, ids, w, c, nh, seed))
    return cases
