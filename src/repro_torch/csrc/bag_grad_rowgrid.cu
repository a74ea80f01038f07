// The (B, K)-grid tiling oracle of the bag's scatter-add backward, for
// Hopper (sm_90a).
//
// Replaces repro/kernels/dequant_bag/kernel.py::bag_grad_pallas_rowgrid,
// the layout the reference keeps to test its tiled backward: a (B, K)
// grid whose every step is one serial read-modify-write of one slot's
// row.  It computes what bag_grad.cu computes,
//
//   dtable[i, :] = sum over slots (b, k) with idx[b,k] == i of
//                  coeff[b,k] * g[b, :]
//
// g (B, D) fp32, coeff (B, K) fp32 (= w * scale[idx], rounded by the
// caller), idx (B, K) int32 -> dtable (V, D) fp32, zeroed by the caller
// (the reference's aliased zeros operand).  Slots with coeff == 0 are
// skipped (kernel.py:446), and each touched element becomes
// __fmaf_rn(c, g[b], row), the fused `row += c * g` of the reference's
// interpret mode, so each row's sum is the (b, k)-ordered FMA chain,
// started from the row's value in dtable, that bag_grad.cu and the plain
// versions compute
// (repro_torch/kernels/dequant_bag/ref.py::bag_grad_rowgrid_ref).
//
// What bounds it on an H100: bytes (g once, the indices and coefficients,
// each touched row written once: 0.145 ms at a training batch), and one
// row's chain of dependent FMAs (52,393 slots of the zipf head: 0.106 ms).
// The grid's own schedule, one slot at a time in (b, k) order, is bound by
// neither: it waits a memory round trip a slot (PR 15's port of it, one
// block of D threads walking every slot, took 941 ms at a training batch).
//
// The design keeps the grid's order, a row's slots in (b, k) order with
// one owner a row, but finds the parallelism that order allows: slots of
// different rows commute.  No slot is sorted or grouped by row across the
// batch (bag_grad.cu's schedule, which this oracle checks), and no atomic
// touches dtable.
//
//   * Pass 1 (count_kernel, scan_tiles_kernel, plan_kernel,
//     scatter_kernel) is a stable partition of the live slots into P
//     buckets by row mod P (P a power of two, at most 4,096): per-tile
//     counts, an exclusive scan over tiles and buckets, a stable write of
//     each slot's row, bag and coefficient.  It orders by bucket only, so
//     a bucket's slots keep their (b, k) order, and a row lies in one
//     bucket.  The plan lists the buckets in use, those over `heavy` slots
//     first, so the zipf head's bucket starts first.
//   * Pass 2 (chain_kernel): a persistent pool of warps, each taking jobs
//     (a bucket and 32 of its columns) from a device counter.  A warp
//     walks its bucket's slots in windows of 32, a lane a column, each
//     row's chain in registers over the window: one read of the row where
//     its run in the window starts, one write where it ends.  A window of
//     one row (most of the zipf head's) is chained in slot order; any
//     other is first grouped by row, a lane a slot (__match_any_sync),
//     keeping (b, k) order inside each row.  A row that carries on from
//     the previous window takes that window's final value from shared
//     memory; any other row is read from dtable one window ahead (no
//     earlier window of this warp can still write it).  The windows'
//     slot data stream into a shared-memory ring 2 * (kRing - 1) windows
//     ahead and their g rows kRing - 1 windows ahead, both by cp.async
//     (16-byte copies where g's rows allow), one commit group a window.
//
// Its schedule still differs from bag_grad.cu's: there the whole batch is
// sorted by row and each row's run is chained by one owner in sorted
// order; here no slot leaves its bucket's (b, k) order, and a row's chain
// is cut at every window and carried between them.  Bit-equality between
// the two tests the one against the other.  Offsets are int64 (row * D
// reaches 7.9e9 at 124M rows x 64).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 4096;          // slots a pass-1 tile
constexpr int kMaxBuckets = 4096;
constexpr int kMeta = 4;             // scratch: grab counter, buckets in use
constexpr int kThreads = 256;        // pass-1 blocks
constexpr int kPlanThreads = 1024;
constexpr int kWin = 32;             // slots a window
constexpr int kCols = 32;            // columns a job
constexpr int kRing = 6;             // windows of g rows a warp keeps
constexpr int kAhead = 2 * (kRing - 1);  // windows of slot data in flight
constexpr int kMetaRing = kAhead + 1;
constexpr int kChainWarps = 3;       // warps a chain block, each on its own
constexpr int kHead = 32, kTail = 64, kLinked = 128;
constexpr int kNoRow = -1000;        // matches no row and no padded lane

// ---- pass 1: the stable partition by bucket --------------------------------

// Block-wide: hist[b] = the live slots of [s0, s1) in bucket b.
__device__ void count_tile(const int32_t* __restrict__ idx,
                           const float* __restrict__ coeff, int64_t s0,
                           int64_t s1, int p, int32_t* hist) {
  for (int b = threadIdx.x; b < p; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  for (int64_t s = s0 + threadIdx.x; s < s1; s += blockDim.x)
    if (coeff[s] != 0.0f) atomicAdd(&hist[idx[s] & (p - 1)], 1);
  __syncthreads();
}

// counts[t * p + b]: tile t's live slots in bucket b
__global__ void __launch_bounds__(kThreads)
count_kernel(const int32_t* __restrict__ idx, const float* __restrict__ coeff,
             int64_t n, int p, int32_t* __restrict__ counts) {
  __shared__ int32_t hist[kMaxBuckets];
  const int64_t s0 = (int64_t)blockIdx.x * kTile;
  count_tile(idx, coeff, s0, s0 + kTile < n ? s0 + kTile : n, p, hist);
  int32_t* mine = counts + (int64_t)blockIdx.x * p;
  for (int b = threadIdx.x; b < p; b += kThreads) mine[b] = hist[b];
}

// counts[t * p + b] becomes bucket b's live slots in tiles before t;
// total[b] its live slots
__global__ void __launch_bounds__(kThreads)
scan_tiles_kernel(int32_t* __restrict__ counts, int64_t ntiles, int p,
                  int32_t* __restrict__ total) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= p) return;
  int32_t run = 0;
  for (int64_t t0 = 0; t0 < ntiles; t0 += 8) {
    int32_t c[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      c[u] = t0 + u < ntiles ? counts[(t0 + u) * p + b] : 0;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (t0 + u < ntiles) counts[(t0 + u) * p + b] = run;
      run += c[u];
    }
  }
  total[b] = run;
}

// Exclusive block-wide sums of three counts at once; `tot` gets the sums.
__device__ void block_scan3(int (&v)[3], int (&tot)[3]) {
  __shared__ int warp_sums[3][kPlanThreads / 32];
  __shared__ int totals[3];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int incl[3] = {v[0], v[1], v[2]};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl[j], d);
      if (lane >= d) incl[j] += y;
    }
    if (lane == 31) warp_sums[j][wid] = incl[j];
  }
  __syncthreads();
  if (wid == 0) {                  // kPlanThreads / 32 == 32 warp sums
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int x = warp_sums[j][lane];
      int s = x;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, s, d);
        if (lane >= d) s += y;
      }
      warp_sums[j][lane] = s - x;
      if (lane == 31) totals[j] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    v[j] = warp_sums[j][wid] + incl[j] - v[j];
    tot[j] = totals[j];
  }
}

// A block of kPlanThreads: start[b] = the live slots of buckets before b;
// jobs = the buckets in use, those over `heavy` slots first, each class
// in bucket order; meta[0] = 0 (the chain kernel's grab counter),
// meta[1] = buckets in use.
__device__ void plan_buckets(const int32_t* total, int p, int heavy,
                             int32_t* __restrict__ start,
                             int32_t* __restrict__ jobs,
                             int32_t* __restrict__ meta) {
  const int per = (p + kPlanThreads - 1) / kPlanThreads;
  const int b0 = threadIdx.x * per;
  int v[3] = {0, 0, 0};            // slots, heavy buckets, light buckets
  for (int u = 0; u < per; ++u) {
    const int b = b0 + u;
    if (b < p) {
      const int c = total[b];
      v[0] += c;
      v[1] += c > heavy;
      v[2] += c > 0 && c <= heavy;
    }
  }
  int tot[3];
  block_scan3(v, tot);
  int at = v[0], hi = v[1], li = tot[1] + v[2];
  for (int u = 0; u < per; ++u) {
    const int b = b0 + u;
    if (b < p) {
      const int c = total[b];
      start[b] = at;
      at += c;
      if (c > heavy)
        jobs[hi++] = b;
      else if (c > 0)
        jobs[li++] = b;
    }
  }
  if (threadIdx.x == 0) {
    meta[0] = 0;
    meta[1] = tot[1] + tot[2];
  }
}

__global__ void __launch_bounds__(kPlanThreads)
plan_kernel(const int32_t* __restrict__ total, int p, int heavy,
            int32_t* __restrict__ start, int32_t* __restrict__ jobs,
            int32_t* __restrict__ meta) {
  plan_buckets(total, p, heavy, start, jobs, meta);
}

// One warp writes the live slots of [s0, s1) at their bucket's next
// places (next[b], shared, advanced), in slot order: earlier chunks of 32
// first, lower lanes first in a chunk.
__device__ void scatter_tile(const int32_t* __restrict__ idx,
                             const float* __restrict__ coeff, int64_t s0,
                             int64_t s1, int k_slots, int p, int32_t* next,
                             int32_t* __restrict__ prow,
                             int32_t* __restrict__ pbag,
                             float* __restrict__ pcoeff) {
  const int lane = threadIdx.x & 31;
  int64_t s = s0 + lane;
  int32_t r = s < s1 ? idx[s] : 0;
  float c = s < s1 ? coeff[s] : 0.0f;
  for (int64_t base = s0; base < s1; base += 32) {
    const int64_t sn = s + 32;
    const int32_t rn = sn < s1 ? idx[sn] : 0;
    const float cn = sn < s1 ? coeff[sn] : 0.0f;
    const bool live = s < s1 && c != 0.0f;
    const int b = r & (p - 1);
    const unsigned m = __match_any_sync(kFull, live ? b : -1 - lane);
    const int rank = __popc(m & ((1u << lane) - 1u));
    const int32_t pos = live ? next[b] + rank : 0;
    __syncwarp();
    if (live && rank == 0) next[b] += __popc(m);
    __syncwarp();
    if (live) {
      prow[pos] = r;
      pbag[pos] = (int32_t)s / k_slots;
      pcoeff[pos] = c;
    }
    s = sn;
    r = rn;
    c = cn;
  }
}

// One warp a tile, from its buckets' places (start + earlier tiles').
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int32_t* __restrict__ idx,
               const float* __restrict__ coeff, int64_t n, int k_slots,
               int p, const int32_t* __restrict__ counts,
               const int32_t* __restrict__ start, int32_t* __restrict__ prow,
               int32_t* __restrict__ pbag, float* __restrict__ pcoeff) {
  __shared__ int32_t next[kMaxBuckets];
  const int64_t t = blockIdx.x;
  for (int b = threadIdx.x; b < p; b += kThreads)
    next[b] = start[b] + counts[t * p + b];
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int64_t s0 = t * kTile;
  scatter_tile(idx, coeff, s0, s0 + kTile < n ? s0 + kTile : n, k_slots, p,
               next, prow, pbag, pcoeff);
}

// The whole of pass 1 in one block, for a batch of one tile.
__global__ void __launch_bounds__(kPlanThreads)
partition_one_tile_kernel(const int32_t* __restrict__ idx,
                          const float* __restrict__ coeff, int64_t n,
                          int k_slots, int p, int heavy,
                          int32_t* __restrict__ total,
                          int32_t* __restrict__ start,
                          int32_t* __restrict__ jobs,
                          int32_t* __restrict__ meta,
                          int32_t* __restrict__ prow,
                          int32_t* __restrict__ pbag,
                          float* __restrict__ pcoeff) {
  __shared__ int32_t hist[kMaxBuckets];
  count_tile(idx, coeff, 0, n, p, hist);
  for (int b = threadIdx.x; b < p; b += kPlanThreads) total[b] = hist[b];
  plan_buckets(hist, p, heavy, start, jobs, meta);
  __syncthreads();                 // start is written; hist is free
  if (threadIdx.x >= 32) return;
  for (int b = threadIdx.x; b < p; b += 32) hist[b] = start[b];
  __syncwarp();
  scatter_tile(idx, coeff, 0, n, k_slots, p, hist, prow, pbag, pcoeff);
}

// ---- pass 2: the chains, a warp a job --------------------------------------

struct __align__(16) Info {  // a window's slot, at its grouped place
  int flags;        // bits 0-4 its place in the window; kHead, kTail, kLinked
  int row;
  float c;
  int link;         // a linked head: its row's grouped place where its run
};                  // in the last window ended

struct WarpSmem {
  float g[kRing][kWin][kCols];     // the windows' g rows, a job's columns
  int32_t row[kMetaRing][kWin];    // the windows' slots: rows, bags, coeffs
  int32_t bag[kMetaRing][kWin];
  float c[kMetaRing][kWin];
  float fin[2][kWin][kCols];       // each row's value where its run ends
  Info info[2][kWin];              // a window in grouped order
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Lane = a window's place.  Groups the window by row, each row's places
// in order and the rows in the order they first appear, writes each
// place's Info at its grouped place and returns that place.  `row` of a
// place past the bucket is -1 - lane (a row of its own, grouped last);
// `prev` and `prev_at` are the last window's row at this place (kNoRow
// for none) and its grouped place there, for the links.
__device__ __forceinline__ int group_window(int lane, int row, float c,
                                            int prev, int prev_at,
                                            Info* dst) {
  const unsigned m = __match_any_sync(kFull, row);
  const int lead = __ffs(m) - 1;
  const int last = 31 - __clz(m);
  const int size = lead == lane ? __popc(m) : 0;
  int incl = size;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  const int dest = __shfl_sync(kFull, incl - size, lead) +
                   __popc(m & ((1u << lane) - 1u));
  int k_last = -1;                 // the last window's last place of row
#pragma unroll
  for (int k = 0; k < kWin; ++k) {
    const int r = __shfl_sync(kFull, prev, k);
    k_last = r == row ? k : k_last;
  }
  const int link = __shfl_sync(kFull, prev_at, k_last < 0 ? 0 : k_last);
  Info f;
  f.flags = lane | (lead == lane ? kHead : 0) | (last == lane ? kTail : 0) |
            (k_last >= 0 ? kLinked : 0);
  f.row = row;
  f.c = c;
  f.link = k_last >= 0 ? link : -1;
  dst[dest] = f;
  return dest;
}

// Per window v of a job: its slot data (rows, bags, coefficients) lands
// in the meta ring kAhead windows ahead, its g rows in the g ring kRing -
// 1 windows ahead (their addresses are the landed bags), both by cp.async,
// one commit group a window; the window is grouped one window ahead, and
// dtable's values at its fresh heads are loaded then too.
template <bool kVec16>
__global__ void __launch_bounds__(32 * kChainWarps)
chain_kernel(const float* __restrict__ g, const int32_t* __restrict__ prow,
             const int32_t* __restrict__ pbag,
             const float* __restrict__ pcoeff, float* out, int64_t dim,
             const int32_t* __restrict__ start,
             const int32_t* __restrict__ total,
             const int32_t* __restrict__ jobs, int32_t* meta, int nwin) {
  extern __shared__ __align__(16) unsigned char smem[];
  WarpSmem& sm = reinterpret_cast<WarpSmem*>(smem)[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const int njobs = meta[1] * nwin;
  for (;;) {
    int q = 0;
    if (lane == 0) q = atomicAdd(&meta[0], 1);
    q = __shfl_sync(kFull, q, 0);
    if (q >= njobs) return;
    const int bucket = jobs[q / nwin];
    const int64_t c0 = (int64_t)(q % nwin) * kCols;
    const int64_t base = start[bucket];
    const int cnt = total[bucket];
    const int nw = (cnt + kWin - 1) / kWin;
    const int64_t col = c0 + lane;
    const bool active = col < dim;
    const int wcols = (int)(dim - c0 < kCols ? dim - c0 : kCols);
    auto in_window = [&](int v) {
      return cnt - v * kWin < kWin ? cnt - v * kWin : kWin;
    };
    // window v's slot data into its meta ring slot (each lane its place)
    auto issue_meta = [&](int v) {
      const int j = v * kWin + lane;
      if (v < nw && j < cnt) {
        const int m = v % kMetaRing;
        cp_async4(&sm.row[m][lane], prow + base + j);
        cp_async4(&sm.bag[m][lane], pbag + base + j);
        cp_async4(&sm.c[m][lane], pcoeff + base + j);
      }
    };
    // window v's g rows into its g ring slot; its bags have landed
    auto issue_g = [&](int v) {
      if (v < nw) {
        const int bag = sm.bag[v % kMetaRing][lane];
        float* dst = &sm.g[v % kRing][0][0];
        const int nin = in_window(v);
        // every bag first: no shuffle waits between the copies
        if constexpr (kVec16) {
          constexpr int kPieces = kWin * kCols / 4 / 32;
          int b[kPieces];
#pragma unroll
          for (int u = 0; u < kPieces; ++u)
            b[u] = __shfl_sync(kFull, bag, (lane + 32 * u) >> 3);
#pragma unroll
          for (int u = 0; u < kPieces; ++u) {
            const int t = (lane + 32 * u) >> 3, q4 = (lane & 7) * 4;
            if (t < nin && q4 < wcols)
              cp_async16(dst + t * kCols + q4,
                         g + (int64_t)b[u] * dim + c0 + q4);
          }
        } else {
          int b[kWin];
#pragma unroll
          for (int t = 0; t < kWin; ++t) b[t] = __shfl_sync(kFull, bag, t);
#pragma unroll
          for (int t = 0; t < kWin; ++t)
            if (t < nin && active)
              cp_async4(dst + t * kCols + lane, g + (int64_t)b[t] * dim + col);
        }
      }
    };
    auto slot_of = [&](int v, int& row, float& c) {
      const int m = v % kMetaRing;
      const bool here = v * kWin + lane < cnt;
      row = here ? sm.row[m][lane] : -1 - lane;
      c = here ? sm.c[m][lane] : 0.0f;
    };
    // dtable's values at window v's heads that do not carry on from the
    // window before (its Info in place)
    auto load_heads = [&](int v, float (&o)[kWin]) {
      const Info* inf = sm.info[v & 1];
      const Info mine = inf[lane];
      const unsigned fresh = __ballot_sync(
          kFull,
          lane < in_window(v) && (mine.flags & (kHead | kLinked)) == kHead);
#pragma unroll
      for (int i = 0; i < kWin; ++i) {
        const int r = inf[i].row;
        if (((fresh >> i) & 1u) && active) o[i] = out[(int64_t)r * dim + col];
      }
    };

    __syncwarp();          // the last job's reads of the rings are done
#pragma unroll
    for (int v = 0; v < kRing - 1; ++v) issue_meta(v);
    cp_async_commit();
    cp_async_wait<0>();
#pragma unroll
    for (int v = 0; v < kRing - 1; ++v) {
      issue_meta(v + kRing - 1);
      issue_g(v);
      cp_async_commit();
    }

    // window v's plan, made one window ahead: a window of one row (the
    // zipf head's, mostly) keeps slot order and needs no grouping; any
    // other is grouped (its Info in place).  Either way dtable's values at
    // its fresh heads go to `o`.  The state of the window planned last:
    int row_prev = kNoRow;   // its rows (lane = place)
    int at_prev = 0;         // each place's grouped place
    bool one_plan = false;   // it holds one row,
    int row_one = 0;         // that row,
    int link_one = -1;       // its grouped place in the window before (or -1)
    auto plan = [&](int v, float (&o)[kWin]) {
      int row_n;
      float c_n;
      slot_of(v, row_n, c_n);
      const int nin = in_window(v);
      const int r0 = __shfl_sync(kFull, row_n, 0);
      one_plan = __all_sync(kFull, lane >= nin || row_n == r0);
      if (one_plan) {
        const unsigned hit = __ballot_sync(kFull, row_prev == r0);
        const int at = __shfl_sync(kFull, at_prev, hit ? 31 - __clz(hit) : 0);
        row_one = r0;
        link_one = hit ? at : -1;
        // no earlier window of this warp can still write the row
        if (!hit && active) o[0] = out[(int64_t)r0 * dim + col];
        at_prev = lane;
      } else {
        at_prev = group_window(lane, row_n, c_n, row_prev, at_prev,
                               sm.info[v & 1]);
        __syncwarp();
        // rows absent from window v - 1: the last write of each (an
        // earlier window's, this lane's column) is already issued
        load_heads(v, o);
      }
      row_prev = row_n;
    };
    float ov0[kWin], ov1[kWin];
#pragma unroll
    for (int i = 0; i < kWin; ++i) ov0[i] = ov1[i] = 0.0f;
    plan(0, ov0);

    // window w: its heads' dtable values in `cur`; window w + 1's go to
    // `nxt` (two arrays in turn, so no copy waits on their loads).  Each
    // chain reads its operands into registers first, then runs with no
    // shuffle or shared load between its FMAs; a row's final value goes to
    // fin at its grouped place.
    auto step = [&](int w, float (&cur)[kWin], float (&nxt)[kWin]) {
      cp_async_wait<kRing - 2>();  // window w's g rows, w + kRing - 1's bags
      __syncwarp();                // and every lane's copies; ring slot
                                   // (w - 1) % kRing is read
      issue_g(w + kRing - 1);
      issue_meta(w + kAhead);
      cp_async_commit();
      const bool one = one_plan;
      const int row1 = row_one, link1 = link_one;
      if (w + 1 < nw) plan(w + 1, nxt);
      const int nin = in_window(w);
      const float* gw = &sm.g[w % kRing][0][lane];
      const float* fprev = &sm.fin[(w & 1) ^ 1][0][lane];
      float* fcur = &sm.fin[w & 1][0][lane];
      float acc;
      if (one) {                   // one chain in slot order
        const float* cs = sm.c[w % kMetaRing];
        float cv[kWin], gv[kWin];
#pragma unroll
        for (int i = 0; i < kWin; ++i) {
          cv[i] = cs[i];
          gv[i] = gw[i * kCols];
        }
        acc = link1 >= 0 ? fprev[link1 * kCols] : cur[0];
#pragma unroll
        for (int i = 0; i < kWin; ++i)
          if (i < nin) acc = __fmaf_rn(cv[i], gv[i], acc);
        if (active) out[(int64_t)row1 * dim + col] = acc;
        fcur[(nin - 1) * kCols] = acc;
        return;
      }
      const Info* inf = sm.info[w & 1];
      const Info mine = inf[lane];
      const unsigned heads = __ballot_sync(kFull, mine.flags & kHead);
      const unsigned tails = __ballot_sync(kFull, mine.flags & kTail);
      const unsigned linked = __ballot_sync(kFull, mine.flags & kLinked);
      float cv[kWin], gv[kWin];
      int rv[kWin];
#pragma unroll
      for (int i = 0; i < kWin; ++i) {
        const Info f = inf[i];
        cv[i] = f.c;
        rv[i] = f.row;
        gv[i] = gw[(f.flags & 31) * kCols];
      }
      acc = 0.0f;
#pragma unroll
      for (int i = 0; i < kWin; ++i) {
        if (i < nin) {
          if ((heads >> i) & 1u)
            acc = ((linked >> i) & 1u) ? fprev[inf[i].link * kCols] : cur[i];
          acc = __fmaf_rn(cv[i], gv[i], acc);
          if ((tails >> i) & 1u) {
            if (active) out[(int64_t)rv[i] * dim + col] = acc;
            fcur[i * kCols] = acc;
          }
        }
      }
    };
    for (int w = 0; w < nw; w += 2) {
      step(w, ov0, ov1);
      if (w + 1 < nw) step(w + 1, ov1, ov0);
    }
  }
}

// ---- launch -----------------------------------------------------------------

constexpr int kMaxDevices = 64;

int sm_count() {
  int dev = 0, count = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    count = 132;
  return count;
}

int64_t tiles_of(int64_t n) { return (n + kTile - 1) / kTile; }

// meta, total, start and jobs, a count a bucket a tile, a row, bag and
// coefficient a slot
int64_t scratch_words(int64_t n, int p) {
  return kMeta + 3LL * p + tiles_of(n) * p + 3 * n;
}

template <bool kVec16>
int launch_chains(const float* g, const int32_t* prow, const int32_t* pbag,
                  const float* pcoeff, float* out, int64_t dim,
                  const int32_t* start, const int32_t* total,
                  const int32_t* jobs, int32_t* meta, int nwin,
                  int64_t most_jobs, cudaStream_t st) {
  auto kernel = chain_kernel<kVec16>;
  const int smem = kChainWarps * (int)sizeof(WarpSmem);
  // the shared-memory limit and the blocks an SM holds, once a device
  static int per_sm[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return (int)cudaErrorInvalidDevice;
  if (per_sm[dev] == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, 32 * kChainWarps, smem);
    if (err != cudaSuccess) return (int)err;
    per_sm[dev] = (blocks > 0 ? blocks : 1) * sm_count();
  }
  const int64_t want = (most_jobs + kChainWarps - 1) / kChainWarps;
  const int64_t blocks = per_sm[dev] < want ? per_sm[dev] : want;
  kernel<<<(unsigned)blocks, 32 * kChainWarps, smem, st>>>(
      g, prow, pbag, pcoeff, out, dim, start, total, jobs, meta, nwin);
  return (int)cudaGetLastError();
}

}  // namespace

// n_slots = B * K slots in (b, k) order.  buckets: P, a power of two in
// [1, 4096].  scratch: int32 [scratch_len], at least scratch_words(n_slots,
// buckets) (kernel.py's rowgrid_scratch_words mirrors it); nothing in it
// is read before this launch writes it.  Two passes on `stream` (five
// kernels; two for a batch of one 4,096-slot tile), no host
// synchronisation.  Returns the cudaError_t of the launches (0 = success).
extern "C" int bag_grad_rowgrid_launch(const void* g, const void* indices,
                                       const void* coeff, void* out,
                                       long long n_slots, int k_slots,
                                       long long dim, int buckets,
                                       void* scratch, long long scratch_len,
                                       void* stream) {
  if (n_slots <= 0 || dim <= 0) return 0;
  if (k_slots <= 0 || n_slots >= 0x7fffffffLL || buckets < 1 ||
      buckets > kMaxBuckets || (buckets & (buckets - 1)) != 0 ||
      scratch_len < scratch_words(n_slots, buckets))
    return (int)cudaErrorInvalidValue;
  const int64_t n = n_slots;
  const int p = buckets;
  const int64_t ntiles = tiles_of(n);
  int32_t* meta = static_cast<int32_t*>(scratch);
  int32_t* total = meta + kMeta;
  int32_t* start = total + p;
  int32_t* jobs = start + p;
  int32_t* counts = jobs + p;
  int32_t* prow = counts + ntiles * p;
  int32_t* pbag = prow + n;
  float* pcoeff = reinterpret_cast<float*>(pbag + n);
  const int32_t* ip = static_cast<const int32_t*>(indices);
  const float* cp = static_cast<const float*>(coeff);
  const float* gp = static_cast<const float*>(g);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ntiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;

  // heavy: four times a bucket's mean share, so the zipf head goes first
  const int heavy = (int)(4 * ((n + p - 1) / p)) + kWin;
  if (ntiles == 1) {
    partition_one_tile_kernel<<<1, kPlanThreads, 0, st>>>(
        ip, cp, n, k_slots, p, heavy, total, start, jobs, meta, prow, pbag,
        pcoeff);
  } else {
    count_kernel<<<(unsigned)ntiles, kThreads, 0, st>>>(ip, cp, n, p,
                                                         counts);
    scan_tiles_kernel<<<(p + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        counts, ntiles, p, total);
    plan_kernel<<<1, kPlanThreads, 0, st>>>(total, p, heavy, start, jobs,
                                            meta);
    scatter_kernel<<<(unsigned)ntiles, kThreads, 0, st>>>(
        ip, cp, n, k_slots, p, counts, start, prow, pbag, pcoeff);
  }
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;

  const int nwin = (int)((dim + kCols - 1) / kCols);
  const int64_t most_jobs = (n < p ? n : p) * (int64_t)nwin;
  const bool vec16 = dim % 4 == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  return vec16 ? launch_chains<true>(gp, prow, pbag, pcoeff, op, dim, start,
                                     total, jobs, meta, nwin, most_jobs, st)
               : launch_chains<false>(gp, prow, pbag, pcoeff, op, dim, start,
                                      total, jobs, meta, nwin, most_jobs, st);
}
