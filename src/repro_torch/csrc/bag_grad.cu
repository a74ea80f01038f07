// Scatter-add backward of the embedding bag for Hopper (sm_90a).
//
// Replaces repro/kernels/dequant_bag/kernel.py::bag_grad_pallas, the
// training backward of the fused gather (the table cotangent of
// lookup_train):
//
//   dtable[i, :] = sum over slots (b, k) with idx[b,k] == i of
//                  coeff[b,k] * g[b, :]
//
// g (B, D) fp32, coeff (B, K) fp32 (= w * scale[idx], rounded by the
// caller), idx (B, K) int32 -> dtable (V, D) fp32.  The caller passes
// dtable zeroed (the reference's aliased zeros operand); this kernel
// writes only the rows some slot touches.  With `accumulate` set, each
// touched row's chain starts from the row's value in dtable instead of
// 0, so that a scatter split into consecutive runs of bags (the hashed
// fit's row chunks) sums each row in the same order as one call.
//
// Contract with the reference: each row's sum is accumulated in (b, k)
// lexicographic order as acc = fma(coeff, g[b], acc), starting from 0
// (or from dtable's row, accumulating), with slots of coeff == 0
// skipped.  The TPU grid walks the slots one
// at a time and its interpret-mode arithmetic (XLA on the CPU) fuses the
// `row += c * g` read-modify-write into that FMA.  Here the FMA is
// written as __fmaf_rn, so nvcc's contraction choices cannot change it,
// and the result is bit-identical to the plain PyTorch version
// (repro_torch/kernels/dequant_bag/ref.py::bag_grad_ref).  GPU blocks run
// in no order, so an atomicAdd scatter would sum in a different order
// each run; instead the caller groups the slots by row with a stable
// sort (torch.sort(..., stable=True) on the flat indices, or the same
// grouping computed once and passed back in), which keeps each row's
// slots in (b, k) order.  Each row (a run of equal sorted rows) has one
// owner, which chains its columns over the run and stores the row once;
// no atomics touch the output.
//
// What bounds it on an H100: bytes, plus the longest run's chain.  It
// reads g (B*D*4), the sorted rows and slot ids and the coefficients
// (B*K*(4+8+4)), and writes each distinct touched row once (U*D*4); 2
// flops per element of a live slot, far below the ~300 flops/byte ridge.
// But one row's sum is one dependent chain of FMAs per column, so a run
// of R slots takes at least R FMA latencies (~4 cycles each) whatever the
// bandwidth: the zipf head of a training batch (52,393 slots) alone is
// ~0.11 ms.  And that chain's g rows all go to one SM, which on its own
// keeps only so many loads in flight (a block of 128 threads reads random
// 256-byte rows at ~18 GB/s, one of 512 at ~65 GB/s).  The (V, D) zero
// fill is not part of this kernel and is counted apart.
//
// What the design does about it: one launch runs three kernels.
//
//   * find_heavy: each run longer than `heavy` slots is listed (run
//     heads found from the sorted rows, compacted with a device counter:
//     no host sync); runs longer than 16 * heavy go to the front of the
//     list, so the longest chains start first.
//   * heavy_rows: one block a listed run, from a persistent pool that
//     takes runs from a device counter.  A block is 16 warps: one warp a
//     32 columns runs the FMA chains, the others only load, each filling
//     whole stages of a shared-memory ring (a stage's slot ids, then its
//     coefficients and g rows with 16-byte loads), so that up to 15
//     stages are in flight and the chains wait on the FMA latency and a
//     shared read, not on a global load.  Full and empty mbarriers hand
//     the stages over.
//   * light_rows: every other run.  A group of G lanes (32 at D >= 32,
//     down to 8 at small D, so that several groups share a warp and each
//     lane has a column) streams 32 sorted positions at a time across as
//     many short runs as they hold, storing a row when the next run
//     starts; a batch's coefficients and g rows are one round trip, with
//     the next batch's rows and slot ids in flight beside them.
//
// The light rows' group width and columns a lane are a launch argument
// (LightTiling), which the measured autotune cache may pick; 0, 0 is the
// analytic rule.  Every row keeps one owner lane a column, chaining its
// run in sorted order, so a tiling changes no bit.
//
// Offsets are int64: row * D reaches 7.9e9 at 124M rows x 64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kFindThreads = 256;
constexpr int kLightThreads = 256;
constexpr int kHeavyThreads = 512;     // 16 warps: consumers + loaders
constexpr int kHeavyWindow = 256;      // columns a heavy block chains at once
constexpr int kMaxRing = 32;           // ring stages, most
constexpr int kMaxStageSlots = 256;
constexpr int kHeavySmem = 200 * 1024; // shared bytes a heavy block asks for
constexpr int kMeta = 4;               // scratch: front, back, grab, pad
// sorted positions whose run heads a light group of G lanes owns
template <int G>
constexpr int64_t kLightStretch = 64LL * (32 / G);

// ---- slot -> bag -------------------------------------------------------

__device__ __forceinline__ int32_t bag_of(int64_t slot, int k_slots,
                                          int k_shift) {
  return (int32_t)(k_shift >= 0 ? (slot >> k_shift) : slot / k_slots);
}

// ---- mbarriers ----------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init_n(uint64_t* bar, unsigned n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(n));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Waits for the phase of `parity` to complete; traps instead of hanging
// if it never does.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (long long spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1LL << 24)) __trap();
  }
}

// ---- pass 1: list the heavy runs ----------------------------------------

// meta[0] / meta[1]: runs listed at the front (longer than 16 * heavy) /
// at the back of list[0, cap); meta[2] is the heavy blocks' grab counter.
__global__ void __launch_bounds__(kFindThreads)
find_heavy_kernel(const int32_t* __restrict__ rows, int64_t n, int heavy,
                  int32_t* __restrict__ meta, int cap) {
  int32_t* list = meta + kMeta;
  const int64_t big = 16LL * heavy;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += (int64_t)gridDim.x * blockDim.x) {
    const int32_t row = rows[j];
    if (j > 0 && rows[j - 1] == row) continue;          // not a run head
    // rows are sorted: the run is longer than `heavy` iff the slot
    // `heavy` places on still holds its row
    if (j + heavy >= n || rows[j + heavy] != row) continue;
    int pos;
    if (j + big < n && rows[j + big] == row)
      pos = atomicAdd(&meta[0], 1);
    else
      pos = cap - 1 - atomicAdd(&meta[1], 1);
    list[pos] = (int32_t)j;
  }
}

// ---- pass 2: heavy runs, one block a run --------------------------------
//
// A block of 16 warps: the first CW own one column each of a window of up
// to 256 columns (CW = window / 32, rounded up) and run the FMA chains;
// the other LW = 16 - CW load.  Loader warp k fills ring stages k, k +
// LW, ...: a stage is ts sorted slots' coefficients and g rows (16
// vectors a lane per round trip), so LW stages are in flight at once and
// one SM keeps enough bytes in flight to feed the hot row's chain.  Each
// ring slot has a `full` mbarrier (its loader warp arrives) and an
// `empty` one (the CW consumer warps arrive).

template <int VEC>
__device__ __forceinline__ void load_vec(float (&v)[VEC], const float* p) {
  if constexpr (VEC == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (VEC == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = p[0];
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// CB: floats a vector load of g moves (4, 2 or 1: the widest that g's
// alignment and the row width allow).
template <int CB>
__global__ void __launch_bounds__(kHeavyThreads, 1)
heavy_rows_kernel(const float* __restrict__ g,
                  const int32_t* __restrict__ rows,
                  const int64_t* __restrict__ slots,
                  const float* __restrict__ coeff, float* __restrict__ out,
                  int64_t n, int k_slots, int k_shift, int64_t dim,
                  int32_t* __restrict__ meta, int cap, int ts, int nring,
                  int win, int accumulate) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int64_t s_job;
  __shared__ __align__(8) uint64_t s_full[kMaxRing], s_empty[kMaxRing];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int cw = (win + 31) / 32;                 // consumer warps
  const int lw = kHeavyThreads / 32 - cw;         // loader warps
  const int32_t* list = meta + kMeta;
  // ring: [nring][ts][win] g rows and [nring][ts] coefficients, then
  // each loader warp's slot ids [lw][ts]
  float* ring_g = reinterpret_cast<float*>(smem);
  float* ring_c = ring_g + (size_t)nring * ts * win;
  int64_t* ids = reinterpret_cast<int64_t*>(ring_c + (size_t)nring * ts) +
                 (size_t)(wid >= cw ? wid - cw : 0) * ts;
  if (tid == 0) {
    for (int r = 0; r < nring; ++r) {
      mbar_init_n(&s_full[r], 1);
      mbar_init_n(&s_empty[r], cw);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int64_t streamed = 0;     // stages this block has streamed: ring phases

  for (;;) {
    if (tid == 0) {
      const int q = atomicAdd(&meta[2], 1);
      const int nf = meta[0], nb = meta[1];
      s_job = q < nf ? list[q]
                     : (q - nf < nb ? list[cap - 1 - (q - nf)] : -1);
    }
    __syncthreads();
    const int64_t j0 = s_job;
    if (j0 < 0) return;
    const int32_t row = rows[j0];

    // the run's end: the first sorted position past j0 whose row differs,
    // found by rounds of kHeavyThreads probes (rows are sorted, so the
    // probes that still hold `row` are a prefix)
    int64_t lo = j0 + 1, hi = n;
    for (;;) {
      const int64_t span = hi - lo;
      const int64_t step =
          span <= kHeavyThreads ? 1 : (span + kHeavyThreads - 1) /
                                          kHeavyThreads;
      const int64_t p = lo + (int64_t)tid * step;
      const bool eq = p < hi && rows[p] == row;
      const int cnt = __syncthreads_count(eq);
      if (step == 1) {
        lo += cnt;
        break;
      }
      // probes 0..cnt-1 hold the row: the end lies in (p[cnt-1], p[cnt]]
      const int64_t nlo = cnt > 0 ? lo + (int64_t)(cnt - 1) * step + 1 : lo;
      const int64_t nhi = lo + (int64_t)cnt * step;
      lo = nlo;
      hi = nhi < hi ? nhi : hi;
      if (cnt == 0) break;
    }
    const int64_t end = lo;
    const int64_t stages = (end - j0 + ts - 1) / ts;

    for (int64_t c0 = 0; c0 < dim; c0 += win) {
      const int w = (int)(dim - c0 < win ? dim - c0 : win);
      if (wid >= cw) {
        // ---- loader warp: stages wid - cw, + lw, ... ----
        const int vpr = w / CB;                   // vectors a row
        const int vshift = (vpr & (vpr - 1)) == 0 ? __ffs(vpr) - 1 : -1;
        // stage m's ring slot r and the count of its slot's earlier uses,
        // stepped without dividing: stage streamed + m
        int r = (int)((streamed + (wid - cw)) % nring);
        int use = (int)((streamed + (wid - cw)) / nring);
        for (int64_t m = wid - cw; m < stages; m += lw) {
          if (use > 0) mbar_wait(&s_empty[r], (unsigned)((use - 1) & 1));
          const int64_t p0 = j0 + m * ts;
          const int cnt = (int)(end - p0 < ts ? end - p0 : ts);
          float* gdst = ring_g + (size_t)r * ts * win;
          float* cdst = ring_c + (size_t)r * ts;
          // slot ids, then coefficients (0 past the run: skipped)
          for (int t = lane; t < ts; t += 32) {
            const int64_t sid = t < cnt ? slots[p0 + t] : 0;
            ids[t] = sid;
            cdst[t] = t < cnt ? coeff[sid] : 0.0f;
          }
          __syncwarp();
          // g rows, 16 vectors a lane per round trip
          const int total = cnt * vpr;
          for (int q0 = 0; q0 < total; q0 += 32 * 16) {
            float v[16][CB];
#pragma unroll
            for (int u = 0; u < 16; ++u) {
              const int q = q0 + lane + 32 * u;
              if (q < total) {
                const int t = vshift >= 0 ? q >> vshift : q / vpr;
                load_vec<CB>(v[u], g + (int64_t)bag_of(ids[t], k_slots,
                                                      k_shift) * dim +
                                      c0 + (q - t * vpr) * CB);
              }
            }
#pragma unroll
            for (int u = 0; u < 16; ++u) {
              const int q = q0 + lane + 32 * u;
              if (q < total) {
                const int t = vshift >= 0 ? q >> vshift : q / vpr;
                store_vec<CB>(gdst + t * win + (q - t * vpr) * CB, v[u]);
              }
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(&s_full[r]);
          for (r += lw; r >= nring; r -= nring) ++use;
        }
      } else {
        // ---- consumer warp: the column chains, stage by stage ----
        float acc = accumulate && tid < w ? out[(int64_t)row * dim + c0 + tid]
                                          : 0.0f;
        int r = (int)(streamed % nring);
        unsigned phase = (unsigned)((streamed / nring) & 1);
        for (int64_t i = 0; i < stages; ++i) {
          mbar_wait(&s_full[r], phase);
          if (tid < w) {
            const int64_t left = end - (j0 + i * ts);
            // ts is a multiple of 8 and a stage's slots past the run have
            // coefficient 0, so the chain runs in whole groups of 8
            const int cnt = (int)(left < ts ? (left + 7) & ~7LL : ts);
            const float* gs = ring_g + (size_t)r * ts * win + tid;
            const float* cs = ring_c + (size_t)r * ts;
            // the next group's operands are read before this group's
            // FMAs, which select (not branch) on the coefficient
            float cn[8], gn[8];
            const float4* cs4 = reinterpret_cast<const float4*>(cs);
            auto read8 = [&](int t0) {         // coefficients: broadcast
              const float4 a = cs4[t0 / 4], b = cs4[t0 / 4 + 1];
              cn[0] = a.x; cn[1] = a.y; cn[2] = a.z; cn[3] = a.w;
              cn[4] = b.x; cn[5] = b.y; cn[6] = b.z; cn[7] = b.w;
#pragma unroll
              for (int x = 0; x < 8; ++x) gn[x] = gs[(size_t)(t0 + x) * win];
            };
            read8(0);
            for (int t0 = 0; t0 < cnt; t0 += 8) {
              float cc[8], gc[8];
#pragma unroll
              for (int x = 0; x < 8; ++x) {
                cc[x] = cn[x];
                gc[x] = gn[x];
              }
              if (t0 + 8 < cnt) read8(t0 + 8);
#pragma unroll
              for (int x = 0; x < 8; ++x)
                acc = cc[x] != 0.0f ? __fmaf_rn(cc[x], gc[x], acc) : acc;
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(&s_empty[r]);
          if (++r == nring) {
            r = 0;
            phase ^= 1u;
          }
        }
        if (tid < w) out[(int64_t)row * dim + c0 + tid] = acc;
      }
      streamed += stages;
      __syncthreads();   // every stage consumed: the next window or run
    }
  }
}

// ---- pass 3: light runs, a group of G lanes a run ------------------------

// A group of G lanes owns the runs whose heads lie in its stretch of
// kStretch sorted positions, except runs longer than `heavy` (the heavy
// pass owns those; heavy >= kStretch, so no run of ours follows one in the
// stretch).  The group streams the positions from the stretch's start in
// batches of 32; each lane holds VEC columns and walks a batch's 32 slots
// in order, storing a row when the next run's head comes.  So a batch
// keeps 32 slots' loads in flight however short the runs.  A batch's rows
// and slot ids arrive with the previous batch's g rows; its coefficients
// and g rows then take one round trip.  The stream ends at the first head
// of a run that is not ours, or past the stretch with no run of ours open.
template <int VEC, int G>
__global__ void __launch_bounds__(kLightThreads, 2)
light_rows_kernel(const float* __restrict__ g,
                  const int32_t* __restrict__ rows,
                  const int64_t* __restrict__ slots,
                  const float* __restrict__ coeff, float* __restrict__ out,
                  int64_t n, int k_slots, int k_shift, int64_t dim,
                  int heavy, int accumulate) {
  constexpr int R = 32 / G;              // groups a warp
  constexpr int P = 32 / G;              // batch slots a lane loads
  constexpr int CH = VEC == 4 ? 16 : 32; // g loads in flight a lane
  constexpr unsigned kGroupBits = G == 32 ? kFull : (1u << G) - 1u;
  const int lane = threadIdx.x & 31;
  const int grp = lane / G;
  const int gl = lane - grp * G;
  const unsigned gmask = kGroupBits << (grp * G);
  const int64_t a =
      (((int64_t)blockIdx.x * (kLightThreads / 32) + (threadIdx.x >> 5)) *
           R + grp) * kLightStretch<G>;
  if (a >= n) return;
  const int64_t b = a + kLightStretch<G> < n ? a + kLightStretch<G> : n;

  // the group's mask of batch slots t = u * G + l whose flag f[u] is set
  // in lane l
  auto batch_mask = [&](const bool (&f)[P]) {
    unsigned m = 0;
#pragma unroll
    for (int u = 0; u < P; ++u)
      m |= ((__ballot_sync(gmask, f[u]) >> (grp * G)) & kGroupBits)
           << (u * G);
    return m;
  };

  for (int64_t c0 = 0; c0 < dim; c0 += (int64_t)G * VEC) {
    const int64_t col = c0 + (int64_t)gl * VEC;
    const bool active = col < dim;
    // this lane's batch positions: rows, the row `heavy` places on (a
    // head's run is heavy iff it still holds the head's row), slot ids
    int32_t r[P], rh[P];
    int64_t sid[P];
    auto load_batch = [&](int64_t p) {
#pragma unroll
      for (int u = 0; u < P; ++u) {
        const int64_t q = p + gl + (int64_t)u * G;
        r[u] = q < n ? rows[q] : -1;
        rh[u] = q + heavy < n ? rows[q + heavy] : -1;
        sid[u] = q < n ? slots[q] : 0;
      }
    };
    int32_t before = a > 0 ? rows[a - 1] : -1;   // the row before a batch
    load_batch(a);
    bool own = false;                    // the open run is ours
    int32_t open = 0;                    // and its row
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
    for (int64_t p = a;; p += 32) {
      bool hd[P], mine[P];
      int32_t rows_here[P];
#pragma unroll
      for (int u = 0; u < P; ++u) {
        // the row one position earlier: this lane's left neighbour, or
        // the group's last lane one batch slot earlier, or `before`
        const int32_t up = __shfl_up_sync(gmask, r[u], 1, G);
        const int32_t wrap = __shfl_sync(gmask, r[u > 0 ? u - 1 : 0], G - 1,
                                         G);
        const int32_t left = gl > 0 ? up : (u > 0 ? wrap : before);
        const int64_t q = p + u * G + gl;
        hd[u] = q < n && (q == 0 || left != r[u]);
        mine[u] = hd[u] && q < b && rh[u] != r[u];
        rows_here[u] = r[u];
      }
      const unsigned heads = batch_mask(hd), owned = batch_mask(mine);
      // a slot is live if the run it lies in is ours
      bool live[P];
#pragma unroll
      for (int u = 0; u < P; ++u) {
        const int t = u * G + gl;
        const unsigned upto = heads & (t == 31 ? kFull : (2u << t) - 1u);
        live[u] = p + t < n &&
                  (upto ? ((owned >> (31 - __clz(upto))) & 1u) != 0 : own);
      }
      const unsigned live_mask = batch_mask(live);
      const bool own_after =
          heads ? ((owned >> (31 - __clz(heads))) & 1u) != 0 : own;
      const bool last = (heads & ~owned) != 0 || p + 32 >= n ||
                        (!own_after && p + 32 >= b);
      // coefficients and g rows of the live slots: one round trip, with
      // the next batch's rows and slot ids
      float cu[P];
      int32_t bu[P];
#pragma unroll
      for (int u = 0; u < P; ++u) {
        cu[u] = live[u] ? coeff[sid[u]] : 0.0f;
        bu[u] = bag_of(sid[u], k_slots, k_shift);
      }
      const int32_t row_last = __shfl_sync(gmask, r[P - 1], G - 1, G);
#pragma unroll
      for (int t0 = 0; t0 < 32; t0 += CH) {
        float gv[CH][VEC];
#pragma unroll
        for (int x = 0; x < CH; ++x) {
          const int t = t0 + x;
          const int32_t bt = __shfl_sync(gmask, bu[t / G], t % G, G);
          if (((live_mask >> t) & 1u) && active) {
            load_vec<VEC>(gv[x], g + (int64_t)bt * dim + col);
          } else {
#pragma unroll
            for (int v = 0; v < VEC; ++v) gv[x][v] = 0.0f;
          }
        }
        if (t0 == 0 && !last) {
          before = row_last;
          load_batch(p + 32);
        }
#pragma unroll
        for (int x = 0; x < CH; ++x) {
          const int t = t0 + x;
          const float ct = __shfl_sync(gmask, cu[t / G], t % G, G);
          const int32_t rt = __shfl_sync(gmask, rows_here[t / G], t % G, G);
          if ((heads >> t) & 1u) {       // a run starts: close the open one
            if (own && active)
              store_vec<VEC>(out + (int64_t)open * dim + col, acc);
            own = ((owned >> t) & 1u) != 0;
            open = rt;
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
            if (accumulate && own && active)
              load_vec<VEC>(acc, out + (int64_t)open * dim + col);
          }
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            acc[v] = ct != 0.0f ? __fmaf_rn(ct, gv[x][v], acc[v]) : acc[v];
        }
      }
      if (last) break;
    }
    if (own && active) store_vec<VEC>(out + (int64_t)open * dim + col, acc);
  }
}

// ---- launch ---------------------------------------------------------------

constexpr int kMaxDevices = 64;

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess)
      count = 132;
  }
  return count;
}

template <int CB>
int launch_heavy(const float* g, const int32_t* rows, const int64_t* slots,
                 const float* coeff, float* out, int64_t n, int k_slots,
                 int k_shift, int64_t dim, int32_t* meta, int cap,
                 int accumulate, cudaStream_t st) {
  const int win = (int)(dim < kHeavyWindow ? dim : kHeavyWindow);
  const int lw = kHeavyThreads / 32 - (win + 31) / 32;
  // a stage: 16 vectors a loader lane, a multiple of 8 slots
  int ts = 16 * 32 * CB / win;
  ts = ts > kMaxStageSlots ? kMaxStageSlots : (ts < 8 ? 8 : ts & ~7);
  const int stage_bytes = ts * (win + 1) * 4;
  const int id_bytes = lw * ts * 8;
  int nring = (kHeavySmem - id_bytes) / stage_bytes;
  nring = nring > kMaxRing ? kMaxRing : nring;
  if (nring < 2) return (int)cudaErrorInvalidValue;
  const int smem = nring * stage_bytes + id_bytes;
  auto kernel = heavy_rows_kernel<CB>;
  // the limit, once for each size on each device (a function's
  // attributes are the current device's)
  static int set_smem[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return (int)cudaErrorInvalidDevice;
  if (smem != set_smem[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    set_smem[dev] = smem;
  }
  const int blocks = sm_count() < cap ? sm_count() : cap;
  kernel<<<blocks, kHeavyThreads, smem, st>>>(g, rows, slots, coeff, out, n,
                                              k_slots, k_shift, dim, meta,
                                              cap, ts, nring, win,
                                              accumulate);
  return (int)cudaGetLastError();
}

template <int VEC, int G>
int launch_light(const float* g, const int32_t* rows, const int64_t* slots,
                 const float* coeff, float* out, int64_t n, int k_slots,
                 int k_shift, int64_t dim, int heavy, int accumulate,
                 cudaStream_t st) {
  // a heavy run inside a stretch must end past it (see the kernel)
  if (heavy < kLightStretch<G>) return (int)cudaErrorInvalidValue;
  const int64_t per_warp = kLightStretch<G> * (32 / G);
  const int64_t warps = (n + per_warp - 1) / per_warp;
  const int64_t blocks = (warps + kLightThreads / 32 - 1) /
                         (kLightThreads / 32);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  light_rows_kernel<VEC, G><<<(unsigned)blocks, kLightThreads, 0, st>>>(
      g, rows, slots, coeff, out, n, k_slots, k_shift, dim, heavy,
      accumulate);
  return (int)cudaGetLastError();
}

// The light rows' tiling: G lanes a group, so block_b = 32 / G runs a
// warp takes at once, and VEC columns a lane, so block_d = G * VEC columns
// a group pass.  Each row's columns are still chained over its run in
// sorted order by one lane each, so no tiling changes a bit.
struct LightTiling {
  int vec, g;
};

// The analytic pick: a full warp a row with the fewest column passes at D
// >= 32; at smaller D one column a lane and 32 / G rows a warp.
LightTiling analytic_light(int vec, int64_t dim) {
  if (dim >= 32) {
    const int64_t p1 = (dim + 31) / 32, p2 = (dim + 63) / 64,
                  p4 = (dim + 127) / 128;
    if (vec == 4 && p4 < p2) return LightTiling{4, 32};
    if (vec >= 2 && p2 < p1) return LightTiling{2, 32};
    return LightTiling{1, 32};
  }
  if (dim > 16) return LightTiling{1, 32};
  if (dim > 8) return LightTiling{1, 16};
  return LightTiling{1, 8};
}

// (block_b, block_d) -> a built light tiling (G 32, 16 or 8; VEC 1, 2 or
// 4, at most the access width `vec` that g and out allow).
bool light_tiling_of(int block_b, int block_d, int vec, LightTiling* t) {
  if (block_b != 1 && block_b != 2 && block_b != 4) return false;
  t->g = 32 / block_b;
  if (block_d % t->g != 0) return false;
  t->vec = block_d / t->g;
  return (t->vec == 1 || t->vec == 2 || t->vec == 4) && t->vec <= vec;
}

int launch_light_for(LightTiling t, const float* gp, const int32_t* rp,
                     const int64_t* sp, const float* cp, float* op,
                     int64_t n, int k_slots, int k_shift, int64_t dim,
                     int heavy, int acc, cudaStream_t st) {
#define LIGHT(V, G)                                                         \
  if (t.vec == V && t.g == G)                                               \
    return launch_light<V, G>(gp, rp, sp, cp, op, n, k_slots, k_shift, dim, \
                              heavy, acc, st);
  LIGHT(4, 32) LIGHT(2, 32) LIGHT(1, 32)
  LIGHT(4, 16) LIGHT(2, 16) LIGHT(1, 16)
  LIGHT(4, 8) LIGHT(2, 8) LIGHT(1, 8)
#undef LIGHT
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// rows: the B*K flat indices sorted stably (int32); slots: their
// positions b*K + k (int64), the permutation of that sort; coeff: (B, K)
// fp32 in slot order.  vec: 4, 2 or 1, the widest access g and out allow
// (dim % vec == 0 and both pointers 4*vec-byte aligned; the wrapper
// checks).  heavy: runs longer than this many slots (at least 256, the
// longest light stretch) take the block path.
// scratch: int32 [4 + cap], cap = n / (heavy + 1) + 1 (the most runs that
// can be longer than heavy).  accumulate: 0 starts each touched row's sum
// from 0, 1 from the row's value in out.  block_b, block_d: the light
// rows' tiling (see LightTiling; 0, 0 = the analytic pick; the heavy runs'
// blocks keep theirs).  Returns the cudaError_t of the launches (0 =
// success; an unbuilt tiling is cudaErrorInvalidValue).
extern "C" int bag_grad_launch(const void* g, const void* rows,
                               const void* slots, const void* coeff,
                               void* out, long long n, int k_slots,
                               long long dim, int vec, int heavy,
                               void* scratch, int cap, int accumulate,
                               int block_b, int block_d, void* stream) {
  const float* gp = static_cast<const float*>(g);
  const int32_t* rp = static_cast<const int32_t*>(rows);
  const int64_t* sp = static_cast<const int64_t*>(slots);
  const float* cp = static_cast<const float*>(coeff);
  float* op = static_cast<float*>(out);
  int32_t* meta = static_cast<int32_t*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || dim <= 0) return 0;
  if (k_slots <= 0 || heavy <= 0 || n >= 0x7fffffffLL ||
      (vec != 1 && vec != 2 && vec != 4) || dim % vec != 0)
    return (int)cudaErrorInvalidValue;
  const int k_shift =
      (k_slots & (k_slots - 1)) == 0 ? __builtin_ctz((unsigned)k_slots) : -1;
  LightTiling lt = analytic_light(vec, dim);
  if ((block_b != 0 || block_d != 0) &&
      !light_tiling_of(block_b, block_d, vec, &lt))
    return (int)cudaErrorInvalidValue;

  if (n <= heavy)                        // no run can be heavy
    return launch_light_for(lt, gp, rp, sp, cp, op, n, k_slots, k_shift,
                            dim, heavy, accumulate, st);
  if (cap < n / (heavy + 1) + 1) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      cudaMemsetAsync(meta, 0, kMeta * sizeof(int32_t), st);
  if (err != cudaSuccess) return (int)err;
  const int64_t want = (n + kFindThreads - 1) / kFindThreads;
  const int64_t most = (int64_t)sm_count() * 16;
  find_heavy_kernel<<<(unsigned)(want < most ? want : most), kFindThreads, 0,
                      st>>>(rp, n, heavy, meta, cap);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  rc = vec == 4 ? launch_heavy<4>(gp, rp, sp, cp, op, n, k_slots, k_shift,
                                  dim, meta, cap, accumulate, st)
     : vec == 2 ? launch_heavy<2>(gp, rp, sp, cp, op, n, k_slots, k_shift,
                                  dim, meta, cap, accumulate, st)
                : launch_heavy<1>(gp, rp, sp, cp, op, n, k_slots, k_shift,
                                  dim, meta, cap, accumulate, st);
  if (rc != 0) return rc;
  return launch_light_for(lt, gp, rp, sp, cp, op, n, k_slots, k_shift, dim,
                          heavy, accumulate, st);
}

// The light rows' analytic tiling for g and out of access width `vec`:
// out[0] = runs a warp takes at once (32 / G), out[1] = columns a group
// pass (G * VEC).
extern "C" int bag_grad_tiling(int vec, long long dim, int* out) {
  if (dim <= 0 || (vec != 1 && vec != 2 && vec != 4))
    return (int)cudaErrorInvalidValue;
  const LightTiling t = analytic_light(vec, dim);
  out[0] = 32 / t.g;
  out[1] = t.g * t.vec;
  return 0;
}
