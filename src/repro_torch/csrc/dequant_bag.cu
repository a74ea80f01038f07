// Fused gather + row-wise dequant + bag reduction for Hopper (sm_90a).
//
// Replaces repro/kernels/dequant_bag/kernel.py::dequant_bag_pallas, the
// TPU serving gather behind SHARK's tier-partitioned store:
//
//   out[b, :] = sum_k (f32(payload[idx[b,k], :]) * scale[idx[b,k]]) * w[b,k]
//
// Two entries:
//
// * dequant_bag_launch, one tier: payload (V, D) int8 | bf16 | fp16 |
//   fp32, scales (V,) fp32 or null (unit scales: the fp32 tier), idx (B,
//   K) int32, w (B, K) fp32 -> out (B, D) fp32.  The train forward, the
//   rowgrid checks and ops.dequant_bag run it.
// * dequant_bag_tiered_launch, the packed store: what the reference's
//   packed_bag_lookup computes from the store's leaves (repro/kernels/
//   dequant_bag/ops.py:181-207: one dequant_bag_pallas a tier, the
//   partial bags summed), in one launch.  Inputs: indirect (V,) int32
//   words tier << 28 | local row, payload8 (V8, D) int8 + scale8, payload16
//   (V16, D) bf16 or fp16 + scale16, payload32 (V32, D) fp32, global ids
//   (B, K) int32 or int64, w (B, K) fp32 or null (ones).
//
// Contract with the reference (kernel.py:38-45): accumulate over k in
// order and multiply the scale in first, (row * s) * w.  Where the
// reference's tests run its kernel (Pallas interpret mode, XLA on the
// CPU), XLA fuses the weight product with the sum, so the reference
// computes acc = fma(row * s, w, acc).  Both entries write that FMA,
// __fmaf_rn(__fmul_rn(row, s), w, acc), so nvcc's contraction choices
// cannot change it; with unit scales the scale product is left out (row
// * 1.0f == row exactly).  A slot whose weight is 0 reads neither its row
// nor its scale.  The single-tier entry is bit-identical to the plain
// PyTorch version (repro_torch/kernels/dequant_bag/ref.py), which
// computes the same FMA exactly in float64.  The tiered entry keeps one
// FMA chain a tier and column in k order, its slots those of that tier
// (the composition gives the other tiers' slots weight 0, which they
// skip), and writes ((0 + o8) + o16) + o32 with __fadd_rn: the reference's
// zeros + int8 + half + fp32.  A NaN or +-inf weight gives the
// composition's other tiers the weight 0 * w = NaN, so they read their
// clamped rows and the bag comes out NaN in every column; the tiered entry
// writes that NaN without the reads.  It is bit-identical to the per-tier
// composition (ops.packed_bag_lookup_tiers), and at K = 1 to
// packed_store.lookup.
//
// Each tier comes with a shard window: its payload and scales hold local
// rows [first, first + rows) of the tier (rows may be 0).  A slot whose
// local row falls outside its tier's window weighs 0 and reads nothing;
// one inside reads row loc - first.  A whole store is the window
// [0, V_t) (a valid store never addresses past V_t); one shard of a
// row-sharded store (repro_torch/dist/packed.py) is the reference's
// _local_bags_fused (repro/dist/packed.py:164-195: one dequant_bag_pallas
// a tier a shard, other shards' slots weighted 0).  The NaN rule holds
// in every window: the reference's mine * w is NaN in every shard's every
// tier.
//
// What bounds it on an H100: bytes, and at a request's size the latency
// of its dependent loads.  Each live slot moves D * itemsize payload
// bytes (+4 for its scale) and its index and weight; each bag writes D *
// 4 output bytes; 3 flops a payload element is far below the card's ~20
// flops a byte.  A dlrm-rm2 request (13,312 slots, K = 1, D = 64) moves
// ~4 MB, ~1.2 us at 3.35 TB/s; its chain is id -> indirect word -> row,
// three trips to device memory after a cold L2, and the rows lie in a
// 5.2 GB int8 tier, so TLB misses add to the trips.  The training
// forward (1,703,936 slots, K = 1, D = 64 fp32) is a stream of ~0.87 GB.
//
// What held the parent back: each thread loaded w[k], branched on it,
// then loaded idx[k], then the row and scale: three dependent trips a
// slot and nothing in flight across k; rows whose D * itemsize was not a
// multiple of 16 (every xDeepFM tier, D = 10) fell back to one element a
// thread; and the packed store ran one launch a tier, each writing a full
// (B, D) output that was mostly zeros and added in, plus ~20 glue ops of
// splitting, masking and clamping.
//
// Design: a lane owns 4 consecutive columns of a row (gather_io.cuh),
// read with the widest loads the row's alignment allows (16 bytes for
// fp32 at D = 64, 2 bytes a piece for int8 at D = 10), so a bag is a
// group of ceil(D / 4) lanes, 256 / that many bags side by side in a
// block (16 bags at D = 64, 85 at D = 10).  A group walks NB bags and WK
// slots at once: it loads every index and weight of the window, then
// every live row and scale (the tiered entry first loads the window's
// indirect words), and only then runs the FMA chains, so NB * WK
// dependent trips overlap: at K = 1 NB = 4 bags (2 tiered) where that
// still gives every SM two blocks (the training forward's stream runs
// faster so), else one bag a group (a request's 13,312 or 19,968 bags
// then spread over every SM: with 4 a group xDeepFM's D = 10 tiers ran
// no faster than the parent's one element a thread); a window
// of 8 slots (4 tiered) at K > 1.  Bags are indexed within a
// block by 32-bit arithmetic; row offsets are int64: the full int8 tier
// holds ~81.7M rows x 64 = 5.2e9 elements.  Columns past 1,024 take
// further blocks along the grid's y axis.
//
// The single-tier entry takes a tiling (block_b bags and block_d columns a
// block: fewer lanes a group, or more bags a group), which the measured
// autotune cache (repro_torch/kernels/autotune.py) may pick; 0, 0 is the
// analytic rule above.  Each output element is one lane's FMA chain over k
// in order whatever the tiling, so a tiling changes no bit of the result.
// The tiered entry keeps its analytic pick.

#include "gather_io.cuh"

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using gather_io::elem;
using gather_io::raw_words;
using gather_io::read_cols;
using gather_io::write_cols;

constexpr int kThreads = 256;
constexpr int kCols = 4;              // columns a lane owns
constexpr int kTierShift = 28;
constexpr int32_t kIdxMask = (1 << kTierShift) - 1;

// The lane's group and columns: blockDim.x = kThreads lanes, `lanes` a
// group (ceil(D / 4), at most kThreads), `groups` groups a block.
struct Lane {
  int group;       // < groups, or the lane is idle
  int c0;          // first column
  int n;           // columns it owns (1..4), <= 0 past the row
};

__device__ __forceinline__ Lane lane_of(int lanes, int dim) {
  Lane l;
  l.group = threadIdx.x / lanes;
  const int j = threadIdx.x - l.group * lanes;
  l.c0 = (blockIdx.y * lanes + j) * kCols;
  l.n = min(kCols, dim - l.c0);
  return l;
}

template <typename T, int NB, int WK>
__global__ void __launch_bounds__(kThreads)
    bag_kernel(const T* __restrict__ payload,
               const float* __restrict__ scales,
               const int32_t* __restrict__ indices,
               const float* __restrict__ weights, float* __restrict__ out,
               int64_t num_bags, int k_slots, int dim, int lanes, int groups,
               int w_in, int w_out) {
  constexpr int R = raw_words<T, kCols>();
  const Lane l = lane_of(lanes, dim);
  if (l.group >= groups || l.n <= 0) return;
  const int64_t b0 = ((int64_t)blockIdx.x * groups + l.group) * NB;

  float acc[NB][kCols];
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;

  for (int k0 = 0; k0 < k_slots; k0 += WK) {
    int32_t row[NB][WK];
    float w[NB][WK];
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int kk = 0; kk < WK; ++kk) {
        const int64_t b = b0 + i;
        const int k = k0 + kk;
        w[i][kk] = 0.0f;
        row[i][kk] = 0;
        if (b < num_bags && k < k_slots) {
          const int64_t at = b * k_slots + k;
          w[i][kk] = __ldg(weights + at);
          row[i][kk] = __ldg(indices + at);
        }
      }
    uint32_t raw[NB][WK][R];
    float s[NB][WK];
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int kk = 0; kk < WK; ++kk) {
#pragma unroll
        for (int r = 0; r < R; ++r) raw[i][kk][r] = 0u;
        s[i][kk] = 1.0f;
        if (w[i][kk] != 0.0f) {
          const int64_t r = row[i][kk];
          read_cols<T, kCols>(payload + r * dim + l.c0, l.n, w_in,
                              raw[i][kk]);
          if (scales != nullptr) s[i][kk] = __ldg(scales + r);
        }
      }
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int kk = 0; kk < WK; ++kk) {
        if (w[i][kk] != 0.0f) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            float x = elem<T>(raw[i][kk], c);
            if (scales != nullptr) x = __fmul_rn(x, s[i][kk]);
            acc[i][c] = __fmaf_rn(x, w[i][kk], acc[i][c]);
          }
        }
      }
  }
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int64_t b = b0 + i;
    if (b < num_bags) write_cols<kCols>(out + b * dim + l.c0, l.n, w_out,
                                        acc[i]);
  }
}

// One tier's leaves: payload rows, scales (null: unit), the first local
// row the payload holds, its rows and load width.
template <typename T>
struct Tier {
  const T* payload;
  const float* scales;
  int32_t first;
  int32_t rows;
  int w;
};

// The payload row a slot of tier t at local row loc reads, or -1 when it
// falls outside [first, first + rows) and reads none.
__device__ __forceinline__ int32_t row_in(int32_t loc, int32_t first,
                                          int32_t rows) {
  const int32_t l = loc - first;
  return l >= 0 && l < rows ? l : -1;
}

template <typename H, typename I, int NB, int WK>
__global__ void __launch_bounds__(kThreads)
    tiered_kernel(const int32_t* __restrict__ indirect, Tier<int8_t> t8,
                  Tier<H> t16, Tier<float> t32, const I* __restrict__ ids,
                  const float* __restrict__ weights, float* __restrict__ out,
                  int64_t num_bags, int k_slots, int dim, int lanes,
                  int groups, int w_out) {
  constexpr int R = raw_words<float, kCols>();   // room for any tier
  const Lane l = lane_of(lanes, dim);
  if (l.group >= groups || l.n <= 0) return;
  const int64_t b0 = ((int64_t)blockIdx.x * groups + l.group) * NB;

  float a8[NB][kCols], a16[NB][kCols], a32[NB][kCols];
  bool poison[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    poison[i] = false;
#pragma unroll
    for (int c = 0; c < kCols; ++c) a8[i][c] = a16[i][c] = a32[i][c] = 0.0f;
  }

  for (int k0 = 0; k0 < k_slots; k0 += WK) {
    int64_t id[NB][WK];
    float w[NB][WK];
    bool in[NB][WK];
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int kk = 0; kk < WK; ++kk) {
        const int64_t b = b0 + i;
        const int k = k0 + kk;
        in[i][kk] = b < num_bags && k < k_slots;
        id[i][kk] = 0;
        w[i][kk] = 0.0f;
        if (in[i][kk]) {
          const int64_t at = b * k_slots + k;
          id[i][kk] = (int64_t)__ldg(ids + at);
          w[i][kk] = weights != nullptr ? __ldg(weights + at) : 1.0f;
        }
      }
    int32_t code[NB][WK];
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int kk = 0; kk < WK; ++kk)
        code[i][kk] = in[i][kk] && w[i][kk] != 0.0f
                          ? __ldg(indirect + id[i][kk]) : -1;
    uint32_t raw[NB][WK][R];
    float s[NB][WK];
    int tier[NB][WK];
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int kk = 0; kk < WK; ++kk) {
#pragma unroll
        for (int r = 0; r < R; ++r) raw[i][kk][r] = 0u;
        s[i][kk] = 1.0f;
        // a non-finite weight: the other tiers' 0 * w is NaN
        if (in[i][kk] && !isfinite(w[i][kk])) poison[i] = true;
        // tier 3 (no valid code, or a row outside the tier's window)
        // weighs 0 in every tier's launch
        int t = code[i][kk] < 0 ? 3 : code[i][kk] >> kTierShift;
        const int32_t loc = code[i][kk] & kIdxMask;
        int32_t r = -1;
        if (t == 0) r = row_in(loc, t8.first, t8.rows);
        else if (t == 1) r = row_in(loc, t16.first, t16.rows);
        else if (t == 2) r = row_in(loc, t32.first, t32.rows);
        if (r < 0) t = 3;
        tier[i][kk] = t;
        const int64_t r64 = r;
        if (t == 0) {
          read_cols<int8_t, kCols>(t8.payload + r64 * dim + l.c0, l.n, t8.w,
                                   raw[i][kk]);
          s[i][kk] = __ldg(t8.scales + r64);
        } else if (t == 1) {
          read_cols<H, kCols>(t16.payload + r64 * dim + l.c0, l.n, t16.w,
                              raw[i][kk]);
          s[i][kk] = __ldg(t16.scales + r64);
        } else if (t == 2) {
          read_cols<float, kCols>(t32.payload + r64 * dim + l.c0, l.n,
                                  t32.w, raw[i][kk]);
        }
      }
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int kk = 0; kk < WK; ++kk) {
        const int t = tier[i][kk];
        if (t > 2) continue;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          float x;
          if (t == 0)
            x = __fmul_rn(elem<int8_t>(raw[i][kk], c), s[i][kk]);
          else if (t == 1)
            x = __fmul_rn(elem<H>(raw[i][kk], c), s[i][kk]);
          else
            x = elem<float>(raw[i][kk], c);
          const float a = t == 0 ? a8[i][c] : t == 1 ? a16[i][c] : a32[i][c];
          const float y = __fmaf_rn(x, w[i][kk], a);
          a8[i][c] = t == 0 ? y : a8[i][c];
          a16[i][c] = t == 1 ? y : a16[i][c];
          a32[i][c] = t == 2 ? y : a32[i][c];
        }
      }
  }
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int64_t b = b0 + i;
    if (b >= num_bags) continue;
    float o[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      o[c] = poison[i] ? __int_as_float(0x7fffffff)
                       : __fadd_rn(__fadd_rn(__fadd_rn(0.0f, a8[i][c]),
                                             a16[i][c]), a32[i][c]);
    write_cols<kCols>(out + b * dim + l.c0, l.n, w_out, o);
  }
}

// Lanes a bag group (<= kThreads), bags a block and the grid for a launch
// of `lanes` lanes a group, each group walking `nb` bags.
struct Shape {
  int lanes, groups;
  dim3 grid;
  bool ok;
};

Shape shape_of(int64_t num_bags, int64_t dim, int nb, int lanes) {
  Shape sh;
  const int64_t col_lanes = (dim + kCols - 1) / kCols;
  sh.lanes = lanes;
  sh.groups = kThreads / sh.lanes;
  const int64_t per_block = (int64_t)sh.groups * nb;
  const int64_t bx = (num_bags + per_block - 1) / per_block;
  const int64_t by = (col_lanes + sh.lanes - 1) / sh.lanes;
  sh.grid = dim3((unsigned)bx, (unsigned)by);
  sh.ok = bx <= 0x7fffffffLL && by <= 65535 && dim <= 0x7fffffffLL;
  return sh;
}

// Lanes a group for every column of a row at once (up to kThreads).
int row_lanes(int64_t dim) {
  const int64_t col_lanes = (dim + kCols - 1) / kCols;
  return (int)(col_lanes < kThreads ? col_lanes : kThreads);
}

int out_width(const void* out, int64_t dim) {
  return gather_io::piece_bytes(out, dim * 4, 16);
}

template <typename T>
int in_width(const void* payload, int64_t dim) {
  const int cap = kCols * (int)sizeof(T) < 16 ? kCols * (int)sizeof(T) : 16;
  return gather_io::piece_bytes(payload, dim * (int64_t)sizeof(T), cap);
}

// Bags a group walks at once at K = 1: `nb` where that still gives every
// SM two blocks, else 1 (a request's few bags spread over more SMs).
int bags_at_once(int64_t num_bags, int64_t dim, int nb) {
  static const int sms = [] {
    int dev = 0, n = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return shape_of(num_bags, dim, nb, row_lanes(dim)).grid.x >=
                 2u * (unsigned)sms
             ? nb
             : 1;
}

// The single-tier entry's tiling: `lanes` lanes a bag group (block_d =
// 4 * lanes columns a block) and `nb` bags a group walks at once (block_b
// = nb * (kThreads / lanes) bags a block).  Every tiling gives each
// output element the same FMA chain over k in one lane, so no tiling can
// change a result: a measured pick is safe to serve.
struct Tiling {
  int lanes, nb;
};

// The analytic pick: a row's columns in one group; at K = 1 four bags a
// group where that still gives every SM two blocks, else one; one bag a
// group at K > 1 (a window of 8 slots).
Tiling analytic_tiling(int64_t num_bags, int k_slots, int64_t dim) {
  return Tiling{row_lanes(dim),
                k_slots == 1 ? bags_at_once(num_bags, dim, 4) : 1};
}

// (block_b, block_d) -> a tiling; false where no kernel is built for it
// (nb 1, 2 or 4 at K = 1; 1 or 2 at K > 1, windows of 8 and 4 slots).
bool tiling_of(int block_b, int block_d, int k_slots, Tiling* tl) {
  if (block_d < kCols || block_d % kCols != 0 || block_d > kCols * kThreads)
    return false;
  tl->lanes = block_d / kCols;
  const int groups = kThreads / tl->lanes;
  if (block_b < groups || block_b % groups != 0) return false;
  tl->nb = block_b / groups;
  return tl->nb == 1 || tl->nb == 2 || (k_slots == 1 && tl->nb == 4);
}

template <typename T>
int launch(const void* payload, const float* scales, const int32_t* indices,
           const float* weights, float* out, int64_t num_bags, int k_slots,
           int64_t dim, int block_b, int block_d, cudaStream_t stream) {
  Tiling tl;
  if (block_b == 0 && block_d == 0)
    tl = analytic_tiling(num_bags, k_slots, dim);
  else if (!tiling_of(block_b, block_d, k_slots, &tl))
    return (int)cudaErrorInvalidValue;
  const Shape sh = shape_of(num_bags, dim, tl.nb, tl.lanes);
  if (!sh.ok) return (int)cudaErrorInvalidConfiguration;
  const T* p = static_cast<const T*>(payload);
  const int wi = in_width<T>(payload, dim), wo = out_width(out, dim);
#define BAG_LAUNCH(NB, WK)                                                  \
  bag_kernel<T, NB, WK><<<sh.grid, kThreads, 0, stream>>>(                  \
      p, scales, indices, weights, out, num_bags, k_slots, (int)dim,       \
      sh.lanes, sh.groups, wi, wo)
  if (k_slots == 1 && tl.nb == 4)
    BAG_LAUNCH(4, 1);
  else if (k_slots == 1 && tl.nb == 2)
    BAG_LAUNCH(2, 1);
  else if (k_slots == 1)
    BAG_LAUNCH(1, 1);
  else if (tl.nb == 2)
    BAG_LAUNCH(2, 4);
  else
    BAG_LAUNCH(1, 8);
#undef BAG_LAUNCH
  return (int)cudaGetLastError();
}

template <typename H, typename I>
int launch_tiered(const int32_t* indirect, Tier<int8_t> t8, Tier<H> t16,
                  Tier<float> t32, const void* ids, const float* weights,
                  float* out, int64_t num_bags, int k_slots, int64_t dim,
                  cudaStream_t stream) {
  const int nb = k_slots == 1 ? bags_at_once(num_bags, dim, 2) : 1;
  const Shape sh = shape_of(num_bags, dim, nb, row_lanes(dim));
  if (!sh.ok) return (int)cudaErrorInvalidConfiguration;
  const I* i = static_cast<const I*>(ids);
  const int wo = out_width(out, dim);
  if (nb == 2)
    tiered_kernel<H, I, 2, 1><<<sh.grid, kThreads, 0, stream>>>(
        indirect, t8, t16, t32, i, weights, out, num_bags, k_slots,
        (int)dim, sh.lanes, sh.groups, wo);
  else if (k_slots == 1)
    tiered_kernel<H, I, 1, 1><<<sh.grid, kThreads, 0, stream>>>(
        indirect, t8, t16, t32, i, weights, out, num_bags, k_slots,
        (int)dim, sh.lanes, sh.groups, wo);
  else
    tiered_kernel<H, I, 1, 4><<<sh.grid, kThreads, 0, stream>>>(
        indirect, t8, t16, t32, i, weights, out, num_bags, k_slots,
        (int)dim, sh.lanes, sh.groups, wo);
  return (int)cudaGetLastError();
}

template <typename T>
Tier<T> tier_of(const void* payload, const void* scales, long long first,
                long long rows, long long dim) {
  return Tier<T>{static_cast<const T*>(payload),
                 static_cast<const float*>(scales), (int32_t)first,
                 (int32_t)rows, in_width<T>(payload, dim)};
}

template <typename H>
int tiered_by_ids(const int32_t* indirect, Tier<int8_t> t8, Tier<H> t16,
                  Tier<float> t32, const void* ids, int ids64,
                  const float* weights, float* out, int64_t num_bags,
                  int k_slots, int64_t dim, cudaStream_t stream) {
  if (ids64)
    return launch_tiered<H, int64_t>(indirect, t8, t16, t32, ids, weights,
                                     out, num_bags, k_slots, dim, stream);
  return launch_tiered<H, int32_t>(indirect, t8, t16, t32, ids, weights, out,
                                   num_bags, k_slots, dim, stream);
}

}  // namespace

// dtype: 0 = int8, 1 = bf16, 2 = fp32, 3 = fp16 (the strict_fp16 half
// tier).  vec: 1, or 16 / itemsize when every row starts on a 16-byte
// boundary (the wrapper checks); the entry reads rows with the widest
// loads that the payload pointer and D allow, so vec only has to be one
// of the two.  block_b, block_d: the tiling, bags and columns a block
// (see Tiling; 0, 0 = the analytic pick).  Returns the cudaError_t of the
// launch (0 = success; an unbuilt tiling is cudaErrorInvalidValue).
extern "C" int dequant_bag_launch(const void* payload, int dtype,
                                  const void* scales, const void* indices,
                                  const void* weights, void* out,
                                  long long num_bags, int k_slots,
                                  long long dim, int vec, int block_b,
                                  int block_d, void* stream) {
  const float* s = static_cast<const float*>(scales);
  const int32_t* i = static_cast<const int32_t*>(indices);
  const float* w = static_cast<const float*>(weights);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_bags <= 0 || dim <= 0) return 0;
  if (k_slots < 0 || block_b < 0 || block_d < 0)
    return (int)cudaErrorInvalidValue;
  const int itemsize[4] = {1, 2, 4, 2};
  if (dtype < 0 || dtype > 3 || (vec != 1 && vec != 16 / itemsize[dtype]))
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch<int8_t>(payload, s, i, w, o, num_bags, k_slots, dim,
                             block_b, block_d, st);
    case 1:
      return launch<__nv_bfloat16>(payload, s, i, w, o, num_bags, k_slots,
                                   dim, block_b, block_d, st);
    case 2:
      return launch<float>(payload, s, i, w, o, num_bags, k_slots, dim,
                            block_b, block_d, st);
    case 3:
      return launch<__half>(payload, s, i, w, o, num_bags, k_slots, dim,
                             block_b, block_d, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The packed store, or one shard of it, in one launch.  half_dtype: 1 =
// bf16, 3 = fp16 (the codes of dequant_bag_launch); each tier's payload
// and scales hold its local rows [first, first + rows) (a whole store:
// first 0, rows V_t; rows may be 0); ids64: 1 for int64 ids, 0 for int32;
// weights may be null (ones).  Returns the cudaError_t of the launch (0 =
// success).
extern "C" int dequant_bag_tiered_launch(
    const void* indirect, const void* payload8, const void* scale8,
    long long first8, long long rows8, const void* payload16,
    int half_dtype, const void* scale16, long long first16,
    long long rows16, const void* payload32, long long first32,
    long long rows32, const void* ids, int ids64, const void* weights,
    void* out, long long num_bags, int k_slots, long long dim,
    void* stream) {
  const int32_t* ind = static_cast<const int32_t*>(indirect);
  const float* w = static_cast<const float*>(weights);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_bags <= 0 || dim <= 0) return 0;
  const long long cap = kIdxMask + 1LL;
  if (k_slots < 0 || rows8 < 0 || rows16 < 0 || rows32 < 0 || first8 < 0 ||
      first16 < 0 || first32 < 0 || first8 + rows8 > cap ||
      first16 + rows16 > cap || first32 + rows32 > cap)
    return (int)cudaErrorInvalidValue;
  const Tier<int8_t> t8 = tier_of<int8_t>(payload8, scale8, first8, rows8,
                                          dim);
  const Tier<float> t32 = tier_of<float>(payload32, nullptr, first32, rows32,
                                         dim);
  if (half_dtype == 1)
    return tiered_by_ids<__nv_bfloat16>(
        ind, t8,
        tier_of<__nv_bfloat16>(payload16, scale16, first16, rows16, dim),
        t32, ids, ids64, w, o, num_bags, k_slots, dim, st);
  if (half_dtype == 3)
    return tiered_by_ids<__half>(
        ind, t8, tier_of<__half>(payload16, scale16, first16, rows16, dim),
        t32, ids, ids64, w, o, num_bags, k_slots, dim, st);
  return (int)cudaErrorInvalidValue;
}

// The single-tier entry's analytic tiling for a launch of this shape on
// the current device: out[0] = bags a block, out[1] = columns a block.
extern "C" int dequant_bag_tiling(long long num_bags, int k_slots,
                                  long long dim, int* out) {
  if (num_bags <= 0 || dim <= 0 || k_slots < 0)
    return (int)cudaErrorInvalidValue;
  const Tiling tl = analytic_tiling(num_bags, k_slots, dim);
  out[0] = tl.nb * (kThreads / tl.lanes);
  out[1] = tl.lanes * kCols;
  return 0;
}
