// Fused chunk-pool gather + scale/sign combine for Hopper (sm_90a).
//
// Replaces repro/kernels/hashed_gather/kernel.py::hashed_gather_pallas,
// the serving hot path of the ROBE-style hashed store, where no row is
// stored and each is materialised from a shared (S, Z) chunk pool:
//
//   out[b, c*Z + z] = sum_t (f32(pool[slot[b,c*T+t], z]) * scale[slot])
//                           * coeff[b, c*T+t]
//
// pool (S, Z) fp32 | int8, scales (S,) fp32 or null (unit scales),
// T = K * num_hashes slots per (bag, chunk), chunk-major.  Two entries:
//
// * hashed_gather_launch takes the slot plan: slots (B, C*T) int32 in
//   [0, S), coeff (B, C*T) fp32 (sign x bag weight; 0 = padded or masked
//   slot), as the reference builds it outside its kernel.  The training
//   twin and the plan-taking op run it.
// * hashed_gather_ids_launch takes the bag ids (B, K) int32 or int64 and
//   weights (B, K) fp32 or null (ones), and computes the plan in
//   registers: for (b, c, k, j), t = k * NH + j, the murmur3 finalizer of
//   ref.py:36-42 on uint32 key = id * 2654435761 + c * 0x85EBCA6B + j *
//   0xC2B2AE35 + salt (the id's low 32 bits, products and sums wrapping),
//   slot = h % S, sign = -1 where mix(h + 0x9E3779B1) >> 31, coeff = sign
//   * w: slot_plan + the plan-taking gather in one launch, with no plan in
//   memory.  Every hashed request, cache refresh and the fit's forward
//   run it.
//
// Contract with the reference: per (bag, chunk) the T slots are taken in
// order, a slot whose coefficient is 0 reads neither its row nor its
// scale, and each term accumulates as acc = fma(row * s, w, acc).  Where
// the reference's tests run its kernel (Pallas interpret mode, XLA on
// the CPU) its `out += (row * s) * w` is fused into that FMA.  Here every
// rounding is written out (__fmul_rn, __fmaf_rn), so nvcc's contraction
// choices cannot change it, and both entries are bit-identical to the
// plain PyTorch version (repro_torch/kernels/hashed_gather/ref.py, after
// ops.slot_plan for the ids entry), which computes the same FMA exactly
// in float64.  At K = 1 with +-1 signs every product is exact, so the
// serving lookup also equals the reference's jnp oracle.  With null
// scales the scale product is left out: row * 1.0f == row exactly.
//
// What bounds it on an H100: bytes.  The wide&deep pool (888,648 x 8 fp32
// or 2,369,727 x 8 int8, 27 MiB) sits in the 50 MB L2, so device memory
// sees the plan (8 bytes a slot, none for the ids entry), the ids (4 or 8
// bytes a bag) and the output (C * Z * 4 bytes a bag).  The fit's
// forward over all 22.2M rows (C 4, T 2, Z 8) writes 2.84 GB: with its
// 1.42 GB plan 1.28 ms at 3.35 TB/s, from the ids 0.87 ms.  A request
// (20,480 ids) is latency: id -> hash -> pool row -> output.  The hash is
// ~50 integer operations a slot (two finalizers and a 32-bit modulo), 9e9
// at the fit: about half the byte time at the card's integer rate, so it
// must not be done once a column.  What the byte bound leaves out holds
// the fit: each (bag, chunk) gathers NH pool rows of one 32-byte sector,
// 177.7M random sectors (5.7 GB) a launch, which the L2 serves far below
// device-memory rate; with a pool of a few thousand rows, which stays in
// L1, the same launch runs ~2x faster (scripts/gather_ab.py --fit-pool),
// and a pool larger than the L2 (the 8-bit store's 2.37M-row fp32 fit)
// runs ~2x slower.
//
// What held the parent back: one thread an output element, so each of a
// (bag, chunk)'s Z lanes loaded the same T slots and coefficients, its
// pool loads were 4 bytes (fp32) or 1 byte (int8), and each element paid
// two 64-bit divisions; the T slots were a chain of dependent loads; and
// the plan came from memory: ~40 small int64 ops a request outside the
// kernel, and 1.42 GB reread by each of the fit's 13 forward launches.
//
// Design: one thread owns a (bag, chunk)'s Z outputs (8 columns a thread,
// or 4 where Z <= 4; a Z over 8 takes more threads; two lanes of 4
// columns, each hashing one slot and sharing it by shuffle, so that a
// warp's stores cover whole sectors, ran no faster), a block 256 threads
// of whole bags, indexed within the block by 32-bit arithmetic.  A thread
// takes a window of T slots at once (2 where T <= 2, else 4): it loads or
// hashes their slots and coefficients (plan loads as 8- or 16-byte
// vectors where aligned), issues every live row load (Z = 8: two 16-byte
// loads fp32, one 8-byte load int8; narrower pieces where Z's rows are
// not aligned, as Z = 5), then runs the FMA chain in t order and writes
// its Z floats as float4s (float2 or float where the output row is not
// 16-byte aligned).  Row offsets are int64: the future all-row fit writes
// 7.9e9 outputs.

#include "gather_io.cuh"

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using gather_io::elem;
using gather_io::raw_words;
using gather_io::read_cols;
using gather_io::write_cols;

constexpr int kThreads = 256;
constexpr uint32_t kKnuth = 2654435761u;
constexpr uint32_t kMix1 = 0x85EBCA6Bu;
constexpr uint32_t kMix2 = 0xC2B2AE35u;
constexpr uint32_t kGold = 0x9E3779B1u;

__device__ __forceinline__ uint32_t mix(uint32_t h) {
  h ^= h >> 16;
  h *= kMix1;
  h ^= h >> 13;
  h *= kMix2;
  return h ^ (h >> 16);
}

// The thread's (bag, chunk) and columns: `lanes` threads a (bag, chunk)
// (ceil(Z / COLS)), `per_bag` = C * lanes threads a bag, `bags` bags a
// block.
struct Unit {
  int64_t b;       // bag, or >= num_bags: idle
  int c;           // chunk
  int z0, n;       // first column in the chunk, columns owned
};

template <int COLS>
__device__ __forceinline__ Unit unit_of(int num_chunks, int z, int lanes,
                                        int bags, int64_t num_bags) {
  Unit u;
  const int per_bag = num_chunks * lanes;
  const int bb = threadIdx.x / per_bag;
  const int rest = threadIdx.x - bb * per_bag;
  u.c = rest / lanes;
  const int j = rest - u.c * lanes;
  u.b = bb < bags ? (int64_t)blockIdx.x * bags + bb : num_bags;
  u.z0 = j * COLS;
  u.n = min(COLS, z - u.z0);
  return u;
}

// The window's terms in t order: acc = fma(row * s, w, acc) for each live
// slot, every row load issued before the first FMA.
template <typename T, int COLS, int WT>
__device__ __forceinline__ void accumulate(const T* __restrict__ pool,
                                           const float* __restrict__ scales,
                                           int z, const Unit& u, int w_in,
                                           const int32_t (&sl)[WT],
                                           const float (&cf)[WT],
                                           float (&acc)[COLS]) {
  constexpr int R = raw_words<T, COLS>();
  uint32_t raw[WT][R];
  float s[WT];
#pragma unroll
  for (int i = 0; i < WT; ++i) {
#pragma unroll
    for (int r = 0; r < R; ++r) raw[i][r] = 0u;
    s[i] = 1.0f;
    if (cf[i] != 0.0f) {
      const int64_t row = sl[i];
      read_cols<T, COLS>(pool + row * z + u.z0, u.n, w_in, raw[i]);
      if (scales != nullptr) s[i] = __ldg(scales + row);
    }
  }
#pragma unroll
  for (int i = 0; i < WT; ++i) {
    if (cf[i] != 0.0f) {
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        float x = elem<T>(raw[i], c);
        if (scales != nullptr) x = __fmul_rn(x, s[i]);
        acc[c] = __fmaf_rn(x, cf[i], acc[c]);
      }
    }
  }
}

__device__ __forceinline__ void from_bits(uint32_t x, int32_t& v) {
  v = (int32_t)x;
}
__device__ __forceinline__ void from_bits(uint32_t x, float& v) {
  v = __uint_as_float(x);
}

// WT consecutive 4-byte words from p (m of them live, the rest 0), `w`
// bytes a load (4, 8 or 16, dividing p's address and 4 * m).
template <typename V, int WT>
__device__ __forceinline__ void read_plan(const V* __restrict__ p, int m,
                                          int w, V (&out)[WT]) {
  static_assert(sizeof(V) == 4, "plan words are 4 bytes");
#pragma unroll
  for (int i = 0; i < WT; ++i) out[i] = V(0);
  if constexpr (WT % 4 == 0) {
    if (w >= 16) {
#pragma unroll
      for (int i = 0; i < WT; i += 4)
        if (i < m) {
          const uint4 x = __ldg(reinterpret_cast<const uint4*>(p + i));
          from_bits(x.x, out[i]);
          from_bits(x.y, out[i + 1]);
          from_bits(x.z, out[i + 2]);
          from_bits(x.w, out[i + 3]);
        }
      return;
    }
  }
  if (w >= 8) {
#pragma unroll
    for (int i = 0; i < WT; i += 2)
      if (i < m) {
        const uint2 x = __ldg(reinterpret_cast<const uint2*>(p + i));
        from_bits(x.x, out[i]);
        from_bits(x.y, out[i + 1]);
      }
  } else {
#pragma unroll
    for (int i = 0; i < WT; ++i)
      if (i < m) out[i] = __ldg(p + i);
  }
}

template <typename T, int COLS, int WT>
__global__ void __launch_bounds__(kThreads)
    plan_kernel(const T* __restrict__ pool, const float* __restrict__ scales,
                const int32_t* __restrict__ slots,
                const float* __restrict__ coeff, float* __restrict__ out,
                int64_t num_bags, int num_chunks, int t, int z, int lanes,
                int bags, int w_in, int w_plan, int w_out) {
  const Unit u = unit_of<COLS>(num_chunks, z, lanes, bags, num_bags);
  if (u.b >= num_bags) return;
  const int64_t base = (u.b * num_chunks + u.c) * (int64_t)t;
  float acc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc[c] = 0.0f;
  for (int t0 = 0; t0 < t; t0 += WT) {
    const int m = min(WT, t - t0);
    int32_t sl[WT];
    float cf[WT];
    read_plan<int32_t, WT>(slots + base + t0, m, w_plan, sl);
    read_plan<float, WT>(coeff + base + t0, m, w_plan, cf);
    accumulate<T, COLS, WT>(pool, scales, z, u, w_in, sl, cf, acc);
  }
  write_cols<COLS>(out + (u.b * num_chunks + u.c) * (int64_t)z + u.z0, u.n,
                   w_out, acc);
}

template <typename T, typename I, int COLS, int WT>
__global__ void __launch_bounds__(kThreads)
    ids_kernel(const T* __restrict__ pool, const float* __restrict__ scales,
               const I* __restrict__ ids, const float* __restrict__ weights,
               float* __restrict__ out, int64_t num_bags, int k_slots,
               int num_chunks, int num_hashes, uint32_t num_slots,
               uint32_t salt, int z, int lanes, int bags, int w_in,
               int w_out) {
  const Unit u = unit_of<COLS>(num_chunks, z, lanes, bags, num_bags);
  if (u.b >= num_bags) return;
  const int t = k_slots * num_hashes;
  const uint32_t key_c = (uint32_t)u.c * kMix1 + salt;
  float acc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc[c] = 0.0f;
  for (int t0 = 0; t0 < t; t0 += WT) {
    int32_t sl[WT];
    float cf[WT];
#pragma unroll
    for (int i = 0; i < WT; ++i) {
      sl[i] = 0;
      cf[i] = 0.0f;
      const int ti = t0 + i;
      if (ti < t) {
        const int k = ti / num_hashes;
        const int j = ti - k * num_hashes;
        const int64_t at = u.b * k_slots + k;
        const uint32_t id = (uint32_t)__ldg(ids + at);
        const float w = weights != nullptr ? __ldg(weights + at) : 1.0f;
        const uint32_t h = mix(id * kKnuth + key_c + (uint32_t)j * kMix2);
        sl[i] = (int32_t)(h % num_slots);
        const float sign = (mix(h + kGold) >> 31) == 0 ? 1.0f : -1.0f;
        cf[i] = __fmul_rn(sign, w);
      }
    }
    accumulate<T, COLS, WT>(pool, scales, z, u, w_in, sl, cf, acc);
  }
  write_cols<COLS>(out + (u.b * num_chunks + u.c) * (int64_t)z + u.z0, u.n,
                   w_out, acc);
}

// Threads a (bag, chunk), bags a block, threads a block and the grid.
struct Shape {
  int cols, lanes, bags, threads;
  unsigned blocks;
  bool ok;
};

// The analytic pick: 8 columns a thread (4 where Z <= 4) and as many whole
// bags as kThreads threads hold.  Another tiling (block_b bags a block,
// block_d = COLS columns a thread: 4 or 8), which the measured autotune
// cache may pick, gives a block block_b bags' threads, rounded up to a
// warp.  One thread owns each output column's chain over t in order
// whatever the tiling, so no tiling changes a bit.
Shape shape_of(int64_t num_bags, int num_chunks, int z, int block_b,
               int block_d) {
  Shape sh;
  sh.ok = false;
  const bool analytic = block_b == 0 && block_d == 0;
  sh.cols = analytic ? (z <= 4 ? 4 : 8) : block_d;
  if (sh.cols != 4 && sh.cols != 8) return sh;
  sh.lanes = (z + sh.cols - 1) / sh.cols;
  const int64_t per_bag = (int64_t)num_chunks * sh.lanes;
  const int most = per_bag <= kThreads ? (int)(kThreads / per_bag) : 0;
  sh.bags = analytic ? most : block_b;
  if (sh.bags < 1 || sh.bags > most) return sh;
  sh.threads = analytic ? kThreads
                        : (int)((sh.bags * per_bag + 31) / 32 * 32);
  const int64_t blocks = (num_bags + sh.bags - 1) / sh.bags;
  sh.blocks = (unsigned)blocks;
  sh.ok = blocks <= 0x7fffffffLL;
  return sh;
}

template <typename T>
int in_width(const void* pool, int cols, int z) {
  const int cap = cols * (int)sizeof(T) < 16 ? cols * (int)sizeof(T) : 16;
  return gather_io::piece_bytes(pool, (long long)z * sizeof(T), cap);
}

int out_width(const void* out, int z) {
  return gather_io::piece_bytes(out, (long long)z * 4, 16);
}

template <typename T, int COLS>
int launch_plan(const Shape& sh, const void* pool, const float* scales,
                const int32_t* slots, const float* coeff, float* out,
                int64_t num_bags, int num_chunks, int t, int z,
                cudaStream_t stream) {
  const T* p = static_cast<const T*>(pool);
  const int wi = in_width<T>(pool, COLS, z), wo = out_width(out, z);
  const int wp = gather_io::piece_bytes(
      reinterpret_cast<const void*>((uintptr_t)slots | (uintptr_t)coeff),
      (long long)t * 4, 16);
  if (t <= 2)
    plan_kernel<T, COLS, 2><<<sh.blocks, sh.threads, 0, stream>>>(
        p, scales, slots, coeff, out, num_bags, num_chunks, t, z, sh.lanes,
        sh.bags, wi, wp, wo);
  else
    plan_kernel<T, COLS, 4><<<sh.blocks, sh.threads, 0, stream>>>(
        p, scales, slots, coeff, out, num_bags, num_chunks, t, z, sh.lanes,
        sh.bags, wi, wp, wo);
  return (int)cudaGetLastError();
}

template <typename T, typename I, int COLS>
int launch_ids(const Shape& sh, const void* pool, const float* scales,
               const void* ids, const float* weights, float* out,
               int64_t num_bags, int k_slots, int num_chunks, int num_hashes,
               uint32_t num_slots, uint32_t salt, int z,
               cudaStream_t stream) {
  const T* p = static_cast<const T*>(pool);
  const I* i = static_cast<const I*>(ids);
  const int wi = in_width<T>(pool, COLS, z), wo = out_width(out, z);
  if (k_slots * num_hashes <= 2)
    ids_kernel<T, I, COLS, 2><<<sh.blocks, sh.threads, 0, stream>>>(
        p, scales, i, weights, out, num_bags, k_slots, num_chunks,
        num_hashes, num_slots, salt, z, sh.lanes, sh.bags, wi, wo);
  else
    ids_kernel<T, I, COLS, 4><<<sh.blocks, sh.threads, 0, stream>>>(
        p, scales, i, weights, out, num_bags, k_slots, num_chunks,
        num_hashes, num_slots, salt, z, sh.lanes, sh.bags, wi, wo);
  return (int)cudaGetLastError();
}

template <typename T, typename I>
int ids_by_cols(const Shape& sh, const void* pool, const float* scales,
                const void* ids, const float* weights, float* out,
                int64_t num_bags, int k_slots, int num_chunks,
                int num_hashes, uint32_t num_slots, uint32_t salt, int z,
                cudaStream_t stream) {
  if (sh.cols == 4)
    return launch_ids<T, I, 4>(sh, pool, scales, ids, weights, out,
                               num_bags, k_slots, num_chunks, num_hashes,
                               num_slots, salt, z, stream);
  return launch_ids<T, I, 8>(sh, pool, scales, ids, weights, out, num_bags,
                             k_slots, num_chunks, num_hashes, num_slots,
                             salt, z, stream);
}

}  // namespace

// dtype: 0 = int8, 2 = fp32 (the codes of dequant_bag_launch).  block_b,
// block_d: the tiling, bags a block and columns a thread (0, 0 = the
// analytic pick).  Returns the cudaError_t of the launch (0 = success).
extern "C" int hashed_gather_launch(const void* pool, int dtype,
                                    const void* scales, const void* slots,
                                    const void* coeff, void* out,
                                    long long num_bags, int num_chunks,
                                    int t, int z, int block_b, int block_d,
                                    void* stream) {
  const float* s = static_cast<const float*>(scales);
  const int32_t* i = static_cast<const int32_t*>(slots);
  const float* w = static_cast<const float*>(coeff);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_bags <= 0 || num_chunks <= 0 || z <= 0) return 0;
  if (t < 0 || block_b < 0 || block_d < 0) return (int)cudaErrorInvalidValue;
  const Shape sh = shape_of(num_bags, num_chunks, z, block_b, block_d);
  if (!sh.ok) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return sh.cols == 4
                 ? launch_plan<int8_t, 4>(sh, pool, s, i, w, o, num_bags,
                                          num_chunks, t, z, st)
                 : launch_plan<int8_t, 8>(sh, pool, s, i, w, o, num_bags,
                                          num_chunks, t, z, st);
    case 2:
      return sh.cols == 4
                 ? launch_plan<float, 4>(sh, pool, s, i, w, o, num_bags,
                                         num_chunks, t, z, st)
                 : launch_plan<float, 8>(sh, pool, s, i, w, o, num_bags,
                                         num_chunks, t, z, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The ids entry.  ids: (B, K) int64 when ids64 is 1, int32 when 0 (each
// id's low 32 bits are hashed); weights (B, K) fp32 or null (ones); the
// pool has num_slots rows; salt = (seed * 0x9E3779B1) mod 2^32.  dtype
// and block_b, block_d as hashed_gather_launch.  Returns the cudaError_t
// of the launch (0 = success).
extern "C" int hashed_gather_ids_launch(
    const void* pool, int dtype, const void* scales, const void* ids,
    int ids64, const void* weights, void* out, long long num_bags,
    int k_slots, int num_chunks, int num_hashes, long long num_slots,
    unsigned int salt, int z, int block_b, int block_d, void* stream) {
  const float* s = static_cast<const float*>(scales);
  const float* w = static_cast<const float*>(weights);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_bags <= 0 || num_chunks <= 0 || z <= 0) return 0;
  if (k_slots < 0 || num_hashes < 1 || num_slots < 1 ||
      num_slots > 0xffffffffLL ||
      (long long)k_slots * num_hashes > 0x7fffffffLL || block_b < 0 ||
      block_d < 0)
    return (int)cudaErrorInvalidValue;
  const Shape sh = shape_of(num_bags, num_chunks, z, block_b, block_d);
  if (!sh.ok) return (int)cudaErrorInvalidValue;
  const uint32_t ns = (uint32_t)num_slots;
  if (dtype == 0 && ids64)
    return ids_by_cols<int8_t, int64_t>(sh, pool, s, ids, w, o, num_bags,
                                        k_slots, num_chunks, num_hashes, ns,
                                        salt, z, st);
  if (dtype == 0)
    return ids_by_cols<int8_t, int32_t>(sh, pool, s, ids, w, o, num_bags,
                                        k_slots, num_chunks, num_hashes, ns,
                                        salt, z, st);
  if (dtype == 2 && ids64)
    return ids_by_cols<float, int64_t>(sh, pool, s, ids, w, o, num_bags,
                                       k_slots, num_chunks, num_hashes, ns,
                                       salt, z, st);
  if (dtype == 2)
    return ids_by_cols<float, int32_t>(sh, pool, s, ids, w, o, num_bags,
                                       k_slots, num_chunks, num_hashes, ns,
                                       salt, z, st);
  return (int)cudaErrorInvalidValue;
}

// The analytic tiling of either entry for this shape: out[0] = bags a
// block, out[1] = columns a thread.
extern "C" int hashed_gather_tiling(int num_chunks, int z, int* out) {
  if (num_chunks <= 0 || z <= 0) return (int)cudaErrorInvalidValue;
  const Shape sh = shape_of(1, num_chunks, z, 0, 0);
  if (!sh.ok) return (int)cudaErrorInvalidConfiguration;
  out[0] = sh.bags;
  out[1] = sh.cols;
  return 0;
}
