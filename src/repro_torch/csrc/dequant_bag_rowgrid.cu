// The (B, K)-grid tiling oracle of the fused dequant-bag, for Hopper
// (sm_90a).
//
// Replaces repro/kernels/dequant_bag/kernel.py::dequant_bag_pallas_rowgrid,
// the pre-refactor layout the reference keeps to test its tiled kernel:
// a (B, K) grid, one payload row DMA'd a step, the output tile revisited
// K times.  It computes what dequant_bag.cu computes,
//
//   out[b, :] = sum_k (f32(payload[idx[b,k], :]) * scale[idx[b,k]]) * w[b,k]
//
// payload (V, D) int8 | bf16 | fp16 | fp32, scales (V,) fp32 or null (unit
// scales: the fp32 tier), idx (B, K) int32, w (B, K) fp32 -> out (B, D)
// fp32, with the same arithmetic: over k in order, the scale product
// rounded on its own and the weight product and the sum rounded once,
// acc = __fmaf_rn(__fmul_rn(row, s), w, acc), as the reference's
// interpret mode fuses `out += (row * s) * w`.
//
// The one difference the reference keeps: the TPU grid reads every slot,
// zero weights included (kernel.py:213-261 has no w == 0 guard).  On
// finite rows a zero-weight slot adds a zero to a sum that is never -0,
// so the result equals the tiled kernel's bit for bit; a NaN or inf row
// in a zero-weight slot turns its bag to NaN, where dequant_bag.cu skips
// the slot.  This kernel keeps that rule, and so does its plain version
// (repro_torch/kernels/dequant_bag/ref.py::dequant_bag_rowgrid_ref).
//
// What bounds it on an H100: bytes.  Every slot's row (D * itemsize, +4
// for its scale) and its index and weight are read, the output written
// once; 3 flops a payload element.  PR 15's port kept the grid's shape, a
// thread an output element with scalar loads, each thread re-reading its
// bag's indices, weights and scales: ~11% of its bound at a request.
//
// The design: a group of G lanes a bag (G a power of two, at most 32, so
// several bags share a warp at small D), each lane holding one 16-byte
// piece of the row (16 int8, 8 bf16 or fp16, 4 fp32 columns), loaded as
// wide as the row's alignment allows (gather_io.cuh: a ragged D such as
// 10 or 33 reads in narrower pieces, a lane's last columns partial).  A
// group walks the slots of a run of consecutive bags in order; its lanes
// load the next G slots' indices and weights at once and pass them by
// shuffle, and the next slot's row and scale are loaded before the
// current slot's FMAs, so the K loop waits on one round trip, not K.
// Enough groups run at once to cover the card, each over an equal run of
// bags.
//
// Its schedule still differs from dequant_bag.cu's: no slot is skipped
// and no window of slots is gathered ahead; the slots of a run of bags are
// one stream, one slot's row in flight behind another.  Row offsets are
// int64 (the full int8 tier holds ~5.2e9 elements).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gather_io.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
rowgrid_kernel(const T* __restrict__ payload, const float* __restrict__ scales,
               const int32_t* __restrict__ indices,
               const float* __restrict__ weights, float* __restrict__ out,
               int64_t num_bags, int k_slots, int64_t dim,
               int64_t bags_per_group, int w_in, int w_out) {
  constexpr int COLS = 16 / (int)sizeof(T);        // columns a lane
  constexpr int N = gather_io::raw_words<T, COLS>();
  constexpr unsigned kGroupBits = G == 32 ? 0xffffffffu : (1u << G) - 1u;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);
  const unsigned gmask = kGroupBits << (lane - gl);
  const int64_t group = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / G;
  const int64_t b0 = group * bags_per_group;
  if (b0 >= num_bags) return;
  const int64_t b1 =
      b0 + bags_per_group < num_bags ? b0 + bags_per_group : num_bags;
  const int64_t s0 = b0 * k_slots, s1 = b1 * k_slots;

  for (int64_t c0 = 0; c0 < dim; c0 += (int64_t)G * COLS) {
    const int64_t col = c0 + (int64_t)gl * COLS;
    const int ncol = col < dim ? (int)(dim - col < COLS ? dim - col : COLS)
                               : 0;
    // lane gl holds slot m0 + gl's index and weight (cur) and slot m0 + G
    // + gl's (nxt)
    int64_t m0 = s0;
    auto meta = [&](int64_t s, int32_t& i, float& w) {
      i = s < s1 ? indices[s] : 0;
      w = s < s1 ? weights[s] : 0.0f;
    };
    int32_t ci, ni;
    float cw, nw;
    meta(m0 + gl, ci, cw);
    meta(m0 + G + gl, ni, nw);
    // slot s's row and scale, s in [m0, m0 + 2G)
    auto load = [&](int64_t s, uint32_t (&raw)[N], float& sc) {
      const int j = (int)(s - m0);
      const int32_t a = __shfl_sync(gmask, ci, j & (G - 1), G);
      const int32_t b = __shfl_sync(gmask, ni, j & (G - 1), G);
      const int64_t row = j < G ? a : b;
#pragma unroll
      for (int q = 0; q < N; ++q) raw[q] = 0u;
      if (ncol > 0)
        gather_io::read_cols<T, COLS, N>(payload + row * dim + col, ncol,
                                         w_in, raw);
      sc = scales != nullptr ? __ldg(scales + row) : 1.0f;
    };
    uint32_t ra[N], rb[N];
    float sa, sb = 1.0f;
    load(s0, ra, sa);
    float acc[COLS];
#pragma unroll
    for (int i = 0; i < COLS; ++i) acc[i] = 0.0f;
    int kk = 0;
    int64_t bag = b0;
    for (int64_t s = s0; s < s1; ++s) {
      if (s + 1 < s1) load(s + 1, rb, sb);
      const float wt = __shfl_sync(gmask, cw, (int)(s - m0), G);
#pragma unroll
      for (int i = 0; i < COLS; ++i) {
        float x = gather_io::elem<T>(ra, i);
        if (scales != nullptr) x = __fmul_rn(x, sa);
        acc[i] = __fmaf_rn(x, wt, acc[i]);
      }
      if (++kk == k_slots) {
        if (ncol > 0) gather_io::write_cols<COLS>(out + bag * dim + col, ncol,
                                                  w_out, acc);
#pragma unroll
        for (int i = 0; i < COLS; ++i) acc[i] = 0.0f;
        kk = 0;
        ++bag;
      }
#pragma unroll
      for (int q = 0; q < N; ++q) ra[q] = rb[q];
      sa = sb;
      if (s + 1 == m0 + G) {
        m0 += G;
        ci = ni;
        cw = nw;
        meta(m0 + G + gl, ni, nw);
      }
    }
  }
}

int sm_count() {
  int dev = 0, count = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    count = 132;
  return count;
}

template <typename T, int G>
int launch_g(const void* payload, const float* scales, const int32_t* indices,
             const float* weights, float* out, int64_t num_bags, int k_slots,
             int64_t dim, cudaStream_t stream) {
  auto kernel = rowgrid_kernel<T, G>;
  static int per_sm[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return (int)cudaErrorInvalidDevice;
  if (per_sm[dev] == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm[dev], kernel, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm[dev] < 1) per_sm[dev] = 1;
  }
  // one wave of groups, each over an equal run of bags
  const int64_t per_block = kThreads / G;
  const int64_t wave = (int64_t)sm_count() * per_sm[dev] * per_block;
  const int64_t groups = num_bags < wave ? num_bags : wave;
  const int64_t bags_per_group = (num_bags + groups - 1) / groups;
  const int64_t used = (num_bags + bags_per_group - 1) / bags_per_group;
  const int64_t blocks = (used + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int itemsize = (int)sizeof(T);
  const int w_in = gather_io::piece_bytes(payload, dim * itemsize, 16);
  const int w_out = gather_io::piece_bytes(out, dim * 4, 16);
  kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(payload), scales, indices, weights, out, num_bags,
      k_slots, dim, bags_per_group, w_in, w_out);
  return (int)cudaGetLastError();
}

// G: the fewest lanes (a power of two, at most 32) whose 16-byte pieces
// cover a row
template <typename T>
int launch(const void* payload, const float* scales, const int32_t* indices,
           const float* weights, float* out, int64_t num_bags, int k_slots,
           int64_t dim, cudaStream_t stream) {
  const int64_t lanes = (dim * (int64_t)sizeof(T) + 15) / 16;
#define GROUP(G)                                                          \
  if (lanes <= G || G == 32)                                              \
    return launch_g<T, G>(payload, scales, indices, weights, out,         \
                          num_bags, k_slots, dim, stream);
  GROUP(1) GROUP(2) GROUP(4) GROUP(8) GROUP(16) GROUP(32)
#undef GROUP
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = int8, 1 = bf16, 2 = fp32, 3 = fp16, as dequant_bag_launch.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int dequant_bag_rowgrid_launch(const void* payload, int dtype,
                                          const void* scales,
                                          const void* indices,
                                          const void* weights, void* out,
                                          long long num_bags, int k_slots,
                                          long long dim, void* stream) {
  const float* s = static_cast<const float*>(scales);
  const int32_t* i = static_cast<const int32_t*>(indices);
  const float* w = static_cast<const float*>(weights);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_bags <= 0 || dim <= 0) return 0;
  if (k_slots <= 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch<int8_t>(payload, s, i, w, o, num_bags, k_slots, dim, st);
    case 1:
      return launch<__nv_bfloat16>(payload, s, i, w, o, num_bags, k_slots,
                                   dim, st);
    case 2:
      return launch<float>(payload, s, i, w, o, num_bags, k_slots, dim, st);
    case 3:
      return launch<__half>(payload, s, i, w, o, num_bags, k_slots, dim, st);
  }
  return (int)cudaErrorInvalidValue;
}
