// Fused gather + row-wise dequant + bag reduction for Hopper (sm_90a).
//
// Replaces repro/kernels/dequant_bag/kernel.py::dequant_bag_pallas, the
// TPU serving gather behind SHARK's tier-partitioned store:
//
//   out[b, :] = sum_k (f32(payload[idx[b,k], :]) * scale[idx[b,k]]) * w[b,k]
//
// payload (V, D) int8 | bf16 | fp16 | fp32, scales (V,) fp32 or null (unit
// scales: the fp32 tier), idx (B, K) int32, w (B, K) fp32 -> out (B, D)
// fp32.  Slots with w == 0 (padding, or rows of another tier) read
// neither their row nor their scale.
//
// Contract with the reference (kernel.py:38-45): accumulate over k in
// order and multiply the scale in first, (row * s) * w.  Where the
// reference's tests run its kernel (Pallas interpret mode, XLA on the
// CPU), XLA fuses the weight product with the sum, so the reference
// computes acc = fma(row * s, w, acc): the unfused form differs from it
// in the last bit at K > 1.  This kernel writes that FMA explicitly,
// __fmaf_rn(__fmul_rn(row, s), w, acc), so nvcc's contraction choices
// cannot change it, and it is bit-identical to the plain PyTorch version
// (repro_torch/kernels/dequant_bag/ref.py), which computes the same FMA
// exactly in float64.  With null scales the scale product is left out:
// row * 1.0f == row exactly, so nothing changes.  At K = 1 the FMA is a
// plain product, so the serving lookup equals packed_store.lookup.
//
// What bounds it on an H100: bytes.  Each live slot moves D * itemsize
// payload bytes (+4 for its scale), each bag writes D * 4 output bytes,
// and the arithmetic is 3 flops per payload element — far below the
// card's ~300 flops/byte ridge.  Design: one thread owns VEC consecutive
// columns of one bag and walks that bag's K slots in order; blockDim.x
// threads cover a stripe of the row, blockDim.y bags share a block.
// Rows are read with 16-byte vector loads where D * itemsize allows
// (VEC = 16 / itemsize), so a bag's row stripe is one coalesced segment.
// The loop over k is the TPU grid's sequential reduction axis; bags run
// in parallel, so nothing crosses blocks.  Row offsets are int64: the
// full int8 tier holds ~81.7M rows x 64 = 5.2e9 elements.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T, int VEC>
__device__ __forceinline__ void load_row(const T* __restrict__ src,
                                         T (&vals)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    memcpy(vals, &raw, 16);
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) vals[v] = src[v];
  }
}

template <typename T, int VEC>
__global__ void dequant_bag_kernel(const T* __restrict__ payload,
                                   const float* __restrict__ scales,
                                   const int32_t* __restrict__ indices,
                                   const float* __restrict__ weights,
                                   float* __restrict__ out, int64_t num_bags,
                                   int k_slots, int64_t dim) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  const int64_t c0 =
      ((int64_t)blockIdx.y * blockDim.x + threadIdx.x) * VEC;
  if (b >= num_bags || c0 >= dim) return;

  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;

  const int32_t* idx = indices + b * k_slots;
  const float* wts = weights + b * k_slots;
  for (int k = 0; k < k_slots; ++k) {
    const float w = wts[k];
    if (w != 0.0f) {
      const int64_t row = idx[k];
      T vals[VEC];
      load_row<T, VEC>(payload + row * dim + c0, vals);
      if (scales != nullptr) {
        const float s = scales[row];
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          acc[v] = __fmaf_rn(__fmul_rn(to_f32(vals[v]), s), w, acc[v]);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          acc[v] = __fmaf_rn(to_f32(vals[v]), w, acc[v]);
      }
    }
  }

  float* dst = out + b * dim + c0;
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int v = 0; v < VEC; v += 4)
      *reinterpret_cast<float4*>(dst + v) =
          make_float4(acc[v], acc[v + 1], acc[v + 2], acc[v + 3]);
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) dst[v] = acc[v];
  }
}

constexpr int kThreads = 256;

template <typename T, int VEC>
int launch(const void* payload, const float* scales, const int32_t* indices,
           const float* weights, float* out, int64_t num_bags, int k_slots,
           int64_t dim, cudaStream_t stream) {
  const int64_t groups = (dim + VEC - 1) / VEC;
  const int tx = (int)(groups < kThreads ? groups : kThreads);
  const int ty = kThreads / tx;
  const dim3 block(tx, ty);
  const dim3 grid((unsigned)((num_bags + ty - 1) / ty),
                  (unsigned)((groups + tx - 1) / tx));
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  dequant_bag_kernel<T, VEC><<<grid, block, 0, stream>>>(
      static_cast<const T*>(payload), scales, indices, weights, out,
      num_bags, k_slots, dim);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = int8, 1 = bf16, 2 = fp32, 3 = fp16 (the strict_fp16 half
// tier).  vec: 1, or 16 / itemsize when every row starts on a 16-byte
// boundary (the wrapper checks).  Returns the cudaError_t of the launch
// (0 = success).
extern "C" int dequant_bag_launch(const void* payload, int dtype,
                                  const void* scales, const void* indices,
                                  const void* weights, void* out,
                                  long long num_bags, int k_slots,
                                  long long dim, int vec, void* stream) {
  const float* s = static_cast<const float*>(scales);
  const int32_t* i = static_cast<const int32_t*>(indices);
  const float* w = static_cast<const float*>(weights);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_bags <= 0 || dim <= 0) return 0;
  switch (dtype) {
    case 0:
      if (vec == 16)
        return launch<int8_t, 16>(payload, s, i, w, o, num_bags, k_slots,
                                  dim, st);
      if (vec == 1)
        return launch<int8_t, 1>(payload, s, i, w, o, num_bags, k_slots,
                                 dim, st);
      break;
    case 1:
      if (vec == 8)
        return launch<__nv_bfloat16, 8>(payload, s, i, w, o, num_bags,
                                        k_slots, dim, st);
      if (vec == 1)
        return launch<__nv_bfloat16, 1>(payload, s, i, w, o, num_bags,
                                        k_slots, dim, st);
      break;
    case 2:
      if (vec == 4)
        return launch<float, 4>(payload, s, i, w, o, num_bags, k_slots,
                                dim, st);
      if (vec == 1)
        return launch<float, 1>(payload, s, i, w, o, num_bags, k_slots,
                                dim, st);
      break;
    case 3:
      if (vec == 8)
        return launch<__half, 8>(payload, s, i, w, o, num_bags, k_slots,
                                 dim, st);
      if (vec == 1)
        return launch<__half, 1>(payload, s, i, w, o, num_bags, k_slots,
                                 dim, st);
      break;
  }
  return (int)cudaErrorInvalidValue;
}
