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
// Design: no tiling and no vector loads, on purpose (it is the oracle
// the tiled kernel is held to).  One thread owns one (b, d) output
// element and walks that bag's K slots in order; consecutive threads take
// consecutive columns of one bag, so a row's read is one coalesced
// segment per warp.  What bounds it on an H100: bytes — every slot's row
// (D * itemsize, +4 for its scale) and the indices and weights are read,
// the output written once; 3 flops a payload element.  Row offsets are
// int64 (the full int8 tier holds ~5.2e9 elements).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__global__ void dequant_bag_rowgrid_kernel(const T* __restrict__ payload,
                                           const float* __restrict__ scales,
                                           const int32_t* __restrict__ indices,
                                           const float* __restrict__ weights,
                                           float* __restrict__ out,
                                           int64_t num_bags, int k_slots,
                                           int64_t dim) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= num_bags * dim) return;
  const int64_t b = e / dim;
  const int64_t c = e - b * dim;
  const int32_t* idx = indices + b * k_slots;
  const float* wts = weights + b * k_slots;
  float acc = 0.0f;
  for (int k = 0; k < k_slots; ++k) {
    const int64_t row = idx[k];
    float x = to_f32(payload[row * dim + c]);
    if (scales != nullptr) x = __fmul_rn(x, scales[row]);
    acc = __fmaf_rn(x, wts[k], acc);
  }
  out[e] = acc;
}

constexpr int kThreads = 256;

template <typename T>
int launch(const void* payload, const float* scales, const int32_t* indices,
           const float* weights, float* out, int64_t num_bags, int k_slots,
           int64_t dim, cudaStream_t stream) {
  const int64_t blocks = (num_bags * dim + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  dequant_bag_rowgrid_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(payload), scales, indices, weights, out,
      num_bags, k_slots, dim);
  return (int)cudaGetLastError();
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
