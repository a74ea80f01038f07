// Fused gather + row-wise dequant + bag -> first matmul for Hopper (sm_90a).
//
// Replaces repro/kernels/bag_matmul/kernel.py::bag_matmul_pallas, the TPU
// kernel behind the fused heads of wide&deep and xDeepFM:
//
//   out[b, h] = sum_k sum_d rows[b, k, d] * w3[k, d, h]
//   rows[b, k, :] = (f32(payload[idx[b,k], :]) * scale[idx[b,k]]) * w[b,k]
//
// payload (V, D) int8 | bf16 | fp16 | fp32, scales (V,) fp32 or null (unit
// scales: the fp32 tier), idx (B, K) int32, w (B, K) fp32, w3 (K, D, H)
// fp32 -> out (B, H) fp32.  Slots with w == 0 (rows of another tier) read
// no payload and stage exact zeros.
//
// Contract with the reference: the order its kernel computes where its
// tests run it (Pallas interpret mode), pinned by the plain PyTorch
// version (repro_torch/kernels/bag_matmul/ref.py).  Each staged row is
// __fmul_rn(__fmul_rn(row, s), w), rounded to fp32; per field k a product
// chain prod = __fmaf_rn(rows[b,k,d], w3[k,d,h], prod) runs over d
// ascending from 0; then acc = __fadd_rn(acc, prod) over k ascending.
// Plain fp32 FMA, no TF32 tensor cores: the contract is that fp32 sum.
// With SCALE_AFTER (the int8-direct form) rows are the raw converted
// payload and prod is multiplied by __fmul_rn(s, w) before the add.
//
// What bounds it on an H100: operations.  Each live slot costs 2 * D * H
// flops against D payload bytes; the reference's per-tier design (one
// launch per tier, other tiers' slots weight-masked) runs the product
// over every slot, live or not.  Design: a block owns a (kTileB, kTileH)
// output tile; per field it stages the tile's rows (kTileB x D, padded
// by one word against bank conflicts) and the (D, kTileH) slice of w3[k]
// in shared memory, and each of its 16 x 16 threads keeps a kRB x kRH
// register tile of prod and acc.  The loop over k is the TPU kernel's
// sequential accumulation; blocks never share an output, so nothing
// crosses blocks.  Row offsets are int64.

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

constexpr int kThreadsX = 16;                 // along H
constexpr int kThreadsY = 16;                 // along B
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kTileB = 32;
constexpr int kTileH = 64;
constexpr int kRB = kTileB / kThreadsY;       // bags per thread
constexpr int kRH = kTileH / kThreadsX;       // columns per thread
constexpr int kMaxDim = 384;                  // shared memory: see launch

template <typename T, bool SCALE_AFTER>
__global__ void __launch_bounds__(kThreads)
bag_matmul_kernel(const T* __restrict__ payload,
                  const float* __restrict__ scales,
                  const int32_t* __restrict__ indices,
                  const float* __restrict__ weights,
                  const float* __restrict__ w3, float* __restrict__ out,
                  int64_t num_bags, int k_slots, int dim, int h_out) {
  extern __shared__ float smem[];
  const int row_stride = dim + 1;
  float* rows = smem;                          // [kTileB][dim + 1]
  float* wtile = smem + kTileB * row_stride;   // [dim][kTileH]
  __shared__ float coeff[kTileB];              // SCALE_AFTER: s * w

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const int64_t b0 = (int64_t)blockIdx.x * kTileB;
  const int h0 = blockIdx.y * kTileH;

  float acc[kRB][kRH];
#pragma unroll
  for (int i = 0; i < kRB; ++i)
#pragma unroll
    for (int j = 0; j < kRH; ++j) acc[i][j] = 0.0f;

  for (int k = 0; k < k_slots; ++k) {
    __syncthreads();   // the previous field's tiles are consumed
    for (int e = tid; e < kTileB * dim; e += kThreads) {
      const int bl = e / dim;
      const int d = e - bl * dim;
      const int64_t b = b0 + bl;
      float v = 0.0f;
      if (b < num_bags) {
        const float w = weights[b * k_slots + k];
        if (w != 0.0f) {
          const int64_t row = indices[b * k_slots + k];
          const float x = to_f32(payload[row * dim + d]);
          if (SCALE_AFTER) {
            v = x;
          } else if (scales != nullptr) {
            v = __fmul_rn(__fmul_rn(x, scales[row]), w);
          } else {
            v = __fmul_rn(x, w);
          }
        }
      }
      rows[bl * row_stride + d] = v;
    }
    if (SCALE_AFTER) {
      for (int e = tid; e < kTileB; e += kThreads) {
        const int64_t b = b0 + e;
        float c = 0.0f;
        if (b < num_bags) {
          const float w = weights[b * k_slots + k];
          const float s = scales != nullptr
                              ? scales[indices[b * k_slots + k]]
                              : 1.0f;
          c = __fmul_rn(s, w);
        }
        coeff[e] = c;
      }
    }
    const float* wk = w3 + (int64_t)k * dim * h_out;
    for (int e = tid; e < dim * kTileH; e += kThreads) {
      const int d = e / kTileH;
      const int hl = e - d * kTileH;
      const int h = h0 + hl;
      wtile[e] = h < h_out ? wk[(int64_t)d * h_out + h] : 0.0f;
    }
    __syncthreads();

    float prod[kRB][kRH];
#pragma unroll
    for (int i = 0; i < kRB; ++i)
#pragma unroll
      for (int j = 0; j < kRH; ++j) prod[i][j] = 0.0f;
    for (int d = 0; d < dim; ++d) {
      float r[kRB];
      float c[kRH];
#pragma unroll
      for (int i = 0; i < kRB; ++i)
        r[i] = rows[(ty + i * kThreadsY) * row_stride + d];
#pragma unroll
      for (int j = 0; j < kRH; ++j)
        c[j] = wtile[d * kTileH + tx + j * kThreadsX];
#pragma unroll
      for (int i = 0; i < kRB; ++i)
#pragma unroll
        for (int j = 0; j < kRH; ++j)
          prod[i][j] = __fmaf_rn(r[i], c[j], prod[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRB; ++i) {
#pragma unroll
      for (int j = 0; j < kRH; ++j) {
        float p = prod[i][j];
        if (SCALE_AFTER) p = __fmul_rn(p, coeff[ty + i * kThreadsY]);
        acc[i][j] = __fadd_rn(acc[i][j], p);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRB; ++i) {
    const int64_t b = b0 + ty + i * kThreadsY;
    if (b >= num_bags) continue;
#pragma unroll
    for (int j = 0; j < kRH; ++j) {
      const int h = h0 + tx + j * kThreadsX;
      if (h < h_out) out[b * h_out + h] = acc[i][j];
    }
  }
}

template <typename T, bool SCALE_AFTER>
int launch(const void* payload, const float* scales, const int32_t* indices,
           const float* weights, const float* w3, float* out,
           int64_t num_bags, int k_slots, int dim, int h_out,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kTileB * (dim + 1) + (size_t)dim * kTileH);
  auto kernel = bag_matmul_kernel<T, SCALE_AFTER>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t grid_b = (num_bags + kTileB - 1) / kTileB;
  const int grid_h = (h_out + kTileH - 1) / kTileH;
  if (grid_b > 2147483647LL || grid_h > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)grid_b, (unsigned)grid_h);
  const dim3 block(kThreadsX, kThreadsY);
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const T*>(payload), scales, indices, weights, w3, out,
      num_bags, k_slots, dim, h_out);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* payload, const float* scales,
             const int32_t* indices, const float* weights, const float* w3,
             float* out, int64_t num_bags, int k_slots, int dim, int h_out,
             int scale_after, cudaStream_t stream) {
  if (scale_after)
    return launch<T, true>(payload, scales, indices, weights, w3, out,
                           num_bags, k_slots, dim, h_out, stream);
  return launch<T, false>(payload, scales, indices, weights, w3, out,
                          num_bags, k_slots, dim, h_out, stream);
}

}  // namespace

// dtype: 0 = int8, 1 = bf16, 2 = fp32, 3 = fp16.  1 <= dim <= 384.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int bag_matmul_launch(const void* payload, int dtype,
                                 const void* scales, const void* indices,
                                 const void* weights, const void* w3,
                                 void* out, long long num_bags, int k_slots,
                                 int dim, int h_out, int scale_after,
                                 void* stream) {
  const float* s = static_cast<const float*>(scales);
  const int32_t* i = static_cast<const int32_t*>(indices);
  const float* w = static_cast<const float*>(weights);
  const float* m = static_cast<const float*>(w3);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_bags <= 0 || h_out <= 0) return 0;
  if (dim < 1 || dim > kMaxDim || k_slots < 0)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return dispatch<int8_t>(payload, s, i, w, m, o, num_bags, k_slots, dim,
                              h_out, scale_after, st);
    case 1:
      return dispatch<__nv_bfloat16>(payload, s, i, w, m, o, num_bags,
                                     k_slots, dim, h_out, scale_after, st);
    case 2:
      return dispatch<float>(payload, s, i, w, m, o, num_bags, k_slots, dim,
                             h_out, scale_after, st);
    case 3:
      return dispatch<__half>(payload, s, i, w, m, o, num_bags, k_slots, dim,
                              h_out, scale_after, st);
  }
  return (int)cudaErrorInvalidValue;
}
