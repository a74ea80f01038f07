// xDeepFM Compressed Interaction Network layer for Hopper (sm_90a).
//
// Replaces repro/kernels/cin/kernel.py::cin_layer_pallas:
//
//   out[b, o, d] = sum_{h, m} W[o, h, m] * xk[b, h, d] * x0[b, m, d]
//
// W (O, H, M), xk (B, H, D), x0 (B, M, D), all fp32 -> out (B, O, D) fp32.
//
// Contract: the order pinned by the plain PyTorch version
// (repro_torch/kernels/cin/ref.py).  Each outer-product term is rounded
// first, t = __fmul_rn(xk[b,h,d], x0[b,m,d]), then one FMA chain per
// output, acc = __fmaf_rn(W[o,h,m], t, acc) from acc = 0, over h
// ascending and m ascending within h.  Plain fp32 FMA, no TF32.  (The
// reference's kernel contracts the flattened (h, m) axis in one dot of
// XLA's order; the port meets it within a stated tolerance.)
//
// What bounds it on an H100: operations, 2 * B * O * H * M * D flops (35.1
// GFLOP over the three layers of a 512-sample xDeepFM request) against a
// few MB of inputs.  Like the TPU kernel it never materialises the
// (B, H, M, D) outer product in device memory.  Design: a block owns
// kSamples samples x kTileO outputs x all D columns; each thread owns one
// (sample, d) pair and keeps kTileO accumulators in registers, so one
// outer-product term feeds kTileO FMAs.  x0 of the block's samples stays
// in shared memory for the whole layer; xk and W stream through shared
// memory in chunks of kChunkH rows of h (a (16, 200, 39) W tile is 0.5 MB
// and does not fit).  W is laid out [h][m][o] in shared memory, so the
// kTileO weights of one (h, m) step are four broadcast 16-byte loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileO = 16;
constexpr int kChunkH = 8;

__global__ void __launch_bounds__(kThreads)
cin_kernel(const float* __restrict__ w, const float* __restrict__ xk,
           const float* __restrict__ x0, float* __restrict__ out,
           int64_t batch, int o_out, int h_in, int m_in, int dim,
           int samples) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* w_s = smem;                                  // [kChunkH][M][kTileO]
  float* x0_s = w_s + kChunkH * m_in * kTileO;        // [samples][M][D]
  float* xk_s = x0_s + samples * m_in * dim;          // [samples][kChunkH][D]

  const int tid = threadIdx.x;
  const int64_t b0 = (int64_t)blockIdx.x * samples;
  const int o0 = blockIdx.y * kTileO;
  const int bl = tid / dim;
  const int d = tid - bl * dim;
  const bool active = bl < samples && b0 + bl < batch;

  for (int e = tid; e < samples * m_in * dim; e += kThreads) {
    const int s = e / (m_in * dim);
    const int64_t b = b0 + s;
    x0_s[e] = b < batch ? x0[b * m_in * dim + (e - s * m_in * dim)] : 0.0f;
  }

  float acc[kTileO];
#pragma unroll
  for (int j = 0; j < kTileO; ++j) acc[j] = 0.0f;

  for (int hc = 0; hc < h_in; hc += kChunkH) {
    const int nh = h_in - hc < kChunkH ? h_in - hc : kChunkH;
    __syncthreads();   // the previous chunk is consumed
    // W[o, hc + hh, m] -> w_s[hh][m][ol], read contiguous in m
    for (int e = tid; e < kTileO * nh * m_in; e += kThreads) {
      const int ol = e / (nh * m_in);
      const int r = e - ol * nh * m_in;
      const int hh = r / m_in;
      const int m = r - hh * m_in;
      const int o = o0 + ol;
      w_s[(hh * m_in + m) * kTileO + ol] =
          o < o_out ? w[((int64_t)o * h_in + hc + hh) * m_in + m] : 0.0f;
    }
    for (int e = tid; e < samples * nh * dim; e += kThreads) {
      const int s = e / (nh * dim);
      const int r = e - s * nh * dim;
      const int hh = r / dim;
      const int dd = r - hh * dim;
      const int64_t b = b0 + s;
      xk_s[(s * kChunkH + hh) * dim + dd] =
          b < batch ? xk[(b * h_in + hc + hh) * dim + dd] : 0.0f;
    }
    __syncthreads();
    if (active) {
      for (int hh = 0; hh < nh; ++hh) {
        const float xv = xk_s[(bl * kChunkH + hh) * dim + d];
        const float* x0p = x0_s + bl * m_in * dim + d;
        const float4* wp =
            reinterpret_cast<const float4*>(w_s + hh * m_in * kTileO);
        for (int m = 0; m < m_in; ++m) {
          const float t = __fmul_rn(xv, x0p[m * dim]);
#pragma unroll
          for (int q = 0; q < kTileO / 4; ++q) {
            const float4 wv = wp[m * (kTileO / 4) + q];
            acc[4 * q + 0] = __fmaf_rn(wv.x, t, acc[4 * q + 0]);
            acc[4 * q + 1] = __fmaf_rn(wv.y, t, acc[4 * q + 1]);
            acc[4 * q + 2] = __fmaf_rn(wv.z, t, acc[4 * q + 2]);
            acc[4 * q + 3] = __fmaf_rn(wv.w, t, acc[4 * q + 3]);
          }
        }
      }
    }
  }

  if (!active) return;
  const int64_t b = b0 + bl;
#pragma unroll
  for (int j = 0; j < kTileO; ++j) {
    const int o = o0 + j;
    if (o < o_out) out[(b * o_out + o) * dim + d] = acc[j];
  }
}

}  // namespace

// 1 <= dim <= 128.  Returns the cudaError_t of the launch (0 = success).
extern "C" int cin_launch(const void* w, const void* xk, const void* x0,
                          void* out, long long batch, int o_out, int h_in,
                          int m_in, int dim, void* stream) {
  if (batch <= 0 || o_out <= 0 || dim <= 0) return 0;
  if (dim > kThreads || h_in < 0 || m_in < 1)
    return (int)cudaErrorInvalidValue;
  const int samples = kThreads / dim;
  const size_t smem =
      sizeof(float) * ((size_t)kChunkH * m_in * kTileO +
                       (size_t)samples * m_in * dim +
                       (size_t)samples * kChunkH * dim);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long grid_b = (batch + samples - 1) / samples;
  const int grid_o = (o_out + kTileO - 1) / kTileO;
  if (grid_b > 2147483647LL || grid_o > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)grid_b, (unsigned)grid_o);
  cin_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(xk),
      static_cast<const float*>(x0), static_cast<float*>(out), batch, o_out,
      h_in, m_in, dim, samples);
  return (int)cudaGetLastError();
}
