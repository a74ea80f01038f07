// Fused per-row max-abs -> scale -> round -> int8 for Hopper (sm_90a).
//
// Replaces repro/kernels/rowwise_quant/kernel.py::quantize_rowwise_pallas
// (SHARK Eq. 5-6):
//
//   scale[r] = max(max_abs(x[r, :]), 1e-12) / denom    denom 127 | 127.5
//   q[r, d]  = clip(rint(x[r, d] / scale[r]), -128, 127)
//            | clip(floor(y) + (noise[r, d] < y - floor(y)), -128, 127)
//
// x (V, D) fp32 [+ noise (V, D) fp32 uniforms] -> q (V, D) int8, scale
// (V,) fp32.  In the port it is the int8 tier quantizer of the packed
// store (core/packed_store.py::_quantize_tier: every pack, build and
// re-tier) and the quantizer of the hashed store's int8 pool
// (store/hashed.py::quantize_pool).
//
// Contract: every rounding is written out, so nvcc's contraction choices
// cannot change it.  The scale is __fdiv_rn(max_abs, denom) when
// `reciprocal` is 0 (the eager reference: pack, repack_delta,
// quantize_pool) and __fmul_rn(max_abs, fp32(1 / denom)) when it is 1
// (the jitted Pallas kernel, where XLA folds the division by the constant
// into that multiply); y = __fdiv_rn(x, scale); rintf rounds half to
// even, as jnp.round and torch.round do; the stochastic form adds 1 where
// noise < __fsub_rn(y, floor(y)).  A max is exact in any order, so the
// warp's shuffle reduction gives the same max-abs as a serial one.
// Non-finite rows follow the plain version: a NaN anywhere in a row makes
// its max-abs and scale NaN (as torch's amax and clamp do; fmaxf alone
// would drop it), a NaN y stays NaN through the clip, and a NaN code is
// stored as 0, as PyTorch's and XLA's float -> int8 casts give (an inf
// row has scale inf, so its inf entries give NaN and its finite ones 0).
// The result is bit-identical to the plain PyTorch version
// (repro_torch/kernels/rowwise_quant/ref.py).
//
// What bounds it on an H100: bytes.  It reads 4 bytes and writes 1 byte
// an element (+4 bytes of noise in the stochastic form) and 4 bytes of
// scale a row; a handful of flops an element.  Design: one warp a row,
// so the max-abs is a register reduction (5 shuffles) and nothing crosses
// warps; lanes stride the row so each pass is coalesced.  The second pass
// re-reads the row, from L1 or L2 (a row of the dlrm-rm2 int8 tier is
// 256 bytes).  Row offsets are int64: a 4M-row build chunk of D = 64 is
// 2.7e8 elements, the whole int8 tier 5.2e9.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

// max that keeps a NaN operand (fmaxf returns the other one)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

__global__ void rowwise_quant_kernel(const float* __restrict__ x,
                                     const float* __restrict__ noise,
                                     int8_t* __restrict__ q,
                                     float* __restrict__ scale,
                                     int64_t rows, int dim, float denom,
                                     int reciprocal) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= rows) return;
  const float* xr = x + r * dim;

  float m = 0.0f;
  for (int d = lane; d < dim; d += 32) m = nan_max(m, fabsf(xr[d]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(kFull, m, off));
  m = nan_max(m, 1e-12f);
  const float s = reciprocal ? __fmul_rn(m, __fdiv_rn(1.0f, denom))
                             : __fdiv_rn(m, denom);

  const float* nr = noise == nullptr ? nullptr : noise + r * dim;
  int8_t* qr = q + r * dim;
  for (int d = lane; d < dim; d += 32) {
    const float y = __fdiv_rn(xr[d], s);
    float v;
    if (nr == nullptr) {
      v = rintf(y);
    } else {
      const float lo = floorf(y);
      v = __fadd_rn(lo, nr[d] < __fsub_rn(y, lo) ? 1.0f : 0.0f);
    }
    qr[d] = v != v ? (int8_t)0 : (int8_t)(int)fminf(fmaxf(v, -128.0f),
                                                    127.0f);
  }
  if (lane == 0) scale[r] = s;
}

}  // namespace

// mode: 0 = narrow (denom 127), 1 = full (denom 127.5).  noise may be
// null (round to nearest).  Returns the cudaError_t of the launch
// (0 = success).
extern "C" int rowwise_quant_launch(const void* x, const void* noise,
                                    void* q, void* scale, long long rows,
                                    int dim, int mode, int reciprocal,
                                    void* stream) {
  if (rows <= 0) return 0;
  if (dim <= 0 || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  rowwise_quant_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(noise),
      static_cast<int8_t*>(q), static_cast<float*>(scale), rows, dim,
      mode == 0 ? 127.0f : 127.5f, reciprocal);
  return (int)cudaGetLastError();
}
