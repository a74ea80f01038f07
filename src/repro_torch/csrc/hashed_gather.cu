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
// slots (B, C*T) int32 in [0, S), coeff (B, C*T) fp32 (sign x bag weight;
// 0 = padded or masked slot) -> out (B, C*Z) fp32.  T = K * num_hashes
// slots per (bag, chunk), chunk-major: chunk c's T slots are contiguous.
// The slot plan (the hash) is computed outside the kernel, as the
// reference builds it outside its kernel.
//
// Contract with the reference: per (bag, chunk) the T slots are taken in
// order, a slot whose coefficient is 0 reads neither its row nor its
// scale, and each term accumulates as acc = fma(row * s, w, acc).  Where
// the reference's tests run its kernel (Pallas interpret mode, XLA on
// the CPU) its `out += (row * s) * w` is fused into that FMA.  Here every
// rounding is written out (__fmul_rn, __fmaf_rn), so nvcc's contraction
// choices cannot change it, and the result is bit-identical to the plain
// PyTorch version (repro_torch/kernels/hashed_gather/ref.py), which
// computes the same FMA exactly in float64.  At K = 1 with +-1 signs
// every product is exact, so the serving lookup also equals the
// reference's jnp oracle.  With null scales the scale product is left
// out: row * 1.0f == row exactly.
//
// What bounds it on an H100: bytes.  A request reads each distinct pool
// row it touches once (Z * itemsize + 4 bytes), its slot plan (8 bytes a
// slot) and writes B * C * Z * 4 output bytes; 3 flops a slot element.
// Design: one thread per output element (b, c, z); the Z lanes of a
// (bag, chunk) read one pool row's contiguous bytes together and share
// its slot and coefficient loads (a warp-wide broadcast).  The loop over
// t is the TPU grid's sequential reduction; bags and chunks run in
// parallel, so nothing crosses threads.  Offsets are int64: the fit runs
// the kernel over every row of the table, B * C * Z = 7.1e8 outputs at
// full wide&deep width.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__global__ void hashed_gather_kernel(const T* __restrict__ pool,
                                     const float* __restrict__ scales,
                                     const int32_t* __restrict__ slots,
                                     const float* __restrict__ coeff,
                                     float* __restrict__ out,
                                     int64_t num_out, int num_chunks, int t,
                                     int z) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= num_out) return;
  const int64_t bc = e / z;             // (bag, chunk) = b * C + c
  const int zz = (int)(e - bc * z);
  const int64_t b = bc / num_chunks;
  const int c = (int)(bc - b * num_chunks);
  const int64_t base = b * (int64_t)num_chunks * t + (int64_t)c * t;
  const int32_t* sl = slots + base;
  const float* w = coeff + base;
  float acc = 0.0f;
  for (int i = 0; i < t; ++i) {
    const float wi = w[i];
    if (wi != 0.0f) {
      const int64_t row = sl[i];
      float v = to_f32(pool[row * z + zz]);
      if (scales != nullptr) v = __fmul_rn(v, scales[row]);
      acc = __fmaf_rn(v, wi, acc);
    }
  }
  out[e] = acc;
}

constexpr int kThreads = 256;

template <typename T>
int launch(const void* pool, const float* scales, const int32_t* slots,
           const float* coeff, float* out, int64_t num_bags, int num_chunks,
           int t, int z, cudaStream_t stream) {
  const int64_t num_out = num_bags * num_chunks * (int64_t)z;
  const int64_t blocks = (num_out + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  hashed_gather_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(pool), scales, slots, coeff, out, num_out,
      num_chunks, t, z);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = int8, 2 = fp32 (the codes of dequant_bag_launch).  Returns
// the cudaError_t of the launch (0 = success).
extern "C" int hashed_gather_launch(const void* pool, int dtype,
                                    const void* scales, const void* slots,
                                    const void* coeff, void* out,
                                    long long num_bags, int num_chunks,
                                    int t, int z, void* stream) {
  const float* s = static_cast<const float*>(scales);
  const int32_t* i = static_cast<const int32_t*>(slots);
  const float* w = static_cast<const float*>(coeff);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_bags <= 0 || num_chunks <= 0 || z <= 0) return 0;
  if (t < 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch<int8_t>(pool, s, i, w, o, num_bags, num_chunks, t, z,
                            st);
    case 2:
      return launch<float>(pool, s, i, w, o, num_bags, num_chunks, t, z,
                           st);
  }
  return (int)cudaErrorInvalidValue;
}
