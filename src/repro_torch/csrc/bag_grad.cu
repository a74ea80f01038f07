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
// writes only the rows some slot touches.
//
// Contract with the reference: each row's sum is accumulated in (b, k)
// lexicographic order as acc = fma(coeff, g[b], acc), starting from 0,
// with slots of coeff == 0 skipped.  The TPU grid walks the slots one
// at a time and its interpret-mode arithmetic (XLA on the CPU) fuses the
// `row += c * g` read-modify-write into that FMA.  Here the FMA is
// written as __fmaf_rn, so nvcc's contraction choices cannot change it,
// and the result is bit-identical to the plain PyTorch version
// (repro_torch/kernels/dequant_bag/ref.py::bag_grad_ref).  GPU blocks run
// in no order, so an atomicAdd scatter would sum in a different order
// each run; instead the caller groups the slots by row with a stable
// sort (torch.sort(..., stable=True) on the flat indices), which keeps
// each row's slots in (b, k) order, and ONE warp owns each row:
//
//   * warp i looks at sorted slot i; unless it is the first slot of its
//     row it exits, so each row has exactly one owner;
//   * the owner walks its row's run 32 slots at a time: the lanes load
//     32 (slot, coeff) pairs at once, then every lane steps through them
//     in order (shuffles), FMA-ing its VEC columns of g[b];
//   * the g loads of 8 slots are issued before their 8 FMAs, so a long
//     run keeps several row loads in flight while the FMA chain stays in
//     order;
//   * the row is stored once, at the end.
//
// What bounds it on an H100: bytes.  It reads g (B*D*4), the sorted
// rows and slot ids and the coefficients (B*K*(4+8+4)), and writes each
// distinct touched row once (U*D*4); 2 flops per element of a live
// slot, far below the ~300 flops/byte ridge.  The (V, D) zero fill is
// not part of this kernel and is counted apart.  A hot row (a zipf head
// id) is one warp's serial chain: correct, and the kernel's tail; a
// split that keeps the order is left for a later change.  Offsets are
// int64: row * D reaches 7.9e9 at 124M rows x 64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kInFlight = 8;
constexpr unsigned kFull = 0xffffffffu;

template <int VEC>
__global__ void bag_grad_kernel(const float* __restrict__ g,
                                const int32_t* __restrict__ rows,
                                const int64_t* __restrict__ slots,
                                const float* __restrict__ coeff,
                                float* __restrict__ out, int64_t n,
                                int k_slots, int64_t dim) {
  const int lane = threadIdx.x & 31;
  const int64_t i = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n) return;                       // whole warp: i is per warp
  const int32_t row = rows[i];
  if (i > 0 && rows[i - 1] == row) return;  // not the owner of this row

  for (int64_t base = 0; base < dim; base += 32 * VEC) {
    const int64_t c0 = base + (int64_t)lane * VEC;
    const bool active = c0 < dim;
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;

    for (int64_t j0 = i;; j0 += 32) {
      // this lane's slot of the next 32 in sorted order
      const int64_t j = j0 + lane;
      const bool mine = j < n && rows[j] == row;
      const int64_t s = mine ? slots[j] : 0;
      const float c = mine ? coeff[s] : 0.0f;
      // the row's slots are a prefix of the 32 (the rows are sorted)
      const int count = __popc(__ballot_sync(kFull, mine));
      for (int t0 = 0; t0 < count; t0 += kInFlight) {
        float cv[kInFlight];
        float gv[kInFlight][VEC];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int t = t0 + u;
          const int64_t st = __shfl_sync(kFull, s, t & 31);
          const float ct = __shfl_sync(kFull, c, t & 31);
          cv[u] = t < count ? ct : 0.0f;
          if (cv[u] != 0.0f && active) {
            const float* src = g + (st / k_slots) * dim + c0;
            if constexpr (VEC == 4) {
              const float4 x = *reinterpret_cast<const float4*>(src);
              gv[u][0] = x.x; gv[u][1] = x.y; gv[u][2] = x.z; gv[u][3] = x.w;
            } else if constexpr (VEC == 2) {
              const float2 x = *reinterpret_cast<const float2*>(src);
              gv[u][0] = x.x; gv[u][1] = x.y;
            } else {
              gv[u][0] = src[0];
            }
          } else {
#pragma unroll
            for (int v = 0; v < VEC; ++v) gv[u][v] = 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          if (cv[u] != 0.0f) {
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              acc[v] = __fmaf_rn(cv[u], gv[u][v], acc[v]);
          }
        }
      }
      if (count < 32) break;
    }

    if (active) {
      float* dst = out + (int64_t)row * dim + c0;
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else if constexpr (VEC == 2) {
        *reinterpret_cast<float2*>(dst) = make_float2(acc[0], acc[1]);
      } else {
        dst[0] = acc[0];
      }
    }
  }
}

template <int VEC>
int launch(const float* g, const int32_t* rows, const int64_t* slots,
           const float* coeff, float* out, int64_t n, int k_slots,
           int64_t dim, cudaStream_t stream) {
  const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  bag_grad_kernel<VEC><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      g, rows, slots, coeff, out, n, k_slots, dim);
  return (int)cudaGetLastError();
}

}  // namespace

// rows: the B*K flat indices sorted stably (int32); slots: their
// positions b*K + k (int64), the permutation of that sort; coeff: (B, K)
// fp32 in slot order.  vec: 1, 2 or 4 columns a lane, dim % vec == 0 and
// g / out 4*vec-byte aligned (the wrapper checks).  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int bag_grad_launch(const void* g, const void* rows,
                               const void* slots, const void* coeff,
                               void* out, long long n, int k_slots,
                               long long dim, int vec, void* stream) {
  const float* gp = static_cast<const float*>(g);
  const int32_t* rp = static_cast<const int32_t*>(rows);
  const int64_t* sp = static_cast<const int64_t*>(slots);
  const float* cp = static_cast<const float*>(coeff);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || dim <= 0) return 0;
  if (k_slots <= 0) return (int)cudaErrorInvalidValue;
  switch (vec) {
    case 4:
      return launch<4>(gp, rp, sp, cp, op, n, k_slots, dim, st);
    case 2:
      return launch<2>(gp, rp, sp, cp, op, n, k_slots, dim, st);
    case 1:
      return launch<1>(gp, rp, sp, cp, op, n, k_slots, dim, st);
  }
  return (int)cudaErrorInvalidValue;
}
