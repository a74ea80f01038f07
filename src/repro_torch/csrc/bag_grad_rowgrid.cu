// The (B, K)-grid tiling oracle of the bag's scatter-add backward, for
// Hopper (sm_90a).
//
// Replaces repro/kernels/dequant_bag/kernel.py::bag_grad_pallas_rowgrid,
// the layout the reference keeps to test its tiled backward: a (B, K)
// grid whose every step is one serial read-modify-write of one slot's
// row.  It computes what bag_grad.cu computes,
//
//   dtable[i, :] = sum over slots (b, k) with idx[b,k] == i of
//                  coeff[b,k] * g[b, :]
//
// g (B, D) fp32, coeff (B, K) fp32 (= w * scale[idx], rounded by the
// caller), idx (B, K) int32 -> dtable (V, D) fp32, zeroed by the caller
// (the reference's aliased zeros operand).  Slots with coeff == 0 are
// skipped (kernel.py:446), and each touched element becomes
// __fmaf_rn(c, g[b], row), the fused `row += c * g` of the reference's
// interpret mode, so each row's sum is the (b, k)-ordered FMA chain that
// bag_grad.cu and the plain versions compute
// (repro_torch/kernels/dequant_bag/ref.py::bag_grad_rowgrid_ref).
//
// Design: the TPU grid's schedule, not bag_grad.cu's.  bag_grad.cu sorts
// the slots by row and gives each row one owner; this kernel has no
// sort and no owner per row.  One thread owns one column and walks ALL
// slots in (b, k) order, doing each slot's read-modify-write of its
// column itself, so no two threads ever touch one address and the order
// is the grid's by construction.  Bit-equality between the two kernels
// then tests bag_grad.cu's sort-and-own schedule against the grid's.
// What bounds it on an H100 in principle: bytes (g, the indices and
// coefficients, each touched row); in fact the serial chain: each live
// slot waits for its row's load (~0.5-1 us from HBM) before its store,
// and only D threads run.  It is the oracle, kept simple; offsets are
// int64 (row * D reaches 7.9e9 at 124M rows x 64).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void bag_grad_rowgrid_kernel(const float* __restrict__ g,
                                        const int32_t* __restrict__ indices,
                                        const float* __restrict__ coeff,
                                        float* out, int64_t n_slots,
                                        int k_slots, int64_t dim) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= dim) return;
  for (int64_t s = 0; s < n_slots; ++s) {
    const float cf = coeff[s];
    if (cf != 0.0f) {
      float* dst = out + (int64_t)indices[s] * dim + c;
      *dst = __fmaf_rn(cf, g[(s / k_slots) * dim + c], *dst);
    }
  }
}

constexpr int kThreads = 128;

}  // namespace

// n_slots = B * K slots in (b, k) order.  Returns the cudaError_t of the
// launch (0 = success).
extern "C" int bag_grad_rowgrid_launch(const void* g, const void* indices,
                                       const void* coeff, void* out,
                                       long long n_slots, int k_slots,
                                       long long dim, void* stream) {
  if (n_slots <= 0 || dim <= 0) return 0;
  if (k_slots <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (dim + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  bag_grad_rowgrid_kernel<<<(unsigned)blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int32_t*>(indices),
      static_cast<const float*>(coeff), static_cast<float*>(out), n_slots,
      k_slots, dim);
  return (int)cudaGetLastError();
}
