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
// into that multiply); y = __fdiv_rn(x, scale), a division on every path
// (it must not become a multiply by 1 / scale); rintf rounds half to
// even, as jnp.round and torch.round do; the stochastic form adds 1 where
// noise < __fsub_rn(y, floor(y)).  A max is exact in any order, so a
// shuffle reduction gives the same max-abs as a serial one.  Non-finite
// rows follow the plain version: a NaN anywhere in a row makes its
// max-abs and scale NaN (as torch's amax and clamp do; fmaxf alone would
// drop it), a NaN y stays NaN through the clip, and a NaN code is stored
// as 0, as PyTorch's and XLA's float -> int8 casts give (an inf row has
// scale inf, so its inf entries give NaN and its finite ones 0).  The
// result is bit-identical to the plain PyTorch version
// (repro_torch/kernels/rowwise_quant/ref.py).
//
// What bounds it on an H100: bytes.  It reads 4 bytes and writes 1 byte
// an element (+4 bytes of noise in the stochastic form) and 4 bytes of
// scale a row; a handful of operations an element (the IEEE division is
// the dearest), far below the card's ~20 fp32 operations a byte.  A
// build chunk of the dlrm-rm2 int8 tier (3,653,765 rows x 64) moves 1.18
// GB: 0.353 ms at 3.35 TB/s.  To stream at that rate each SM must keep
// tens of KB of loads in flight.
//
// What the design does about it: a row is a group of G lanes (G a power
// of two, the smallest that covers the row's units, at most 32), so a
// warp holds 32 / G rows side by side and each lane holds up to 4 units
// of a row; a unit is a float4 (16-byte loads) when D % 4 == 0 and x and
// noise are 16-byte and q 4-byte aligned, else one float (the scalar
// path, for D = 10 of xDeepFM, D = 3, or a view one float off alignment).
// Each lane takes 4 float4 units (or 16 floats on the scalar path) of
// its rows at once, all loads issued before any arithmetic: 2 KB of x in
// flight a warp on the vector path at D = 64 (8 rows, 2 a step).  The row stays in registers between the max and the
// quantize: the max is a shuffle reduction inside the G lanes (nan_max),
// the codes of a float4 leave as one 4-byte store (a warp writes a whole
// 128-byte line at D = 64), and the warp's scales are gathered by shuffle
// into lanes 0.. and written as one contiguous store.  x and noise are
// read once, with streaming loads.  Rows wider than 128 units (D > 512
// aligned, D > 128 otherwise) take a warp a row and re-read it (the
// `wide` kernel); no path of the port has such rows.  Row offsets are
// int64: a 4M-row build chunk of D = 64 is 2.7e8 elements, the whole
// int8 tier 5.2e9.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;              // warps a block
constexpr int kVecSlots = 4;           // float4 units a lane holds at once
constexpr int kScalarSlots = 16;       // float units a lane holds at once
constexpr int kMaxUnitsPerLane = 4;
constexpr unsigned kFull = 0xffffffffu;

// max that keeps a NaN operand (fmaxf returns the other one)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

__device__ __forceinline__ float row_scale(float max_abs, float denom,
                                           int reciprocal) {
  const float m = nan_max(max_abs, 1e-12f);
  return reciprocal ? __fmul_rn(m, __fdiv_rn(1.0f, denom))
                    : __fdiv_rn(m, denom);
}

template <bool kStoch>
__device__ __forceinline__ int code(float x, float s, float n) {
  const float y = __fdiv_rn(x, s);
  float v;
  if (kStoch) {
    const float lo = floorf(y);
    v = __fadd_rn(lo, n < __fsub_rn(y, lo) ? 1.0f : 0.0f);
  } else {
    v = rintf(y);
  }
  return v != v ? 0 : (int)fminf(fmaxf(v, -128.0f), 127.0f);
}

template <int kW>
struct Unit {
  float v[kW];
};

template <int kW>
__device__ __forceinline__ Unit<kW> load_unit(const float* p) {
  Unit<kW> u;
  if constexpr (kW == 4) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    u.v[0] = t.x;
    u.v[1] = t.y;
    u.v[2] = t.z;
    u.v[3] = t.w;
  } else {
    u.v[0] = __ldcs(p);
  }
  return u;
}

template <int kW>
constexpr int kSlots = kW == 4 ? kVecSlots : kScalarSlots;

// kW floats a unit, kUpl units a lane per row, slots / kUpl rows a lane.
template <int kW, int kUpl, bool kStoch>
__global__ void __launch_bounds__(kWarps * 32)
quant_rows(const float* __restrict__ x, const float* __restrict__ noise,
           int8_t* __restrict__ q, float* __restrict__ scale, int64_t rows,
           int dim, int gshift, float denom, int reciprocal) {
  constexpr int kSteps = kSlots<kW> / kUpl;
  const int lane = threadIdx.x & 31;
  const int group = 1 << gshift;        // lanes a row
  const int rpw = 32 >> gshift;         // rows a warp step
  const int sub = lane >> gshift;
  const int j = lane & (group - 1);
  const int units = dim / kW;
  const int nrows = kSteps * rpw;       // rows a warp
  const int64_t r0 =
      ((int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5)) * nrows;

  Unit<kW> xv[kSteps][kUpl];
  Unit<kW> nv[kSteps][kUpl];
  bool live[kSteps][kUpl];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int64_t r = r0 + s * rpw + sub;
#pragma unroll
    for (int u = 0; u < kUpl; ++u) {
      const int c = j + u * group;
      live[s][u] = r < rows && c < units;
      const int64_t off = r * dim + (int64_t)c * kW;
      xv[s][u] = live[s][u] ? load_unit<kW>(x + off) : Unit<kW>{};
      if (kStoch)
        nv[s][u] = live[s][u] ? load_unit<kW>(noise + off) : Unit<kW>{};
    }
  }

  // a dead unit holds zeros, which leave a max-abs (>= 0 or NaN) as it is
  float sc[kSteps];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    float m = 0.0f;
#pragma unroll
    for (int u = 0; u < kUpl; ++u)
#pragma unroll
      for (int e = 0; e < kW; ++e) m = nan_max(m, fabsf(xv[s][u].v[e]));
    for (int off = group >> 1; off > 0; off >>= 1)
      m = nan_max(m, __shfl_xor_sync(kFull, m, off));
    sc[s] = row_scale(m, denom, reciprocal);
  }

#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int64_t r = r0 + s * rpw + sub;
#pragma unroll
    for (int u = 0; u < kUpl; ++u) {
      if (!live[s][u]) continue;
      const int64_t off = r * dim + (int64_t)(j + u * group) * kW;
      if constexpr (kW == 4) {
        unsigned packed = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          packed |= (unsigned)(code<kStoch>(xv[s][u].v[e], sc[s],
                                            kStoch ? nv[s][u].v[e] : 0.0f)
                               & 0xff) << (8 * e);
        __stcs(reinterpret_cast<unsigned*>(q + off), packed);
      } else {
        q[off] = (int8_t)code<kStoch>(xv[s][u].v[0], sc[s],
                                      kStoch ? nv[s][u].v[0] : 0.0f);
      }
    }
  }

  // row r0 + i's scale sits in step i / rpw of the lanes of group
  // i % rpw; gather the warp's rows into lanes 0.. and store them at once
  for (int base = 0; base < nrows; base += 32) {
    const int i = base + lane;
    const int src = (i & (rpw - 1)) << gshift;
    float mine = 0.0f;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const float t = __shfl_sync(kFull, sc[s], src);
      if ((i >> (5 - gshift)) == s) mine = t;
    }
    if (i < nrows && r0 + i < rows) scale[r0 + i] = mine;
  }
}

// Rows wider than kMaxUnitsPerLane * 32 units: one warp a row, lanes
// striding it; the second pass re-reads the row.
template <bool kStoch>
__global__ void __launch_bounds__(kWarps * 32)
quant_wide(const float* __restrict__ x, const float* __restrict__ noise,
           int8_t* __restrict__ q, float* __restrict__ scale, int64_t rows,
           int dim, float denom, int reciprocal) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;
  const float* xr = x + r * dim;
  float m = 0.0f;
  for (int d = lane; d < dim; d += 32) m = nan_max(m, fabsf(xr[d]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(kFull, m, off));
  const float s = row_scale(m, denom, reciprocal);
  int8_t* qr = q + r * dim;
  for (int d = lane; d < dim; d += 32)
    qr[d] = (int8_t)code<kStoch>(xr[d], s, kStoch ? noise[r * dim + d]
                                                  : 0.0f);
  if (lane == 0) scale[r] = s;
}

template <int kW, int kUpl, bool kStoch>
cudaError_t launch_rows(const float* x, const float* noise, int8_t* q,
                        float* scale, int64_t rows, int dim, int gshift,
                        float denom, int reciprocal, cudaStream_t stream) {
  const int64_t per_block =
      (int64_t)kWarps * (kSlots<kW> / kUpl) * (32 >> gshift);
  const int64_t blocks = (rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  quant_rows<kW, kUpl, kStoch><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      x, noise, q, scale, rows, dim, gshift, denom, reciprocal);
  return cudaGetLastError();
}

template <int kW, bool kStoch>
cudaError_t launch_width(const float* x, const float* noise, int8_t* q,
                         float* scale, int64_t rows, int dim, float denom,
                         int reciprocal, cudaStream_t stream) {
  const int units = dim / kW;
  int gshift = 0;
  while ((1 << gshift) < units && gshift < 5) ++gshift;
  const int upl = (units + (1 << gshift) - 1) >> gshift;
  if (upl == 1)
    return launch_rows<kW, 1, kStoch>(x, noise, q, scale, rows, dim, gshift,
                                      denom, reciprocal, stream);
  if (upl == 2)
    return launch_rows<kW, 2, kStoch>(x, noise, q, scale, rows, dim, gshift,
                                      denom, reciprocal, stream);
  return launch_rows<kW, 4, kStoch>(x, noise, q, scale, rows, dim, gshift,
                                    denom, reciprocal, stream);
}

template <bool kStoch>
cudaError_t launch(const float* x, const float* noise, int8_t* q,
                   float* scale, int64_t rows, int dim, float denom,
                   int reciprocal, cudaStream_t stream) {
  const auto aligned = [](const void* p, uintptr_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  const bool vec = dim % 4 == 0 && aligned(x, 16) &&
                   (!kStoch || aligned(noise, 16)) && aligned(q, 4);
  const int units = vec ? dim / 4 : dim;
  if (units > 32 * kMaxUnitsPerLane) {
    const int64_t blocks = (rows + kWarps - 1) / kWarps;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    quant_wide<kStoch><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
        x, noise, q, scale, rows, dim, denom, reciprocal);
    return cudaGetLastError();
  }
  if (vec)
    return launch_width<4, kStoch>(x, noise, q, scale, rows, dim, denom,
                                   reciprocal, stream);
  return launch_width<1, kStoch>(x, noise, q, scale, rows, dim, denom,
                                 reciprocal, stream);
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
  const float denom = mode == 0 ? 127.0f : 127.5f;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* nf = static_cast<const float*>(noise);
  auto* qi = static_cast<int8_t*>(q);
  auto* sf = static_cast<float*>(scale);
  const cudaError_t err =
      nf == nullptr
          ? launch<false>(xf, nf, qi, sf, rows, dim, denom, reciprocal, s)
          : launch<true>(xf, nf, qi, sf, rows, dim, denom, reciprocal, s);
  return (int)err;
}
