// Row-piece loads and stores shared by the gather kernels (dequant_bag.cu,
// hashed_gather.cu).
//
// A lane owns COLS consecutive columns of a row (4 or 8) and reads the
// bytes they cover with the widest loads the row's alignment allows: W
// bytes a load, W a power of two between the element size and 16 bytes
// that divides the payload pointer and the row's byte width (the host
// side picks W with `piece_bytes`).  A row of xDeepFM's D = 10 then reads
// as 2-byte (int8), 4-byte (bf16, fp16) or 8-byte (fp32) pieces, four
// columns a lane, where one element a thread took 1- to 4-byte loads; a
// 16-byte aligned row of D = 64 reads as 16-byte pieces.  The bytes land
// in 32-bit registers (`raw`), zero past the lane's last column, and are
// converted to fp32 only where the caller consumes them, so all of a
// window's loads are issued before the first conversion waits on one.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace gather_io {

template <int W> struct Word;
template <> struct Word<1> { typedef unsigned char T; };
template <> struct Word<2> { typedef unsigned short T; };
template <> struct Word<4> { typedef unsigned int T; };
template <> struct Word<8> { typedef uint2 T; };
template <> struct Word<16> { typedef uint4 T; };

// 32-bit registers holding COLS elements of T
template <typename T, int COLS>
__host__ __device__ constexpr int raw_words() {
  return (COLS * (int)sizeof(T) + 3) / 4;
}

// The widest load (a power of two, at most `cap` bytes) that divides the
// address `ptr` and the row width `row_bytes`: every row start and every
// lane's first column (a multiple of COLS elements) is then aligned to it.
inline int piece_bytes(const void* ptr, long long row_bytes, int cap) {
  const unsigned long long a =
      (unsigned long long)(uintptr_t)ptr | (unsigned long long)row_bytes |
      (unsigned long long)cap;
  return (int)(a & (~a + 1ull));
}

// The bytes of elements [0, n) at p (n <= COLS), W bytes a load, into raw
// (zeroed by the caller; N >= raw_words<T, COLS>()).  W divides p's
// address and n * sizeof(T).
template <typename T, int COLS, int W, int N>
__device__ __forceinline__ void read_w(const T* __restrict__ p, int n,
                                       uint32_t (&raw)[N]) {
  constexpr int kPer = W / (int)sizeof(T);
  static_assert(kPer >= 1 && COLS % kPer == 0, "bad piece width");
  static_assert(N >= raw_words<T, COLS>(), "raw too small");
  typedef typename Word<W>::T P;
  const P* src = reinterpret_cast<const P*>(p);
#pragma unroll
  for (int q = 0; q < COLS / kPer; ++q) {
    if (q * kPer < n) {
      const P x = __ldg(src + q);
      if constexpr (W < 4) {
        raw[(q * W) / 4] |= (uint32_t)x << (8 * ((q * W) % 4));
      } else if constexpr (W == 4) {
        raw[q] = x;
      } else if constexpr (W == 8) {
        raw[2 * q] = x.x;
        raw[2 * q + 1] = x.y;
      } else {
        raw[4 * q] = x.x;
        raw[4 * q + 1] = x.y;
        raw[4 * q + 2] = x.z;
        raw[4 * q + 3] = x.w;
      }
    }
  }
}

// read_w with the piece width chosen at run time (uniform across the
// launch): `w` is piece_bytes' answer for a cap of min(16, COLS *
// sizeof(T)).
template <typename T, int COLS, int N>
__device__ __forceinline__ void read_cols(const T* __restrict__ p, int n,
                                          int w, uint32_t (&raw)[N]) {
  constexpr int E = (int)sizeof(T);
  constexpr int kTop = COLS * E < 16 ? COLS * E : 16;
  constexpr int kHalf = kTop / 2 >= E ? kTop / 2 : E;
  constexpr int kQuarter = kTop / 4 >= E ? kTop / 4 : E;
  if (w >= kTop) {
    read_w<T, COLS, kTop>(p, n, raw);
  } else if (w >= kHalf) {
    read_w<T, COLS, kHalf>(p, n, raw);
  } else if (w >= kQuarter) {
    read_w<T, COLS, kQuarter>(p, n, raw);
  } else {
    read_w<T, COLS, E>(p, n, raw);
  }
}

// element i of raw as fp32 (exact for every type)
template <typename T, int N>
__device__ __forceinline__ float elem(const uint32_t (&raw)[N], int i) {
  if constexpr (std::is_same<T, int8_t>::value) {
    return (float)(int8_t)(raw[i >> 2] >> (8 * (i & 3)));
  } else if constexpr (std::is_same<T, float>::value) {
    return __uint_as_float(raw[i]);
  } else {
    const unsigned short h = (unsigned short)(raw[i >> 1] >> (16 * (i & 1)));
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      return __uint_as_float((uint32_t)h << 16);
    else
      return __half2float(__ushort_as_half(h));
  }
}

// Store v[0, n) at p (n <= COLS), `w` bytes a store (piece_bytes of the
// output row, capped at 16).
template <int COLS>
__device__ __forceinline__ void write_cols(float* __restrict__ p, int n,
                                           int w, const float (&v)[COLS]) {
  if (w >= 16) {
#pragma unroll
    for (int q = 0; q < COLS / 4; ++q)
      if (4 * q < n)
        *reinterpret_cast<float4*>(p + 4 * q) =
            make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else if (w >= 8) {
#pragma unroll
    for (int q = 0; q < COLS / 2; ++q)
      if (2 * q < n)
        *reinterpret_cast<float2*>(p + 2 * q) =
            make_float2(v[2 * q], v[2 * q + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < COLS; ++i)
      if (i < n) p[i] = v[i];
  }
}

}  // namespace gather_io
