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
// ascending and m ascending within h.  Plain fp32 FMA.  (The reference's
// kernel contracts the flattened (h, m) axis in one dot of XLA's order;
// the port meets it within a stated tolerance.)
//
// What bounds it on an H100: operations, 2 * B * O * H * M * D flops (35.1
// GFLOP over the three layers of a 512-sample xDeepFM request, O = 200, M
// = 39, D = 10, H = 39 then 200) against a few MB of inputs; the bound is
// the fp32 FFMA rate.  No tensor cores: TF32 rounds the operands to 10
// bits of mantissa and 3xTF32 splits them, so neither gives the pinned
// fp32 chain's bits (nor the 1e-6 relative tolerance the port keeps to
// the reference).  No split-K: each output's chain stays one thread's, in
// ascending k, which is what makes it bit-equal to the plain version; so
// the parallelism is the B * O * D outputs (1,024,000 at a request).
//
// What the design does about it: the layer is the GEMM
//
//   C[o, n] = sum_k A[o, k] * Z[k, n],  n = b * D + d,  k = h * M + m,
//
// A = W viewed as (O, H * M) (already row-major in k) and Z[k, n] =
// __fmul_rn(xk[b,h,d], x0[b,m,d]), which never touches device memory.
// A block of 256 threads owns all O = 200 outputs of 40 columns, so a
// 512-sample request is 128 blocks, one an SM, 8,000 outputs each, and
// nothing is padded in O (200 divides no power-of-two tile); a wider O
// takes more rows of blocks (blockIdx.y), the last one partial.  A thread
// holds a 4 x 8 register tile: o = ty + 50 i and columns tx * 4 + j and
// 20 + tx * 4 + j, so a warp's shared reads hit distinct banks.  The x0
// and xk slices of the block's columns stay in shared memory for the
// launch ((M + H) x 40 floats, 38 KB at H = 200); a column is (b, d) on
// its own, so a sample's columns may straddle two blocks (D = 6 or 128;
// D = 10 divides 40, so xDeepFM's samples never do).  Over k
// the block walks chunks of 32 with two buffers: the chunk's W tile (200
// x 32) arrives by 16-byte cp.async as the aligned pieces that cover each
// row (a row sits shifted by its misalignment: K = 1,521 leaves rows
// 4-byte aligned only), and its Z tile (32 x 40) is made from the slices,
// 4 columns a float4.  The copies and Z entries of chunk c + 1 are spread
// over chunk c's k steps, one barrier a chunk.  A k step costs a thread
// 32 FMAs, two 16-byte Z reads and a W read: 16 bytes for 4 k when K % 4
// == 0, else 4 bytes a k.  The last chunk runs only as far as K: no zero
// terms are added (fma(0, 0, -0) would turn a -0 into +0).
//
// What holds it: the shared-memory reads that deliver the operands.  The
// SM's load/store pipe moves 128 bytes a cycle, so a warp's 16-byte read
// takes it 4 cycles, and a k step's reads (12 cycles a warp at K % 4 ==
// 0) outweigh its FFMA issue (8 cycles of the SM's 4 schedulers); the W
// copies share the same pipe.  Larger register tiles cut the reads per
// FMA, but at 8,000 outputs an SM they leave one warp a scheduler, and
// 8 x 8 tiles ran slower.  Offsets are int64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileO = 200;                // outputs o a block
constexpr int kTileN = 40;                 // columns n = b * D + d a block
constexpr int kChunk = 32;                 // k a chunk
constexpr int kDepth = 1;                  // k steps a Z load runs ahead
constexpr int kThrO = 4;                   // o a thread, kRowsO apart
constexpr int kThrN = 8;                   // n a thread: runs of 4
constexpr int kRowsO = kTileO / kThrO;     // thread rows (o)
constexpr int kColsN = kTileN / kThrN;     // thread columns (n)
constexpr int kRuns = kThrN / 4;           // runs of 4 columns, 4*kColsN apart
constexpr int kWorkers = kRowsO * kColsN;  // threads with outputs
constexpr int kThreads = (kWorkers + 31) / 32 * 32;
constexpr int kPieces = kChunk / 4 + 1;    // 16-byte pieces a W row a chunk
constexpr int kWStride = kPieces * 4;      // row of the W tile (floats)
constexpr int kMyPieces = (kTileO * kPieces + kThreads - 1) / kThreads;
constexpr int kSliceRows = kThreads / kTileN;  // slice rows loaded at once
constexpr int kQuads = kTileN / 4;         // 4-column groups of a Z row
constexpr int kBuildRows = 16;             // Z rows made at once
constexpr int kBuild = kChunk / kBuildRows;  // Z float4s a builder a chunk
constexpr int kMaxDim = 128;

static_assert(kTileO % kThrO == 0 && kTileN % kThrN == 0, "tile");
static_assert(kThrN % 4 == 0 && kChunk % 4 == 0 && kTileN % 4 == 0, "tile");
static_assert(kQuads * kBuildRows <= kThreads && kChunk % kBuildRows == 0,
              "Z build");
// the k loop's hooks: copies at even steps 0.., Z entries at odd steps
// from kChunk / 2 + 1, all within the chunk
static_assert(2 * kMyPieces <= kChunk / 2 && 2 * kBuild <= kChunk / 2,
              "hooks");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, of which the first `bytes` (0..16) are read
// and the rest zero-filled
__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float part(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// kAlignedW: every W row starts 16-byte aligned (K % 4 == 0 and W
// aligned), so a thread reads 4 k of a row with one 16-byte load.
template <bool kAlignedW>
__global__ void __launch_bounds__(kThreads, 1)
cin_kernel(const float* __restrict__ w, const float* __restrict__ xk,
           const float* __restrict__ x0, float* __restrict__ out,
           int64_t batch, int o_out, int h_in, int m_in, int dim) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);     // [2][kTileO][kWStride]
  float* z_s = w_s + 2 * kTileO * kWStride;         // [2][kChunk][kTileN]
  float* x0_s = z_s + 2 * kChunk * kTileN;          // [M][kTileN]
  float* xk_s = x0_s + m_in * kTileN;               // [H][kTileN]

  const int tid = threadIdx.x;
  const int k_len = h_in * m_in;
  const int64_t n_len = batch * dim;
  const int64_t n0 = (int64_t)blockIdx.x * kTileN;
  const int o0 = blockIdx.y * kTileO;
  const int o_rows = min(kTileO, o_out - o0);

  // the x0 and xk slices of the block's columns, resident for the launch
  // (a thread keeps one column; 8 loads in flight at a time)
  if (tid < kSliceRows * kTileN) {
    const int col = tid % kTileN;
    const int64_t n = n0 + col;
    const bool live = n < n_len;
    const int64_t b = live ? n / dim : 0;
    const int d = (int)(n - b * dim);
    const float* x0c = x0 + b * m_in * dim + d;
    const float* xkc = xk + b * h_in * dim + d - (int64_t)m_in * dim;
    for (int row0 = tid / kTileN; row0 < m_in + h_in;
         row0 += 8 * kSliceRows) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int row = row0 + u * kSliceRows;
        v[u] = !live || row >= m_in + h_in ? 0.0f
               : row < m_in ? x0c[(int64_t)row * dim]
                            : xkc[(int64_t)row * dim];
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int row = row0 + u * kSliceRows;
        if (row < m_in + h_in) x0_s[row * kTileN + col] = v[u];
      }
    }
  }

  // A builder makes 4 columns (4 * bq ..) of rows bg + e * kBuildRows of
  // a Z tile, walking (h, m) from (hc, mc), the (h, m) of k = c * kChunk
  // + bg; plan_z finds the shared offsets of its operands, build_one makes
  // one float4 of entries.
  const bool builder = tid < kQuads * kBuildRows;
  const int bq = tid % kQuads;
  const int bg = tid / kQuads;
  int hc = bg / m_in, mc = bg - (bg / m_in) * m_in;
  int z_xk[kBuild], z_x0[kBuild];             // -1: no entry
  const auto plan_z = [&](int c) {
    int h = hc, m = mc;
#pragma unroll
    for (int e = 0; e < kBuild; ++e) {
      const bool live = builder && c * kChunk + bg + e * kBuildRows < k_len;
      z_xk[e] = live ? h * kTileN + 4 * bq : -1;
      z_x0[e] = m * kTileN + 4 * bq;
      m += kBuildRows;
      while (m >= m_in) {
        m -= m_in;
        ++h;
      }
    }
  };
  const auto build_one = [&](int e, float* z_buf) {
    if (z_xk[e] < 0) return;
    const float4 a = *reinterpret_cast<const float4*>(xk_s + z_xk[e]);
    const float4 b = *reinterpret_cast<const float4*>(x0_s + z_x0[e]);
    *reinterpret_cast<float4*>(z_buf + (bg + e * kBuildRows) * kTileN +
                               4 * bq) =
        make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y),
                    __fmul_rn(a.z, b.z), __fmul_rn(a.w, b.w));
  };

  // A W row's chunk is copied as the 16-byte pieces that cover it, so it
  // sits `shift` floats into its shared row (W rows are 16-byte aligned
  // only when K % 4 == 0).  k0 steps by 32 floats (128 bytes), so each
  // thread's pieces and each row's shift are the same in every chunk.  A
  // piece past the end of W is cut short and zero-filled.
  const char* w_end =
      reinterpret_cast<const char*>(w + (int64_t)o_out * k_len);
  const char* piece_src[kMyPieces];
  int piece_dst[kMyPieces];                   // -1: no piece
#pragma unroll
  for (int t = 0; t < kMyPieces; ++t) {
    const int e = tid + t * kThreads;
    const int r = e / kPieces, p = e - r * kPieces;
    piece_dst[t] = r < o_rows ? r * kWStride + 4 * p : -1;
    const uintptr_t row = reinterpret_cast<uintptr_t>(
        w + (int64_t)(o0 + min(r, o_rows - 1)) * k_len);
    piece_src[t] = reinterpret_cast<const char*>(row & ~uintptr_t(15)) +
                   16 * p;
  }
  const auto copy_one = [&](int t, int c, float* w_buf) {
    if (piece_dst[t] < 0) return;
    const char* src = piece_src[t] + (int64_t)c * kChunk * 4;
    const int64_t left = w_end - src;
    cp_async16(w_buf + piece_dst[t],
               left > 0 ? src : reinterpret_cast<const char*>(w),
               left >= 16 ? 16 : left > 0 ? (int)left : 0);
  };
  // chunk c's W and Z tiles into buffer buf, all at once
  const auto fill = [&](int c, int buf) {
    plan_z(c);
#pragma unroll
    for (int t = 0; t < kMyPieces; ++t)
      copy_one(t, c, w_s + buf * kTileO * kWStride);
    cp_async_commit();
#pragma unroll
    for (int i = 0; i < kBuild; ++i) build_one(i, z_s + buf * kChunk * kTileN);
  };

  const bool worker = tid < kWorkers;
  const int ty = tid / kColsN;              // o rows ty + i * kRowsO
  const int tx = tid % kColsN;              // n cols tx * 4 + r * 4 * kColsN
  int w_off[kThrO];                         // row start in a W buffer
#pragma unroll
  for (int i = 0; i < kThrO; ++i) {
    const int r = ty + i * kRowsO;
    const uintptr_t a = reinterpret_cast<uintptr_t>(
        w + (int64_t)(o0 + r) * k_len);
    w_off[i] = r * kWStride + (int)((a & 15) >> 2);
  }
  float acc[kThrO][kThrN];
#pragma unroll
  for (int i = 0; i < kThrO; ++i)
#pragma unroll
    for (int j = 0; j < kThrN; ++j) acc[i][j] = 0.0f;

  const int chunks = (k_len + kChunk - 1) / kChunk;
  __syncthreads();                          // the slices are in place
  if (chunks > 0) fill(0, 0);
  cp_async_wait_all();
  __syncthreads();

  // Chunk c's products read buffer c & 1 while chunk c + 1's tiles are
  // made in the other: a worker spreads its copies and Z entries over the
  // k steps, so they share the load/store pipe with the products instead
  // of taking it in a phase of their own.
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
    const bool next = c + 1 < chunks;
    if (next) {
      mc += kChunk;
      while (mc >= m_in) {
        mc -= m_in;
        ++hc;
      }
      plan_z(c + 1);
    }
    float* w_next = w_s + (buf ^ 1) * kTileO * kWStride;
    float* z_next = z_s + (buf ^ 1) * kChunk * kTileN;
    const float* wt = w_s + buf * kTileO * kWStride;
    const float* zt = z_s + buf * kChunk * kTileN + tx * 4;
    const int nk = min(kChunk, k_len - c * kChunk);
    if (worker && nk == kChunk) {
      // operands kDepth k steps ahead in a register ring (W 4 k ahead)
      float4 zr[kDepth + 1][kRuns];
      float wr[kDepth + 1][kThrO];
      float4 wv[2][kThrO];
      const auto load_k = [&](int kk) {
#pragma unroll
        for (int r = 0; r < kRuns; ++r)
          zr[kk % (kDepth + 1)][r] = *reinterpret_cast<const float4*>(
              zt + kk * kTileN + r * 4 * kColsN);
        if (!kAlignedW) {
#pragma unroll
          for (int i = 0; i < kThrO; ++i)
            wr[kk % (kDepth + 1)][i] = wt[w_off[i] + kk];
        }
      };
      const auto load_w4 = [&](int kq) {
#pragma unroll
        for (int i = 0; i < kThrO; ++i)
          wv[(kq / 4) % 2][i] =
              *reinterpret_cast<const float4*>(wt + w_off[i] + kq);
      };
      if (kAlignedW) load_w4(0);
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) load_k(kk);
#pragma unroll
      for (int kk = 0; kk < kChunk; ++kk) {
        if (kk + kDepth < kChunk) load_k(kk + kDepth);
        if (kAlignedW && kk % 4 == 0 && kk + 4 < kChunk) load_w4(kk + 4);
        if (next && kk % 2 == 0 && kk / 2 < kMyPieces)
          copy_one(kk / 2, c + 1, w_next);
        if (next && kk % 2 == 1 && kk / 2 >= kChunk / 4 &&
            kk / 2 - kChunk / 4 < kBuild)
          build_one(kk / 2 - kChunk / 4, z_next);
        const float4* z = zr[kk % (kDepth + 1)];
#pragma unroll
        for (int i = 0; i < kThrO; ++i) {
          const float wi = kAlignedW ? part(wv[(kk / 4) % 2][i], kk % 4)
                                     : wr[kk % (kDepth + 1)][i];
#pragma unroll
          for (int j = 0; j < kThrN; ++j)
            acc[i][j] = __fmaf_rn(wi, part(z[j / 4], j % 4), acc[i][j]);
        }
      }
      if (next) cp_async_commit();
    } else {
      if (worker) {
        for (int kk = 0; kk < nk; ++kk) {
          float4 z[kRuns];
#pragma unroll
          for (int r = 0; r < kRuns; ++r)
            z[r] = *reinterpret_cast<const float4*>(zt + kk * kTileN +
                                                    r * 4 * kColsN);
#pragma unroll
          for (int i = 0; i < kThrO; ++i) {
            const float wi = wt[w_off[i] + kk];
#pragma unroll
            for (int j = 0; j < kThrN; ++j)
              acc[i][j] = __fmaf_rn(wi, part(z[j / 4], j % 4), acc[i][j]);
          }
        }
      }
      if (next) fill(c + 1, buf ^ 1);
    }
    cp_async_wait_all();
    __syncthreads();
  }

  if (!worker) return;
#pragma unroll
  for (int j = 0; j < kThrN; ++j) {
    const int64_t n = n0 + tx * 4 + (j / 4) * 4 * kColsN + j % 4;
    if (n >= n_len) continue;
    const int64_t b = n / dim;
    const int d = (int)(n - b * dim);
#pragma unroll
    for (int i = 0; i < kThrO; ++i) {
      const int o = o0 + ty + i * kRowsO;
      if (o < o_out) out[(b * o_out + o) * dim + d] = acc[i][j];
    }
  }
}

}  // namespace

// 1 <= dim <= 128, m_in >= 1.  Returns the cudaError_t of the launch
// (0 = success).
extern "C" int cin_launch(const void* w, const void* xk, const void* x0,
                          void* out, long long batch, int o_out, int h_in,
                          int m_in, int dim, void* stream) {
  if (batch <= 0 || o_out <= 0 || dim <= 0) return 0;
  if (dim > kMaxDim || h_in < 0 || m_in < 1 ||
      (long long)h_in * m_in > 0x7fffffffLL - kChunk)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (2 * kTileO * kWStride + 2 * kChunk * kTileN +
                       ((size_t)m_in + h_in) * kTileN);
  const bool aligned = (long long)h_in * m_in % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const auto kernel = aligned ? cin_kernel<true> : cin_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long grid_n = (batch * dim + kTileN - 1) / kTileN;
  const int grid_o = (o_out + kTileO - 1) / kTileO;
  if (grid_n > 0x7fffffffLL || grid_o > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)grid_n, (unsigned)grid_o);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(xk),
      static_cast<const float*>(x0), static_cast<float*>(out), batch, o_out,
      h_in, m_in, dim);
  return (int)cudaGetLastError();
}
