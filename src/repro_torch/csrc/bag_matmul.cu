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
// no payload and stage exact zeros; every slot is still multiplied, so a
// non-finite w3 under a dead slot still gives NaN, as the plain version.
//
// Contract with the reference: the order its kernel computes where its
// tests run it (Pallas interpret mode), pinned by the plain PyTorch
// version (repro_torch/kernels/bag_matmul/ref.py).  Each staged row is
// __fmul_rn(__fmul_rn(row, s), w), rounded to fp32; per field k a product
// chain prod = __fmaf_rn(rows[b,k,d], w3[k,d,h], prod) runs over d
// ascending from 0; then acc = __fadd_rn(acc, prod) over k ascending.
// Plain fp32 FMA, no TF32 tensor cores: the contract is that fp32 sum.
// With SCALE_AFTER (the int8-direct form) rows are the raw converted
// payload and prod is multiplied by __fmul_rn(s, w) before the add.  One
// thread owns each output, so the reduction over (k, d) never splits.
//
// What bounds it on an H100: the FFMA rate over all slots.  Every slot of
// every tier launch is multiplied (dead ones by zero rows), 2 * K * D * H
// flops a bag against K * D payload bytes, so the fp32 pipes (67 TFLOP/s
// outside the tensor cores) set the floor: ~20 us for wide&deep's B 512,
// K 40, D 32, H 1024.  What the design does about it:
//
//   * each thread keeps a 2 x 4 (or 2 x 2) register tile of prod and acc
//     and reads its operands from shared memory as float2 / float4: rows
//     are staged depth-major ([z][bag], z = k * D + d), so a thread's bags
//     are one vector, and w3 as [z][h], so its columns are one.  At these
//     sizes (~4,000 outputs an SM) small tiles and 8 warps a block beat
//     4 x 4 tiles and 2-4 warps: the chains' latencies need the warps;
//   * a stage (two __syncthreads) covers a slab of F fields (F * D ~ 128
//     deep) or, at D > 128, a 128-deep part of one field, not one field;
//   * the slabs are double-buffered: while slab s's FMAs run, slab s+1's
//     w3 rows (contiguous runs of H) and payload rows (where they are
//     16-byte multiples) come by bulk copy on an mbarrier, its scales and
//     narrower rows by cp.async, and slab s+2's slot indices and weights
//     by plain loads; the rows are dequantised into shared memory when
//     their slab begins;
//   * the block tile is 32 bags x 64 columns, or 32 x 32 when the larger
//     tile would leave SMs without a block, so that the grid covers the
//     card at B = 512 x H = 1024 (256 blocks) and at B = 512 x H = 400
//     (208 blocks).  That is the analytic pick; the entry also takes
//     either tile by argument (the measured autotune cache's pick), and
//     since one thread owns each output, neither changes a bit.
//
// Row offsets are int64.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kTileB = 32;             // bags a block
constexpr int kTM = 2;                 // bags a thread
constexpr int kDepth = 128;            // slab depth (F * D, or a part)
constexpr int kMaxFields = 16;         // fields a slab
constexpr int kMaxDim = 384;

__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

// One slab: fields [k0, k0 + nf), depths [d0, d0 + dn) of each.
struct Slab {
  int k0, nf, d0, dn;
  bool ends;     // the slab closes its fields' product chains
};

__device__ __forceinline__ Slab slab_of(int s, int f, int parts, int dim,
                                        int k_slots) {
  Slab sl;
  if (parts == 1) {
    sl.k0 = s * f;
    sl.nf = min(f, k_slots - sl.k0);
    sl.d0 = 0;
    sl.dn = dim;
    sl.ends = true;
  } else {
    const int part = s % parts;
    sl.k0 = s / parts;
    sl.nf = 1;
    sl.d0 = part * kDepth;
    sl.dn = min(kDepth, dim - sl.d0);
    sl.ends = part == parts - 1;
  }
  return sl;
}

// cp.async of 8 or 4 bytes; with `valid` < 4, only that many bytes are
// read and the rest of the destination is zero-filled
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid));
}

// bulk copies (the copy engine, not the load/store units), completed on
// an mbarrier; a wait traps instead of hanging if a phase never completes
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
      smem_addr(bar)));
}
// adds `bytes` to the phase's expected transfer (no arrival)
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (long long spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1LL << 24)) __trap();
  }
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ float from_bits(unsigned short u,
                                           const __nv_bfloat16*) {
  return __bfloat162float(__ushort_as_bfloat16(u));
}
__device__ __forceinline__ float from_bits(unsigned short u, const __half*) {
  return __half2float(__ushort_as_half(u));
}

// element e of a chunk of T's packed into 16 bytes
template <typename T>
__device__ __forceinline__ float chunk_elem(const uint4& c, int e) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[e]);
  } else if constexpr (sizeof(T) == 2) {
    return from_bits((unsigned short)(w[e / 2] >> (16 * (e % 2))),
                     static_cast<const T*>(nullptr));
  } else {
    return (float)(int8_t)(w[e / 4] >> (8 * (e % 4)));
  }
}

template <int N>
__device__ __forceinline__ void load_vec(float (&v)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  }
}

// A block owns 32 bags x BN columns; a thread 2 adjacent bags x TN
// adjacent columns (TN = 2 or 4).
template <typename T, bool SCALE_AFTER, int BN, int TN>
__global__ void __launch_bounds__((kTileB / kTM) * (BN / TN))
bag_matmul_kernel(const T* __restrict__ payload,
                  const float* __restrict__ scales,
                  const int32_t* __restrict__ indices,
                  const float* __restrict__ weights,
                  const float* __restrict__ w3, float* __restrict__ out,
                  int64_t num_bags, int k_slots, int dim, int h_out,
                  int fields, int parts, int slabs, int depth, int lb,
                  int raw_stride, int w3_vec) {
  // w3 rows and 16-byte payload rows go by bulk copy, on one mbarrier a
  // slab buffer; the rest (scales, odd widths) by cp.async
  const bool bulk_w3 = w3_vec, bulk_rows = lb == 16;
  const bool bulk = bulk_w3 || bulk_rows;
  __shared__ __align__(8) uint64_t s_full[2];
  constexpr int CG = BN / TN;                  // threads along H
  constexpr int NT = (kTileB / kTM) * CG;
  constexpr int NW = NT / 32;
  constexpr int EPC = 16 / (int)sizeof(T);     // elements a 16-byte chunk
  constexpr int NMETA = kMaxFields * kTileB / NT;
  extern __shared__ __align__(16) float smem[];
  // staged rows [depth][kTileB]; w3 slabs [2][depth][BN]; scale_after
  // coefficients and scales [fields][kTileB]; slot indices and weights
  // [3][fields][kTileB]; raw payload rows [fields][kTileB][raw_stride]
  const int fk = fields * kTileB;
  float* rbuf = smem;
  float* wbuf = rbuf + depth * kTileB;
  float* cbuf = wbuf + 2 * depth * BN;
  float* sbuf = cbuf + fk;
  int32_t* ibuf = reinterpret_cast<int32_t*>(sbuf + fk);
  float* mwbuf = reinterpret_cast<float*>(ibuf + 3 * fk);
  unsigned char* raw = reinterpret_cast<unsigned char*>(mwbuf + 3 * fk);

  const int tid = threadIdx.x;
  const int tx = tid % CG;
  const int ty = tid / CG;
  const int lane = tid & 31;           // staging: the lane is the bag
  const int wid = tid >> 5;
  const int64_t b0 = (int64_t)blockIdx.x * kTileB;
  const int h0 = blockIdx.y * BN;
  const int row_bytes = dim * (int)sizeof(T);

  // slot indices and weights of a slab -> registers, entry e being field
  // e % nf of bag e / nf; stored after the FMAs
  int32_t m_idx[NMETA];
  float m_w[NMETA];
  auto load_meta = [&](int s) {
    const Slab sl = slab_of(s, fields, parts, dim, k_slots);
    int kk = tid % sl.nf, bl = tid / sl.nf;
    const int step_bl = NT / sl.nf, step_kk = NT - step_bl * sl.nf;
#pragma unroll
    for (int i = 0; i < NMETA; ++i) {
      m_idx[i] = 0;
      m_w[i] = 0.0f;
      if (bl < kTileB && b0 + bl < num_bags) {
        const int64_t at = (b0 + bl) * k_slots + sl.k0 + kk;
        m_idx[i] = indices[at];
        m_w[i] = weights[at];
      }
      kk += step_kk;
      bl += step_bl + (kk >= sl.nf);
      if (kk >= sl.nf) kk -= sl.nf;
    }
  };
  auto store_meta = [&](int s) {
    const Slab sl = slab_of(s, fields, parts, dim, k_slots);
    int32_t* ib = ibuf + (s % 3) * fk;
    float* wb = mwbuf + (s % 3) * fk;
    int kk = tid % sl.nf, bl = tid / sl.nf;
    const int step_bl = NT / sl.nf, step_kk = NT - step_bl * sl.nf;
#pragma unroll
    for (int i = 0; i < NMETA; ++i) {
      if (bl < kTileB) {
        ib[kk * kTileB + bl] = m_idx[i];
        wb[kk * kTileB + bl] = m_w[i];
      }
      kk += step_kk;
      bl += step_bl + (kk >= sl.nf);
      if (kk >= sl.nf) kk -= sl.nf;
    }
  };

  // this thread's bulk bytes for slab s, added to its phase before the
  // barrier that precedes the copies (thread 0 arrives after it)
  auto post_bytes = [&](int s) {
    const Slab sl = slab_of(s, fields, parts, dim, k_slots);
    const float* wb = mwbuf + (s % 3) * fk;
    unsigned bytes = 0;
    if (bulk_w3) {
      const int rows = sl.nf * sl.dn;
      if (tid < rows)
        bytes += ((rows - 1 - tid) / NT + 1) * 4 * min(BN, h_out - h0);
    }
    if (bulk_rows)
      for (int e = tid; e < sl.nf * kTileB; e += NT)
        if (wb[e] != 0.0f) bytes += sl.dn * (int)sizeof(T);
    if (bytes) mbar_expect(&s_full[s & 1], bytes);
  };
  // slab s's w3 rows, payload rows and scales -> shared memory,
  // asynchronously (one cp.async commit group, and the bulk copies on
  // s_full[s & 1], whose bytes each thread posted before)
  auto copy_slab = [&](int s) {
    const Slab sl = slab_of(s, fields, parts, dim, k_slots);
    const int32_t* ib = ibuf + (s % 3) * fk;
    const float* wb = mwbuf + (s % 3) * fk;
    float* wdst = wbuf + (s & 1) * depth * BN;
    uint64_t* bar = &s_full[s & 1];
    const int rows = sl.nf * sl.dn;
    if (bulk_w3 || bulk_rows)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (bulk_w3) {
      const unsigned bytes = 4 * min(BN, h_out - h0);
      int z = tid, kk = z / sl.dn, d = z - kk * sl.dn;
      for (; z < rows; z += NT) {
        bulk_copy(wdst + z * BN,
                  w3 + ((int64_t)(sl.k0 + kk) * dim + sl.d0 + d) * h_out + h0,
                  bytes, bar);
        d += NT;
        while (d >= sl.dn) {
          d -= sl.dn;
          ++kk;
        }
      }
    } else {
      for (int e = tid; e < rows * BN; e += NT) {
        const int z = e / BN, j = e - z * BN;
        const int kk = z / sl.dn, d = z - kk * sl.dn;
        const int64_t src =
            ((int64_t)(sl.k0 + kk) * dim + sl.d0 + d) * h_out + h0 + j;
        const bool in = h0 + j < h_out;
        cp_async4(wdst + z * BN + j, in ? w3 + src : w3, in ? 4 : 0);
      }
    }
    // the slab's scales (every slot's under SCALE_AFTER, which multiplies
    // dead slots' products by s * 0 too; else the live ones')
    if (scales != nullptr) {
      for (int e = tid; e < sl.nf * kTileB; e += NT) {
        if (SCALE_AFTER || wb[e] != 0.0f)
          cp_async4(sbuf + e, scales + ib[e], 4);
      }
    }
    const int bytes = sl.dn * (int)sizeof(T);
    if (bulk_rows) {
      // the live rows (dead slots of a small tier all point at one row)
      for (int e = tid; e < sl.nf * kTileB; e += NT)
        if (wb[e] != 0.0f)
          bulk_copy(raw + e * raw_stride,
                    reinterpret_cast<const unsigned char*>(payload) +
                        (int64_t)ib[e] * row_bytes + sl.d0 * (int)sizeof(T),
                    bytes, bar);
    } else if (lb >= 4) {
      // the live rows' bytes, lb at a time (rows that allow no 4-byte
      // access are read from global memory when staged)
      const int pieces = bytes / lb;
      int kk = wid / pieces, pc = wid % pieces;
      for (; kk < sl.nf;) {
        const int e = kk * kTileB + lane;
        if (wb[e] != 0.0f) {
          const unsigned char* src =
              reinterpret_cast<const unsigned char*>(payload) +
              (int64_t)ib[e] * row_bytes + sl.d0 * (int)sizeof(T) + pc * lb;
          unsigned char* dst = raw + e * raw_stride + pc * lb;
          if (lb == 8)
            cp_async8(dst, src);
          else
            cp_async4(dst, src, 4);
        }
        pc += NW;
        while (pc >= pieces) {
          pc -= pieces;
          ++kk;
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // slab s's rows, dequantised and weighted, -> rbuf [z][bag]; a thread
  // takes 16-byte pieces of one bag's row (the lane is the bag)
  auto stage_rows = [&](int s) {
    const Slab sl = slab_of(s, fields, parts, dim, k_slots);
    const int cpr = (sl.dn * (int)sizeof(T) + 15) / 16;
    const int32_t* ib = ibuf + (s % 3) * fk;
    const float* wb = mwbuf + (s % 3) * fk;
    int kk = wid / cpr, c = wid % cpr;
    for (; kk < sl.nf;) {
      const int e = kk * kTileB + lane;
      const float w = wb[e];
      const float sv = scales != nullptr ? sbuf[e] : 1.0f;
      if (SCALE_AFTER && c == 0) cbuf[e] = __fmul_rn(sv, w);
      float x[EPC];
      if (w == 0.0f) {
#pragma unroll
        for (int i = 0; i < EPC; ++i) x[i] = 0.0f;
      } else if (lb >= 4) {
        const uint4 v =
            *reinterpret_cast<const uint4*>(raw + e * raw_stride + c * 16);
#pragma unroll
        for (int i = 0; i < EPC; ++i) x[i] = chunk_elem<T>(v, i);
      } else {
        const T* src = payload + (int64_t)ib[e] * dim + sl.d0 + c * EPC;
#pragma unroll
        for (int i = 0; i < EPC; ++i)
          x[i] = c * EPC + i < sl.dn ? to_f32(src[i]) : 0.0f;
      }
      float* dst = rbuf + (kk * sl.dn + c * EPC) * kTileB + lane;
#pragma unroll
      for (int i = 0; i < EPC; ++i) {
        if (c * EPC + i < sl.dn) {
          float v = 0.0f;
          if (w != 0.0f) {
            if (SCALE_AFTER)
              v = x[i];
            else if (scales != nullptr)
              v = __fmul_rn(__fmul_rn(x[i], sv), w);
            else
              v = __fmul_rn(x[i], w);
          }
          dst[i * kTileB] = v;
        }
      }
      c += NW;
      while (c >= cpr) {
        c -= cpr;
        ++kk;
      }
    }
  };

  float acc[kTM][TN], prod[kTM][TN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = prod[i][j] = 0.0f;

  // prologue: the first two slabs' slots, then slab 0's copies
  if (tid == 0) {
    mbar_init(&s_full[0]);
    mbar_init(&s_full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (slabs > 0) {
    load_meta(0);
    store_meta(0);
    if (slabs > 1) {
      load_meta(1);
      store_meta(1);
    }
    __syncthreads();   // the slots of slabs 0 and 1 are stored
    if (bulk) {
      post_bytes(0);
      __syncthreads();
      if (tid == 0) mbar_arrive(&s_full[0]);
    }
    copy_slab(0);
  }

  for (int s = 0; s < slabs; ++s) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    if (bulk) mbar_wait(&s_full[s & 1], (s >> 1) & 1);
    __syncthreads();   // slab s landed; slab s-1's FMAs are done
    stage_rows(s);
    const bool next = s + 1 < slabs, after = s + 2 < slabs;
    if (after) load_meta(s + 2);
    if (bulk && next) post_bytes(s + 1);
    __syncthreads();   // slab s staged; the raw rows and scales are free
    if (bulk && next && tid == 0) mbar_arrive(&s_full[(s + 1) & 1]);
    if (next) copy_slab(s + 1);

    const Slab sl = slab_of(s, fields, parts, dim, k_slots);
    const float* rb = rbuf + ty * kTM;
    const float* wb = wbuf + (s & 1) * depth * BN + tx * TN;
    const float* cb = cbuf + ty * kTM;
    for (int kk = 0; kk < sl.nf; ++kk) {
      const int zk = kk * sl.dn;
#pragma unroll 4
      for (int d = 0; d < sl.dn; ++d) {
        const int z = zk + d;
        float av[kTM], bv[TN];
        load_vec<kTM>(av, rb + z * kTileB);
        load_vec<TN>(bv, wb + z * BN);
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            prod[i][j] = __fmaf_rn(av[i], bv[j], prod[i][j]);
      }
      if (sl.ends) {
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float c = SCALE_AFTER ? cb[kk * kTileB + i] : 1.0f;
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const float p = SCALE_AFTER ? __fmul_rn(prod[i][j], c)
                                        : prod[i][j];
            acc[i][j] = __fadd_rn(acc[i][j], p);
            prod[i][j] = 0.0f;
          }
        }
      }
    }
    if (after) store_meta(s + 2);
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t b = b0 + ty * kTM + i;
    if (b >= num_bags) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int h = h0 + tx * TN + j;
      if (h < h_out) out[b * h_out + h] = acc[i][j];
    }
  }
}

constexpr int kMaxDevices = 64;

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess)
      count = 132;
  }
  return count;
}

template <typename T, bool SCALE_AFTER, int BN, int TN>
int launch(const void* payload, const float* scales, const int32_t* indices,
           const float* weights, const float* w3, float* out,
           int64_t num_bags, int k_slots, int dim, int h_out,
           cudaStream_t stream) {
  constexpr int NT = (kTileB / kTM) * (BN / TN);
  // slab geometry: F whole fields ~kDepth deep (at most kMaxFields), or
  // 128-deep parts of a field past D = 128
  int fields = 1, parts = 1, depth;
  if (dim <= kDepth) {
    fields = std::min((kDepth + dim - 1) / dim, kMaxFields);
    fields = std::max(1, std::min(fields, k_slots));
    depth = fields * dim;
  } else {
    parts = (dim + kDepth - 1) / kDepth;
    depth = kDepth;
  }
  const int slabs = parts == 1 ? (k_slots + fields - 1) / fields
                               : k_slots * parts;
  // the widest payload access every row start and slab offset allows
  const int row_bytes = dim * (int)sizeof(T);
  const uintptr_t base = reinterpret_cast<uintptr_t>(payload);
  int lb = 16;
  while (lb > (int)sizeof(T) && (row_bytes % lb != 0 || base % lb != 0))
    lb /= 2;
  // a raw row's bytes, in 16-byte units, off a multiple of 128 bytes so
  // that the lanes' 16-byte reads of one piece spread over the banks
  int raw_stride = (std::min(dim, kDepth) * (int)sizeof(T) + 15) / 16 * 16;
  if (raw_stride % 128 == 0) raw_stride += 16;
  const int w3_vec =
      h_out % 4 == 0 && reinterpret_cast<uintptr_t>(w3) % 16 == 0;
  const size_t fk = (size_t)fields * kTileB;
  const size_t smem = sizeof(float) * ((size_t)depth * (kTileB + 2 * BN) +
                                       8 * fk) +
                      fk * raw_stride;
  auto kernel = bag_matmul_kernel<T, SCALE_AFTER, BN, TN>;
  // the whole shared-memory carveout (so that two blocks fit) and the
  // dynamic limit, set once a device for the largest slab seen there (a
  // function's attributes are the current device's)
  static size_t set_smem[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return (int)cudaErrorInvalidDevice;
  if (smem > set_smem[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    set_smem[dev] = smem;
  }
  const int64_t grid_b = (num_bags + kTileB - 1) / kTileB;
  const int grid_h = (h_out + BN - 1) / BN;
  if (grid_b > 2147483647LL || grid_h > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)grid_b, (unsigned)grid_h);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(payload), scales, indices, weights, w3, out,
      num_bags, k_slots, dim, h_out, fields, parts, slabs, depth, lb,
      raw_stride, w3_vec);
  return (int)cudaGetLastError();
}

// The analytic block width: 32 x 64 blocks (2 x 4 outputs a thread),
// unless that grid leaves SMs without a block: then 32 x 32 blocks (2 x 2
// a thread); 256 threads either way.
int analytic_block_h(int64_t num_bags, int h_out) {
  const int64_t wide =
      ((num_bags + kTileB - 1) / kTileB) * ((h_out + 63) / 64);
  return wide >= sm_count() ? 64 : 32;
}

// block_b, block_h: the tiling, bags and outputs a block (0, 0 = the
// analytic pick; built: 32 x 64 and 32 x 32).  One thread owns each
// output and its (k, d) reduction, so the tiling changes no bit.
template <typename T, bool SCALE_AFTER>
int tile(const void* payload, const float* scales, const int32_t* indices,
         const float* weights, const float* w3, float* out, int64_t num_bags,
         int k_slots, int dim, int h_out, int block_b, int block_h,
         cudaStream_t stream) {
  if (block_b == 0 && block_h == 0) {
    block_b = kTileB;
    block_h = analytic_block_h(num_bags, h_out);
  }
  if (block_b != kTileB || (block_h != 64 && block_h != 32))
    return (int)cudaErrorInvalidValue;
  if (block_h == 64)
    return launch<T, SCALE_AFTER, 64, 4>(payload, scales, indices, weights,
                                         w3, out, num_bags, k_slots, dim,
                                         h_out, stream);
  return launch<T, SCALE_AFTER, 32, 2>(payload, scales, indices, weights, w3,
                                       out, num_bags, k_slots, dim, h_out,
                                       stream);
}

template <typename T>
int dispatch(const void* payload, const float* scales,
             const int32_t* indices, const float* weights, const float* w3,
             float* out, int64_t num_bags, int k_slots, int dim, int h_out,
             int scale_after, int block_b, int block_h, cudaStream_t stream) {
  if (scale_after)
    return tile<T, true>(payload, scales, indices, weights, w3, out,
                         num_bags, k_slots, dim, h_out, block_b, block_h,
                         stream);
  return tile<T, false>(payload, scales, indices, weights, w3, out, num_bags,
                        k_slots, dim, h_out, block_b, block_h, stream);
}

}  // namespace

// dtype: 0 = int8, 1 = bf16, 2 = fp32, 3 = fp16.  1 <= dim <= 384.
// block_b, block_h: the tiling (0, 0 = the analytic pick).  Returns the
// cudaError_t of the launch (0 = success; an unbuilt tiling is
// cudaErrorInvalidValue).
extern "C" int bag_matmul_launch(const void* payload, int dtype,
                                 const void* scales, const void* indices,
                                 const void* weights, const void* w3,
                                 void* out, long long num_bags, int k_slots,
                                 int dim, int h_out, int scale_after,
                                 int block_b, int block_h, void* stream) {
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
                              h_out, scale_after, block_b, block_h, st);
    case 1:
      return dispatch<__nv_bfloat16>(payload, s, i, w, m, o, num_bags,
                                     k_slots, dim, h_out, scale_after,
                                     block_b, block_h, st);
    case 2:
      return dispatch<float>(payload, s, i, w, m, o, num_bags, k_slots, dim,
                             h_out, scale_after, block_b, block_h, st);
    case 3:
      return dispatch<__half>(payload, s, i, w, m, o, num_bags, k_slots, dim,
                              h_out, scale_after, block_b, block_h, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The analytic tiling for a launch of this shape on the current device:
// out[0] = bags a block, out[1] = outputs a block.
extern "C" int bag_matmul_tiling(long long num_bags, int h_out, int* out) {
  if (num_bags <= 0 || h_out <= 0) return (int)cudaErrorInvalidValue;
  out[0] = kTileB;
  out[1] = analytic_block_h(num_bags, h_out);
  return 0;
}
