// Fused BFP dequant-matmul for Hopper (sm_90a): out = x @ dequant(W) for
// W packed in any of the eight GGUF weight formats (Q2_K, Q3_K, Q3_K_O,
// Q4_0, Q4_K, Q5_K, Q6_K, Q8_0) in the reference's structure-of-arrays
// layout (N on the minor axis, sub-byte fields in slab order along K).
//
// Replaces: src/repro/kernels/bfp_matmul.py, bfp_matmul_pallas (its
// _kernel body and the pallas_call that launches it), for every variant.
//
// What it computes, as the TPU kernel does:
//   out[m, n] = cast_out( sum_k f32(bf16(x[m, k])) * f32(bf16(w[k, n])) )
// with w dequantized in f32 by exactly the reference formula, then rounded
// to bf16:
//   q2_k:   (d * sc) * q - dmin * mn               (16-row blocks)
//   q3_k:   (d * (sc - 32)) * (lo + 4 * hi - 4)     (16-row blocks)
//   q3_k_o: q3_k, then the 8 sidecar rows of each super-block and column
//           replaced by their fp16 values (compare-select, before the
//           bf16 rounding, as the reference's dequantizer does)
//   q4_0:   d * (q - 8)                             (32-row blocks)
//   q4_k:   (d * sc) * q - dmin * mn               (32-row blocks)
//   q5_k:   q4_k with q = lo + 16 * hi              (32-row blocks)
//   q6_k:   (d * sc) * (lo + 16 * hi - 32)          (16-row blocks, sc signed)
//   q8_0:   d * q                                   (32-row blocks, q int8)
// The products and the difference use __fmul_rn/__fsub_rn so the compiler
// cannot contract them into an FMA that would round differently from the
// reference. A product of two bf16 values is exact in f32, so the fmaf
// accumulation below rounds exactly like a separate multiply and add. The
// wrapper hands x over already in bf16 (the cast of bf16 x is free).
//
// Bound on this card: at decode M (the number of serving slots) the work
// is a GEMV and the bound is the packed bytes over HBM bandwidth: a full
// tinyllama-1.1b forward reads about 450 MB of packed weights (19.5 MB a
// layer times 22, plus 21.5 MB for the LM head), about 134 us at
// 3.35 TB/s. At prefill M the product is still well below the bf16
// tensor-core ridge (about 295 flops a byte), so bytes stay the bound.
//
// Design (simple and correct first; not tuned to the bound yet): one block
// of 128 threads owns 128 output columns, one column a thread, and up to
// BM rows. It walks K one 256-row tile at a time, in ascending order. The
// block stages each tile's packed arrays (the variant's byte arrays and
// its fp16 arrays, of its 128 columns) and the bf16 x tile in shared
// memory with 16-byte cp.async copies, double-buffered: the copies of tile
// sb+1 are in flight while the threads dequantize and accumulate sb. Q4_0
// and Q8_0 have 32-row super-blocks, so their K need only be a multiple of
// 32: the last tile is then partial, its missing rows are zero-filled and
// never summed. Two tiles live in static shared memory where they fit in
// 48 KB and in dynamic shared memory otherwise (the 16-row tiles of
// q3_k_o, q4_0 and q4_k, and every tile of q5_k, q6_k and q8_0): dynamic
// shared memory for every tile made the q3_k decode forward about a third
// slower on the H100 (see PERF.md). N is the minor
// axis, so a packed row of the tile is 128 contiguous bytes (256 for fp16
// arrays) and the copies coalesce. Any N >= 1 is taken: packed rows lie
// ld elements apart, ld a multiple of 16 (N itself, or N padded once when
// the QTensor was laid out on the card), so every row starts on a 16-byte
// boundary; a chunk that starts below N may read pad lanes, whose columns
// are never stored; a thread then reads its own column's
// element of each row (conflict-free) and every x element by broadcast.
// Each output row keeps its own f32 accumulator and sums its K products in
// ascending k, so a row's value never depends on M or on BM: batched
// admission equals sequential admission because of this. There is no
// split-K, so at decode the per-thread sweep over K, not bandwidth, sets
// the time (only N/128 blocks run); wgmma, TMA and split N/K pipelining
// are for later.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // output columns per block, one per thread
constexpr int kSB = 256;        // rows per staged tile (a k-quant super-block)
constexpr int kQ2 = 0;
constexpr int kQ3 = 1;
constexpr int kQ4 = 2;
constexpr int kQ6 = 3;
constexpr int kQ3O = 4;
constexpr int kQ40 = 5;
constexpr int kQ5 = 6;
constexpr int kQ80 = 7;

// output dtype codes shared with the Python wrapper
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// Packed arrays of a variant, in the wrapper's argument order, as rows per
// 256-row tile (0: absent): byte arrays a0..a3, fp16 arrays h0 (d) and h1
// (dmin, or q3_k_o's outlier values); kSuper is the K granularity.
//   q2_k:   a0 qs (2-bit) 64, a1 scales 16;             h0 d 1, h1 dmin 1
//   q3_k:   a0 qs (2-bit) 64, a1 hmask (1-bit) 32, a2 scales 16;  h0 d 1
//   q3_k_o: q3_k's, a3 oidx 8;                          h0 d 1, h1 ovals 8
//   q4_0:   a0 qs (4-bit, 32-row slabs) 128;            h0 d 8
//   q4_k:   a0 qs (4-bit) 128, a1 scales 8, a2 mins 8;  h0 d 1, h1 dmin 1
//   q5_k:   a0 qs 128, a1 qh (1-bit) 32, a2 scales 8, a3 mins 8; h0, h1 1
//   q6_k:   a0 ql (4-bit) 128, a1 qh (2-bit) 64, a2 scales (int8) 16; h0 1
//   q8_0:   a0 qs (int8) 256;                           h0 d 8
template <int VARIANT>
struct Fmt;
template <>
struct Fmt<kQ2> {
  static constexpr int kR0 = 64, kR1 = 16, kR2 = 0, kR3 = 0, kH0 = 1,
                       kH1 = 1, kSuper = 256;
};
template <>
struct Fmt<kQ3> {
  static constexpr int kR0 = 64, kR1 = 32, kR2 = 16, kR3 = 0, kH0 = 1,
                       kH1 = 0, kSuper = 256;
};
template <>
struct Fmt<kQ3O> {
  static constexpr int kR0 = 64, kR1 = 32, kR2 = 16, kR3 = 8, kH0 = 1,
                       kH1 = 8, kSuper = 256;
};
template <>
struct Fmt<kQ40> {
  static constexpr int kR0 = 128, kR1 = 0, kR2 = 0, kR3 = 0, kH0 = 8,
                       kH1 = 0, kSuper = 32;
};
template <>
struct Fmt<kQ4> {
  static constexpr int kR0 = 128, kR1 = 8, kR2 = 8, kR3 = 0, kH0 = 1,
                       kH1 = 1, kSuper = 256;
};
template <>
struct Fmt<kQ5> {
  static constexpr int kR0 = 128, kR1 = 32, kR2 = 8, kR3 = 8, kH0 = 1,
                       kH1 = 1, kSuper = 256;
};
template <>
struct Fmt<kQ6> {
  static constexpr int kR0 = 128, kR1 = 64, kR2 = 16, kR3 = 0, kH0 = 1,
                       kH1 = 0, kSuper = 256;
};
template <>
struct Fmt<kQ80> {
  static constexpr int kR0 = 256, kR1 = 0, kR2 = 0, kR3 = 0, kH0 = 8,
                       kH1 = 0, kSuper = 32;
};

constexpr int at_least_1(int n) { return n > 0 ? n : 1; }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float half_bits(uint16_t h) {
  return __half2float(__ushort_as_half(h));
}

__device__ __forceinline__ void store_from_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_float(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 16-byte global -> shared copy; src_bytes = 0 fills the 16 bytes with 0
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

template <int VARIANT, int BM>
struct Tile {
  using F = Fmt<VARIANT>;
  alignas(16) uint8_t a0[F::kR0][kThreads];
  alignas(16) uint8_t a1[at_least_1(F::kR1)][kThreads];
  alignas(16) uint8_t a2[at_least_1(F::kR2)][kThreads];
  alignas(16) uint8_t a3[at_least_1(F::kR3)][kThreads];
  // fp16 arrays and bf16 x kept as raw bits: shared memory takes no
  // constructors
  alignas(16) uint16_t h0[F::kH0][kThreads];
  alignas(16) uint16_t h1[at_least_1(F::kH1)][kThreads];
  alignas(16) uint16_t x[BM][kSB];
};

struct Ptrs {
  const uint8_t* a[4];
  const uint16_t* h[2];
};

// Copy rows [tile * NROWS, tile * NROWS + NROWS) of a packed (rows, N)
// array of E-byte elements, whose rows lie ld elements apart, into dst
// (NROWS, 128), as 16-byte chunks of the block's 128 columns. Chunks that
// start past N (the ragged last block) or past the array's last row (the
// partial last tile of a 32-row format) are filled with zeros.
template <int NROWS, int E>
__device__ __forceinline__ void copy_rows(void* dst, const void* src,
                                          int tile, int total_rows, int N,
                                          int ld, int col0, int tid) {
  constexpr int kChunks = kThreads * E / 16;   // per row
  constexpr int kPerChunk = 16 / E;            // elements per chunk
  const int row0 = tile * NROWS;
  for (int c = tid; c < NROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = (c % kChunks) * kPerChunk;
    const bool ok = row0 + r < total_rows && col0 + cc < N;
    const char* s = static_cast<const char*>(src) +
                    ((size_t)(row0 + r) * ld + col0 + cc) * E;
    cp_async16(static_cast<char*>(dst) + (r * kThreads + cc) * E,
               ok ? s : src, ok);
  }
}

// Start the copies of tile sb into t; x rows past M and x columns past K
// are zero-filled.
template <int VARIANT, int BM>
__device__ __forceinline__ void start_tile_copies(
    Tile<VARIANT, BM>& t, int sb, const __nv_bfloat16* x, const Ptrs& p,
    int M, int K, int N, int ld, int m0, int col0) {
  using F = Fmt<VARIANT>;
  const int tid = threadIdx.x;
  // a packed array with R rows a tile has K * R / 256 rows in all
  const int k32 = K / 32;
  copy_rows<F::kR0, 1>(&t.a0[0][0], p.a[0], sb, k32 * F::kR0 / 8, N, ld,
                       col0, tid);
  if constexpr (F::kR1 > 0)
    copy_rows<F::kR1, 1>(&t.a1[0][0], p.a[1], sb, k32 * F::kR1 / 8, N, ld,
                         col0, tid);
  if constexpr (F::kR2 > 0)
    copy_rows<F::kR2, 1>(&t.a2[0][0], p.a[2], sb, k32 * F::kR2 / 8, N, ld,
                         col0, tid);
  if constexpr (F::kR3 > 0)
    copy_rows<F::kR3, 1>(&t.a3[0][0], p.a[3], sb, k32 * F::kR3 / 8, N, ld,
                         col0, tid);
  copy_rows<F::kH0, 2>(&t.h0[0][0], p.h[0], sb, k32 * F::kH0 / 8, N, ld,
                       col0, tid);
  if constexpr (F::kH1 > 0)
    copy_rows<F::kH1, 2>(&t.h1[0][0], p.h[1], sb, k32 * F::kH1 / 8, N, ld,
                         col0, tid);
  for (int c = tid; c < BM * (kSB / 8); c += kThreads) {  // 8 bf16 a chunk
    const int m = c / (kSB / 8), kk = sb * kSB + (c % (kSB / 8)) * 8;
    const bool ok = m0 + m < M && kk < K;
    cp_async16(&t.x[m][kk - sb * kSB],
               ok ? x + (size_t)(m0 + m) * K + kk : x, ok);
  }
}

// acc[m] += x[m, k0 + i] * w[i] for i = 0, 1, in ascending k
template <int BM>
__device__ __forceinline__ void accumulate2(float (&acc)[BM],
                                            const uint16_t (&x)[BM][kSB],
                                            int k0, const float (&w)[2]) {
#pragma unroll
  for (int m = 0; m < BM; ++m) {
    const float2 xv = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x[m][k0]));
    acc[m] = fmaf(xv.x, w[0], acc[m]);
    acc[m] = fmaf(xv.y, w[1], acc[m]);
  }
}

// The 32-row block formats: q4_0, q4_k, q5_k, q8_0. Dequantize this
// thread's column of the first nblk 32-row blocks of a staged tile and add
// their products to every row's accumulator, in ascending k.
template <int VARIANT, int BM>
__device__ __forceinline__ void blocks32(float (&acc)[BM],
                                         const Tile<VARIANT, BM>& t, int tid,
                                         int nblk) {
  const float dd = half_bits(t.h0[0][tid]);
  const float dm = Fmt<VARIANT>::kH1 > 0 ? half_bits(t.h1[0][tid]) : 0.f;
#pragma unroll 1
  for (int b = 0; b < nblk; ++b) {
    float scale = 0.f, mn = 0.f;
    if (VARIANT == kQ4) {
      scale = __fmul_rn(dd, (float)t.a1[b][tid]);
      mn = __fmul_rn(dm, (float)t.a2[b][tid]);
    } else if (VARIANT == kQ5) {
      scale = __fmul_rn(dd, (float)t.a2[b][tid]);
      mn = __fmul_rn(dm, (float)t.a3[b][tid]);
    } else {  // q4_0, q8_0: one fp16 d per 32-row block
      scale = half_bits(t.h0[b][tid]);
    }
    // row b*32 + i of the tile:
    //   4-bit qs of q4_k/q5_k (256-row slabs): field b / 4 of packed row
    //     (b % 4) * 32 + i
    //   1-bit qh of q5_k (256-row slabs):      field b of packed row i
    //   4-bit qs of q4_0 (32-row slabs):       field i / 16 of packed row
    //     b * 16 + i % 16
    const int q_shift = 4 * (b >> 2);
    const int q_row = (b & 3) * 32;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      float w[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ii = i + j;
        if (VARIANT == kQ4 || VARIANT == kQ5) {
          unsigned q = (t.a0[q_row + ii][tid] >> q_shift) & 15u;
          if (VARIANT == kQ5) q += ((t.a1[ii][tid] >> b) & 1u) << 4;
          w[j] = __fsub_rn(__fmul_rn(scale, (float)q), mn);
        } else if (VARIANT == kQ40) {
          const unsigned q =
              (t.a0[b * 16 + (ii & 15)][tid] >> (4 * (ii >> 4))) & 15u;
          w[j] = __fmul_rn(scale, (float)q - 8.f);
        } else {  // q8_0
          w[j] = __fmul_rn(scale, (float)(int8_t)t.a0[b * 32 + ii][tid]);
        }
        w[j] = round_bf16(w[j]);
      }
      accumulate2(acc, t.x, b * 32 + i, w);
    }
  }
}

// The 16-row block formats: q2_k, q3_k, q3_k_o, q6_k. Dequantize one staged
// super-block of this thread's column and add its 256 products to every
// row's accumulator, in ascending k.
template <int VARIANT, int BM>
__device__ __forceinline__ void blocks16(float (&acc)[BM],
                                         const Tile<VARIANT, BM>& t,
                                         int tid) {
  const float dd = half_bits(t.h0[0][tid]);
  const float dm = VARIANT == kQ2 ? half_bits(t.h1[0][tid]) : 0.f;
  // q3_k_o: this column's 8 sidecar rows (local index, fp16 value)
  constexpr int kO = VARIANT == kQ3O ? 8 : 1;
  int oidx[kO];
  float oval[kO];
#pragma unroll
  for (int o = 0; o < kO; ++o) {
    oidx[o] = VARIANT == kQ3O ? (int)t.a3[o][tid] : -1;
    oval[o] = VARIANT == kQ3O ? half_bits(t.h1[o][tid]) : 0.f;
  }
#pragma unroll 1
  for (int b = 0; b < kSB / 16; ++b) {  // 16-row block
    float scale;
    float mn = 0.f;
    if (VARIANT == kQ2) {
      const unsigned scb = t.a1[b][tid];
      scale = __fmul_rn(dd, (float)(scb & 15u));
      mn = __fmul_rn(dm, (float)(scb >> 4));
    } else if (VARIANT == kQ3 || VARIANT == kQ3O) {
      scale = __fmul_rn(dd, (float)t.a2[b][tid] - 32.f);
    } else {  // q6_k: the scale is a signed byte
      scale = __fmul_rn(dd, (float)(int8_t)t.a2[b][tid]);
    }
    // rows b*16 .. b*16+15 in slab order:
    //   2-bit qs (q2_k, q3_k): field r / 64 of packed row r % 64
    //   1-bit hmask (q3_k):    field r / 32 of packed row r % 32
    //   4-bit ql (q6_k):       field r / 128 of packed row r % 128
    //   2-bit qh (q6_k):       field r / 64 of packed row r % 64
    const int s2 = 2 * (b >> 2), r2 = (b & 3) * 16;
    const int s1 = b >> 1, r1 = (b & 1) * 16;
    const int s4 = 4 * (b >> 3), r4 = (b & 7) * 16;
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      float w[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (VARIANT == kQ2) {
          const unsigned lo = (t.a0[r2 + i + j][tid] >> s2) & 3u;
          w[j] = __fsub_rn(__fmul_rn(scale, (float)lo), mn);
        } else if (VARIANT == kQ3 || VARIANT == kQ3O) {
          const unsigned lo = (t.a0[r2 + i + j][tid] >> s2) & 3u;
          const unsigned hi = (t.a1[r1 + i + j][tid] >> s1) & 1u;
          w[j] = __fmul_rn(scale, (float)(lo + (hi << 2)) - 4.f);
          if (VARIANT == kQ3O) {
            // the reference's compare-select, in its order
            const int r = b * 16 + i + j;
#pragma unroll
            for (int o = 0; o < kO; ++o)
              if (oidx[o] == r) w[j] = oval[o];
          }
        } else {
          const unsigned lo = (t.a0[r4 + i + j][tid] >> s4) & 15u;
          const unsigned hi = (t.a1[r2 + i + j][tid] >> s2) & 3u;
          w[j] = __fmul_rn(scale, (float)(lo + (hi << 4)) - 32.f);
        }
        w[j] = round_bf16(w[j]);
      }
      accumulate2(acc, t.x, b * 16 + i, w);
    }
  }
}

template <int VARIANT, int BM, typename OT, bool kStatic>
__global__ void __launch_bounds__(kThreads)
bfp_matmul_kernel(const __nv_bfloat16* __restrict__ x, const Ptrs p,
                  OT* __restrict__ out, int M, int K, int N, int ld) {
  Tile<VARIANT, BM>* tiles;
  if constexpr (kStatic) {
    __shared__ Tile<VARIANT, BM> st[2];
    tiles = st;
  } else {
    extern __shared__ __align__(16) unsigned char smem[];
    tiles = reinterpret_cast<Tile<VARIANT, BM>*>(smem);
  }
  constexpr bool k32 = VARIANT == kQ40 || VARIANT == kQ4 ||
                       VARIANT == kQ5 || VARIANT == kQ80;
  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * kThreads;
  const int n = col0 + tid;
  const int m0 = blockIdx.y * BM;

  float acc[BM];
#pragma unroll
  for (int m = 0; m < BM; ++m) acc[m] = 0.f;

  const int nsb = (K + kSB - 1) / kSB;
  start_tile_copies(tiles[0], 0, x, p, M, K, N, ld, m0, col0);
  cp_async_commit();
  for (int sb = 0; sb < nsb; ++sb) {
    if (sb + 1 < nsb) {  // next tile's copies overlap this compute
      start_tile_copies(tiles[(sb + 1) & 1], sb + 1, x, p, M, K, N, ld, m0,
                        col0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (k32) {
      // a partial last tile (K % 256 != 0, 32-row formats only) sums only
      // its 32-row blocks that exist
      const int nblk = min(kSB, K - sb * kSB) / 32;
      blocks32<VARIANT, BM>(acc, tiles[sb & 1], tid, nblk);
    } else {
      blocks16<VARIANT, BM>(acc, tiles[sb & 1], tid);
    }
    __syncthreads();  // tile sb & 1 is refilled by the next iteration
  }

  if (n < N) {
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      if (m0 + m < M) store_from_float(out + (size_t)(m0 + m) * N + n, acc[m]);
    }
  }
}

struct Args {
  const void* x;
  Ptrs p;
  void* out;
  int M, K, N, ld;
  cudaStream_t stream;
};

template <int VARIANT, int BM, typename OT>
cudaError_t launch_typed(const Args& a) {
  constexpr int kTiles = 2 * sizeof(Tile<VARIANT, BM>);
  constexpr bool kStatic = kTiles <= 48 * 1024;
  constexpr int smem = kStatic ? 0 : kTiles;   // dynamic bytes
  if constexpr (!kStatic) {
    // above 48 KB a block needs the opt-in; set once per instantiation
    static const cudaError_t attr = cudaFuncSetAttribute(
        bfp_matmul_kernel<VARIANT, BM, OT, kStatic>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return attr;
  }
  dim3 grid((a.N + kThreads - 1) / kThreads, (a.M + BM - 1) / BM);
  bfp_matmul_kernel<VARIANT, BM, OT, kStatic>
      <<<grid, kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.x), a.p, static_cast<OT*>(a.out),
      a.M, a.K, a.N, a.ld);
  return cudaGetLastError();
}

template <int VARIANT, int BM>
cudaError_t launch_bm(int out_dtype, const Args& a) {
  if (out_dtype == kF32) return launch_typed<VARIANT, BM, float>(a);
  if (out_dtype == kBF16) return launch_typed<VARIANT, BM, __nv_bfloat16>(a);
  return cudaErrorInvalidValue;
}

template <int VARIANT>
cudaError_t launch(int out_dtype, const void* x, const void* a0,
                   const void* a1, const void* a2, const void* a3,
                   const void* h0, const void* h1, void* out, int M, int K,
                   int N, int ld, void* stream) {
  // 16-byte copies: every packed row must start on a 16-byte boundary
  constexpr int kSuper = Fmt<VARIANT>::kSuper;
  if (M < 1 || N < 1 || ld < N || ld % 16 || K < kSuper || K % kSuper)
    return cudaErrorInvalidValue;
  Args a{x,
         {{static_cast<const uint8_t*>(a0), static_cast<const uint8_t*>(a1),
           static_cast<const uint8_t*>(a2), static_cast<const uint8_t*>(a3)},
          {static_cast<const uint16_t*>(h0),
           static_cast<const uint16_t*>(h1)}},
         out, M, K, N, ld, static_cast<cudaStream_t>(stream)};
  // the row tile only sets how many rows share one pass over the packed
  // weights; every row sums in the same order whichever tile it is in
  if (M <= 4) return launch_bm<VARIANT, 4>(out_dtype, a);
  if (M <= 8) return launch_bm<VARIANT, 8>(out_dtype, a);
  return launch_bm<VARIANT, 16>(out_dtype, a);
}

}  // namespace

// Plain C interface, bound with ctypes. Pointers are device pointers,
// 16-byte aligned: x (M, K) contiguous in bf16, out (M, N) contiguous, and
// every packed array (rows, N) with its rows ld elements apart (ld >= N, a
// multiple of 16); the stream is the caller's current CUDA stream. The
// return value is the cudaError_t of the launch (0 on success).
extern "C" int bfp_matmul_q2_k(const void* x, const void* qs,
                               const void* scales, const void* d,
                               const void* dmin, void* out, int out_dtype,
                               int M, int K, int N, int ld, void* stream) {
  return (int)launch<kQ2>(out_dtype, x, qs, scales, nullptr, nullptr, d,
                          dmin, out, M, K, N, ld, stream);
}

extern "C" int bfp_matmul_q3_k(const void* x, const void* qs,
                               const void* hmask, const void* scales,
                               const void* d, void* out, int out_dtype, int M,
                               int K, int N, int ld, void* stream) {
  return (int)launch<kQ3>(out_dtype, x, qs, hmask, scales, nullptr, d,
                          nullptr, out, M, K, N, ld, stream);
}

extern "C" int bfp_matmul_q3_k_o(const void* x, const void* qs,
                                 const void* hmask, const void* scales,
                                 const void* d, const void* oidx,
                                 const void* ovals, void* out, int out_dtype,
                                 int M, int K, int N, int ld, void* stream) {
  return (int)launch<kQ3O>(out_dtype, x, qs, hmask, scales, oidx, d, ovals,
                           out, M, K, N, ld, stream);
}

extern "C" int bfp_matmul_q4_0(const void* x, const void* qs, const void* d,
                               void* out, int out_dtype, int M, int K, int N,
                               int ld, void* stream) {
  return (int)launch<kQ40>(out_dtype, x, qs, nullptr, nullptr, nullptr, d,
                           nullptr, out, M, K, N, ld, stream);
}

extern "C" int bfp_matmul_q4_k(const void* x, const void* qs,
                               const void* scales, const void* mins,
                               const void* d, const void* dmin, void* out,
                               int out_dtype, int M, int K, int N, int ld,
                               void* stream) {
  return (int)launch<kQ4>(out_dtype, x, qs, scales, mins, nullptr, d, dmin,
                          out, M, K, N, ld, stream);
}

extern "C" int bfp_matmul_q5_k(const void* x, const void* qs, const void* qh,
                               const void* scales, const void* mins,
                               const void* d, const void* dmin, void* out,
                               int out_dtype, int M, int K, int N, int ld,
                               void* stream) {
  return (int)launch<kQ5>(out_dtype, x, qs, qh, scales, mins, d, dmin, out,
                          M, K, N, ld, stream);
}

extern "C" int bfp_matmul_q6_k(const void* x, const void* ql, const void* qh,
                               const void* scales, const void* d, void* out,
                               int out_dtype, int M, int K, int N, int ld,
                               void* stream) {
  return (int)launch<kQ6>(out_dtype, x, ql, qh, scales, nullptr, d, nullptr,
                          out, M, K, N, ld, stream);
}

extern "C" int bfp_matmul_q8_0(const void* x, const void* qs, const void* d,
                               void* out, int out_dtype, int M, int K, int N,
                               int ld, void* stream) {
  return (int)launch<kQ80>(out_dtype, x, qs, nullptr, nullptr, nullptr, d,
                           nullptr, out, M, K, N, ld, stream);
}
