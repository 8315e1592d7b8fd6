// Fused BFP dequant-matmul for Hopper (sm_90a): out = x @ dequant(W) for
// W packed as GGUF Q2_K, Q3_K, Q4_K or Q6_K in the reference's
// structure-of-arrays layout (N on the minor axis, sub-byte fields in slab
// order along K).
//
// Replaces: src/repro/kernels/bfp_matmul.py, bfp_matmul_pallas (its
// _kernel body and the pallas_call that launches it), for the q2_k, q3_k,
// q4_k and q6_k variants.
//
// What it computes, as the TPU kernel does:
//   out[m, n] = cast_out( sum_k f32(bf16(x[m, k])) * f32(bf16(w[k, n])) )
// with w dequantized in f32 by exactly the reference formula, then rounded
// to bf16:
//   q2_k: (d * sc) * q - dmin * mn              (16-row blocks)
//   q3_k: (d * (sc - 32)) * (lo + 4 * hi - 4)    (16-row blocks)
//   q4_k: (d * sc) * q - dmin * mn              (32-row blocks)
//   q6_k: (d * sc) * (lo + 16 * hi - 32)         (16-row blocks, sc signed)
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
// BM rows. It walks K one 256-row super-block at a time, in ascending
// order. The block stages each super-block's packed tile (the variant's
// byte arrays, d and dmin of its 128 columns) and the bf16 x tile in
// shared memory with 16-byte cp.async copies, double-buffered: the copies
// of super-block sb+1 are in flight while the threads dequantize and
// accumulate sb. Two tiles live in static shared memory where they fit in
// 48 KB and in dynamic shared memory otherwise (q4_k and q6_k at 16 rows:
// 53 and 69 KB): dynamic shared memory for every tile made the q3_k decode
// forward about a third slower on the H100 (see PERF.md). N is
// the minor axis, so a packed row of the tile is 128 contiguous bytes and
// the copies coalesce; a thread then reads its own column's byte of each
// row (conflict-free) and every x element by broadcast. Each output row
// keeps its own f32 accumulator and sums its K products in ascending k, so
// a row's value never depends on M or on BM: batched admission equals
// sequential admission because of this. There is no split-K, so at decode
// the per-thread sweep over K, not bandwidth, sets the time (only N/128
// blocks run); wgmma, TMA and split N/K pipelining are for later.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // output columns per block, one per thread
constexpr int kSB = 256;        // rows per super-block
constexpr int kQ2 = 0;
constexpr int kQ3 = 1;
constexpr int kQ4 = 2;
constexpr int kQ6 = 3;

// output dtype codes shared with the Python wrapper
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// Packed byte arrays of a variant, in the wrapper's argument order, as
// rows per super-block (0: absent), and whether it has dmin.
//   q2_k: qs (2-bit) 64, scales 16
//   q3_k: qs (2-bit) 64, hmask (1-bit) 32, scales 16
//   q4_k: qs (4-bit) 128, scales 8, mins 8
//   q6_k: ql (4-bit) 128, qh (2-bit) 64, scales (int8) 16
template <int VARIANT>
struct Fmt;
template <>
struct Fmt<kQ2> {
  static constexpr int kR0 = 64, kR1 = 16, kR2 = 0;
  static constexpr bool kDmin = true;
};
template <>
struct Fmt<kQ3> {
  static constexpr int kR0 = 64, kR1 = 32, kR2 = 16;
  static constexpr bool kDmin = false;
};
template <>
struct Fmt<kQ4> {
  static constexpr int kR0 = 128, kR1 = 8, kR2 = 8;
  static constexpr bool kDmin = true;
};
template <>
struct Fmt<kQ6> {
  static constexpr int kR0 = 128, kR1 = 64, kR2 = 16;
  static constexpr bool kDmin = false;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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
  alignas(16) uint8_t a1[F::kR1][kThreads];
  alignas(16) uint8_t a2[F::kR2 > 0 ? F::kR2 : 1][kThreads];
  // fp16 d/dmin and bf16 x kept as raw bits: shared memory takes no
  // constructors
  alignas(16) uint16_t d[kThreads];
  alignas(16) uint16_t dmin[kThreads];
  alignas(16) uint16_t x[BM][kSB];
};

// Start the copies of super-block sb into tile t. Rows of the packed
// arrays are 16-byte chunks of the block's 128 columns (8 chunks a row);
// chunks past N (ragged last block) and x rows past M are zero-filled.
template <int VARIANT, int BM>
__device__ __forceinline__ void start_tile_copies(
    Tile<VARIANT, BM>& t, int sb, const __nv_bfloat16* x, const uint8_t* a0,
    const uint8_t* a1, const uint8_t* a2, const __half* d,
    const __half* dmin, int M, int K, int N, int m0, int col0) {
  using F = Fmt<VARIANT>;
  const int tid = threadIdx.x;
  const size_t ldn = N;
  auto rows = [&](uint8_t* dst, const uint8_t* src, int nrows) {
    const int row0 = sb * nrows;
    for (int c = tid; c < nrows * 8; c += kThreads) {
      const int r = c >> 3, cc = (c & 7) * 16;
      const bool ok = col0 + cc < N;
      cp_async16(dst + r * kThreads + cc,
                 ok ? src + (size_t)(row0 + r) * ldn + col0 + cc : src, ok);
    }
  };
  rows(&t.a0[0][0], a0, F::kR0);
  rows(&t.a1[0][0], a1, F::kR1);
  if (F::kR2 > 0) rows(&t.a2[0][0], a2, F::kR2);
  if (tid < 16) {  // 128 halves = 16 chunks of d
    const int cc = tid * 8;
    const bool ok = col0 + cc < N;
    cp_async16(&t.d[cc], ok ? d + (size_t)sb * ldn + col0 + cc : d, ok);
  } else if (F::kDmin && tid < 32) {
    const int cc = (tid - 16) * 8;
    const bool ok = col0 + cc < N;
    cp_async16(&t.dmin[cc], ok ? dmin + (size_t)sb * ldn + col0 + cc : dmin,
               ok);
  }
  for (int c = tid; c < BM * (kSB / 8); c += kThreads) {  // 8 bf16 a chunk
    const int m = c / (kSB / 8), kk = (c % (kSB / 8)) * 8;
    const bool ok = m0 + m < M;
    cp_async16(&t.x[m][kk],
               ok ? x + (size_t)(m0 + m) * K + (size_t)sb * kSB + kk : x, ok);
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

// Dequantize one staged super-block of this thread's column and add its
// 256 products to every row's accumulator, in ascending k.
template <int VARIANT, int BM>
__device__ __forceinline__ void super_block(float (&acc)[BM],
                                            const Tile<VARIANT, BM>& t,
                                            int tid) {
  const float dd = __half2float(__ushort_as_half(t.d[tid]));
  const float dm =
      Fmt<VARIANT>::kDmin ? __half2float(__ushort_as_half(t.dmin[tid])) : 0.f;
  if (VARIANT == kQ4) {
#pragma unroll 1
    for (int b = 0; b < kSB / 32; ++b) {  // 32-row block
      const float scale = __fmul_rn(dd, (float)t.a1[b][tid]);
      const float mn = __fmul_rn(dm, (float)t.a2[b][tid]);
      // rows b*32 .. b*32+31: row r is field r / 128 of qs row r % 128
      const int q_shift = 4 * (b >> 2);
      const int q_row = (b & 3) * 32;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        float w[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const unsigned q = (t.a0[q_row + i + j][tid] >> q_shift) & 15u;
          w[j] = round_bf16(__fsub_rn(__fmul_rn(scale, (float)q), mn));
        }
        accumulate2(acc, t.x, b * 32 + i, w);
      }
    }
    return;
  }
#pragma unroll 1
  for (int b = 0; b < kSB / 16; ++b) {  // 16-row block
    float scale;
    float mn = 0.f;
    if (VARIANT == kQ2) {
      const unsigned scb = t.a1[b][tid];
      scale = __fmul_rn(dd, (float)(scb & 15u));
      mn = __fmul_rn(dm, (float)(scb >> 4));
    } else if (VARIANT == kQ3) {
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
        } else if (VARIANT == kQ3) {
          const unsigned lo = (t.a0[r2 + i + j][tid] >> s2) & 3u;
          const unsigned hi = (t.a1[r1 + i + j][tid] >> s1) & 1u;
          w[j] = __fmul_rn(scale, (float)(lo + (hi << 2)) - 4.f);
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
bfp_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                  const uint8_t* __restrict__ a0,
                  const uint8_t* __restrict__ a1,
                  const uint8_t* __restrict__ a2,
                  const __half* __restrict__ d,
                  const __half* __restrict__ dmin, OT* __restrict__ out,
                  int M, int K, int N) {
  Tile<VARIANT, BM>* tiles;
  if constexpr (kStatic) {
    __shared__ Tile<VARIANT, BM> st[2];
    tiles = st;
  } else {
    extern __shared__ __align__(16) unsigned char smem[];
    tiles = reinterpret_cast<Tile<VARIANT, BM>*>(smem);
  }
  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * kThreads;
  const int n = col0 + tid;
  const int m0 = blockIdx.y * BM;

  float acc[BM];
#pragma unroll
  for (int m = 0; m < BM; ++m) acc[m] = 0.f;

  const int nsb = K / kSB;
  start_tile_copies(tiles[0], 0, x, a0, a1, a2, d, dmin, M, K, N, m0, col0);
  cp_async_commit();
  for (int sb = 0; sb < nsb; ++sb) {
    if (sb + 1 < nsb) {  // next super-block's copies overlap this compute
      start_tile_copies(tiles[(sb + 1) & 1], sb + 1, x, a0, a1, a2, d, dmin,
                        M, K, N, m0, col0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    super_block<VARIANT, BM>(acc, tiles[sb & 1], tid);
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
  const void *x, *a0, *a1, *a2, *d, *dmin;
  void* out;
  int M, K, N;
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
      static_cast<const __nv_bfloat16*>(a.x),
      static_cast<const uint8_t*>(a.a0), static_cast<const uint8_t*>(a.a1),
      static_cast<const uint8_t*>(a.a2), static_cast<const __half*>(a.d),
      static_cast<const __half*>(a.dmin), static_cast<OT*>(a.out), a.M, a.K,
      a.N);
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
                   const void* a1, const void* a2, const void* d,
                   const void* dmin, void* out, int M, int K, int N,
                   void* stream) {
  // 16-byte copies: a packed row of N bytes must split into whole chunks
  if (M < 1 || N < 16 || N % 16 || K < kSB || K % kSB)
    return cudaErrorInvalidValue;
  const Args a{x, a0, a1, a2, d, dmin, out, M, K, N,
               static_cast<cudaStream_t>(stream)};
  // the row tile only sets how many rows share one pass over the packed
  // weights; every row sums in the same order whichever tile it is in
  if (M <= 4) return launch_bm<VARIANT, 4>(out_dtype, a);
  if (M <= 8) return launch_bm<VARIANT, 8>(out_dtype, a);
  return launch_bm<VARIANT, 16>(out_dtype, a);
}

}  // namespace

// Plain C interface, bound with ctypes. Pointers are device pointers of
// contiguous tensors (x in bf16), 16-byte aligned; the stream is the
// caller's current CUDA stream. The return value is the cudaError_t of
// the launch (0 on success).
extern "C" int bfp_matmul_q2_k(const void* x, const void* qs,
                               const void* scales, const void* d,
                               const void* dmin, void* out, int out_dtype,
                               int M, int K, int N, void* stream) {
  return (int)launch<kQ2>(out_dtype, x, qs, scales, nullptr, d, dmin, out, M,
                          K, N, stream);
}

extern "C" int bfp_matmul_q3_k(const void* x, const void* qs,
                               const void* hmask, const void* scales,
                               const void* d, void* out, int out_dtype, int M,
                               int K, int N, void* stream) {
  return (int)launch<kQ3>(out_dtype, x, qs, hmask, scales, d, nullptr, out,
                          M, K, N, stream);
}

extern "C" int bfp_matmul_q4_k(const void* x, const void* qs,
                               const void* scales, const void* mins,
                               const void* d, const void* dmin, void* out,
                               int out_dtype, int M, int K, int N,
                               void* stream) {
  return (int)launch<kQ4>(out_dtype, x, qs, scales, mins, d, dmin, out, M, K,
                          N, stream);
}

extern "C" int bfp_matmul_q6_k(const void* x, const void* ql, const void* qh,
                               const void* scales, const void* d, void* out,
                               int out_dtype, int M, int K, int N,
                               void* stream) {
  return (int)launch<kQ6>(out_dtype, x, ql, qh, scales, d, nullptr, out, M,
                          K, N, stream);
}
