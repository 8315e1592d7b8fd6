// Fused BFP dequant-matmul for Hopper (sm_90a) on the tensor cores:
// out = x @ dequant(W) for W packed in any of the eight GGUF weight
// formats (Q2_K, Q3_K, Q3_K_O, Q4_0, Q4_K, Q5_K, Q6_K, Q8_0) in the
// reference's structure-of-arrays layout (N on the minor axis, sub-byte
// fields in slab order along K).
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
// reference. Small integers become floats exactly through the bits
// 0x4B000000 | q (the float 2^23 + q) less 2^23 + offset. The bf16 values
// that reach the tensor cores are bit for bit the plain version's bf16(w).
// The wrapper hands x over already in bf16.
//
// Bound on this card. At decode M (the serving slots, 4) the work is a
// GEMV: the bound is the packed bytes over HBM bandwidth (a tinyllama-1.1b
// q3_k forward reads 427 MB, 0.127 ms at 3.35 TB/s), and what stands in
// its way is too few blocks in flight and launch latency. At prefill M
// (512) the product is above the bf16 ridge: q3_k's 720 GFLOP a forward
// take 0.73 ms at the tensor cores' 989 TFLOP/s and 10.8 ms at the CUDA
// cores' 67 TFLOP/s f32, so the products must run on the tensor cores, the
// dequantization (CUDA cores) must be shared by as many tokens as
// possible, and the staged bytes (chiefly the x tile, read again for every
// column tile) must stay few.
//
// Design. The kernel computes out^T = W^T x^T with
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32: A (16 x 16) is 16 output
// columns by 16 k of dequantized weight, B (16 x 8) 16 k by 8 tokens of x,
// the f32 accumulator 16 columns by 8 tokens. The tokens sit on the mma's
// 8-wide axis, so decode pads M = 4 to 8 lanes, not to 16 or 64.
//   * A block is 8 warps and owns 128 output columns (16 a warp) and a
//     token tile of NG 8-token groups (NG = 1, 2, 4 or 8 by M). A warp's A
//     row g is column 2g of its 16 and row g + 8 is column 2g + 1, so a
//     thread's two columns are neighbouring bytes of a packed row: one
//     16-bit shared-memory load reads both.
//   * Each thread dequantizes only the 8 weights its A fragment holds
//     (2 columns by k = 2t, 2t+1, 2t+8, 2t+9 of the k16 step), four at a
//     time in the bytes of one 32-bit word, from packed words it loads from
//     the staged tile once a tile (a packed byte holds 2 to 8 steps'
//     fields). A k16 step is one 16-row block of Q2_K/Q3_K/Q6_K or half a
//     32-row block of Q4_0/Q4_K/Q5_K/Q8_0, so one scale a column serves
//     the whole step. The fragment is reused by every 8-token group of the
//     token tile (B fragments by ldmatrix, two groups a load): the weight
//     is dequantized ceil(M / 64) times.
//   * The block stages each 256-row super-block's packed arrays (its 128
//     columns) and the bf16 x tile in shared memory with 16-byte cp.async
//     copies, double-buffered; token rows >= M and k >= K are zero-filled,
//     not read. Packed rows are padded to 144 bytes and x rows to 264
//     values, so the fragment loads hit distinct banks.
//   * One main loop for every M: the same instruction sequence runs for
//     M = 1 and M = 512; the token tile only sets how many groups share a
//     fragment. Within a split each output sums its k16 steps in ascending
//     k, and an mma's output element depends only on its own column of A
//     and row of B, so a row's value never depends on M or on its place in
//     a group or tile: batched admission equals sequential admission.
//   * A K split fixed by (K, N), never by M: the wrapper passes S =
//     k_splits(K, N), which divides the super-blocks along K, chosen so
//     that column tiles times S fill the 132 SMs at decode. Split s of an
//     output sums its own super-blocks from zero, and the S partials are
//     added in ascending s. Where the block tiles alone are fewer than
//     kFoldTiles (decode, every M <= 32, and small N) the splits are spread
//     over blocks: each writes f32 partials to the workspace (S, M, N) and
//     a second kernel sums them and casts. Where full 64-token tiles give
//     kFoldTiles blocks or more (prefill), one block runs its tile's splits
//     in turn and adds them in registers: the same f32 operations in the
//     same order, so the same bits, without S * M * N * 8 bytes through
//     device memory. S = 1 writes the output directly. No atomics.
//   * The output tile goes through shared memory, so stores coalesce
//     along N.
// Q4_0 and Q8_0 have 32-row super-blocks, so their K need only be a
// multiple of 32: the last 256-row tile is then partial and its missing
// steps are not run. Packed rows lie ld elements apart, ld a multiple of
// 16 (N itself, or N padded once when the QTensor was laid out on the
// card), so every row starts on a 16-byte boundary; a chunk that starts
// below N may read pad lanes, whose columns are never stored. wgmma and
// TMA are for later.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBN = 16 * kWarps;  // output columns a block, 16 a warp
constexpr int kSB = 256;          // rows a staged tile (a k-quant super-block)
constexpr int kGroups = 8;        // 8-token groups in the largest token tile
constexpr int kRowB = kBN + 16;   // bytes a staged byte-array row
constexpr int kRowH = kBN + 8;    // halves a staged fp16-array row
constexpr int kRowX = kSB + 8;    // bf16 a staged x row
constexpr int kRowO = kBN + 8;    // floats an output-tile row
// The splits of a tile run in one block (folded) where full token tiles
// alone give this many blocks, three quarters of the H100's 132 SMs.
constexpr int kFoldTiles = 99;
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

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

__device__ __forceinline__ float half_bits(uint32_t h) {
  return __half2float(__ushort_as_half(static_cast<uint16_t>(h)));
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

// acc (16 columns x 8 tokens, f32) += A (16 columns x 16 k) B (16 k x 8)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B fragments (k 2t, 2t+1 and 2t+8, 2t+9 of token g) of two 8-token
// groups (x4) or one (x2), from rows of 8 bf16 whose shared addresses the
// lanes supply
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&b)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&b)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(addr));
}

template <int VARIANT, int NG>
struct Tile {
  using F = Fmt<VARIANT>;
  alignas(16) uint8_t a0[F::kR0][kRowB];
  alignas(16) uint8_t a1[at_least_1(F::kR1)][kRowB];
  alignas(16) uint8_t a2[at_least_1(F::kR2)][kRowB];
  alignas(16) uint8_t a3[at_least_1(F::kR3)][kRowB];
  // fp16 arrays and bf16 x kept as raw bits: shared memory takes no
  // constructors
  alignas(16) uint16_t h0[F::kH0][kRowH];
  alignas(16) uint16_t h1[at_least_1(F::kH1)][kRowH];
  alignas(16) uint16_t x[8 * NG][kRowX];
};

struct Ptrs {
  const uint8_t* a[4];
  const uint16_t* h[2];
};

// Copy rows [tile * NROWS, tile * NROWS + NROWS) of a packed (rows, N)
// array of E-byte elements, whose rows lie ld elements apart, into dst
// (NROWS rows of DST_STRIDE bytes), as 16-byte chunks of the block's
// columns. Chunks that start past N (the ragged last block) or past the
// array's last row (the partial last tile of a 32-row format) are filled
// with zeros.
template <int NROWS, int E, int DST_STRIDE>
__device__ __forceinline__ void copy_rows(void* dst, const void* src,
                                          int tile, int total_rows, int N,
                                          int ld, int col0, int tid) {
  constexpr int kChunks = kBN * E / 16;   // per row
  constexpr int kPerChunk = 16 / E;       // elements per chunk
  const int row0 = tile * NROWS;
  for (int c = tid; c < NROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = (c % kChunks) * kPerChunk;
    const bool ok = row0 + r < total_rows && col0 + cc < N;
    const char* s = static_cast<const char*>(src) +
                    ((size_t)(row0 + r) * ld + col0 + cc) * E;
    cp_async16(static_cast<char*>(dst) + r * DST_STRIDE + cc * E,
               ok ? s : src, ok);
  }
}

// Start the copies of tile sb into t; x rows past M and x columns past K
// are zero-filled.
template <int VARIANT, int NG>
__device__ __forceinline__ void start_tile_copies(
    Tile<VARIANT, NG>& t, int sb, const __nv_bfloat16* x, const Ptrs& p,
    int M, int K, int N, int ld, int m0, int col0) {
  using F = Fmt<VARIANT>;
  const int tid = threadIdx.x;
  // a packed array with R rows a tile has K * R / 256 rows in all
  const int k32 = K / 32;
  copy_rows<F::kR0, 1, kRowB>(&t.a0[0][0], p.a[0], sb, k32 * F::kR0 / 8, N,
                              ld, col0, tid);
  if constexpr (F::kR1 > 0)
    copy_rows<F::kR1, 1, kRowB>(&t.a1[0][0], p.a[1], sb, k32 * F::kR1 / 8,
                                N, ld, col0, tid);
  if constexpr (F::kR2 > 0)
    copy_rows<F::kR2, 1, kRowB>(&t.a2[0][0], p.a[2], sb, k32 * F::kR2 / 8,
                                N, ld, col0, tid);
  if constexpr (F::kR3 > 0)
    copy_rows<F::kR3, 1, kRowB>(&t.a3[0][0], p.a[3], sb, k32 * F::kR3 / 8,
                                N, ld, col0, tid);
  copy_rows<F::kH0, 2, kRowH * 2>(&t.h0[0][0], p.h[0], sb, k32 * F::kH0 / 8,
                                  N, ld, col0, tid);
  if constexpr (F::kH1 > 0)
    copy_rows<F::kH1, 2, kRowH * 2>(&t.h1[0][0], p.h[1], sb,
                                    k32 * F::kH1 / 8, N, ld, col0, tid);
  for (int c = tid; c < 8 * NG * (kSB / 8); c += kThreads) {  // 8 a chunk
    const int m = c / (kSB / 8), kk = sb * kSB + (c % (kSB / 8)) * 8;
    const bool ok = m0 + m < M && kk < K;
    cp_async16(&t.x[m][kk - sb * kSB],
               ok ? x + (size_t)(m0 + m) * K + kk : x, ok);
  }
}

// This thread's two bytes (columns c0, c1) of row r of a staged byte
// array, cb the byte offset of c0
__device__ __forceinline__ uint32_t row_bytes(const uint8_t (*a)[kRowB],
                                              int r, int cb) {
  return *reinterpret_cast<const uint16_t*>(&a[r][cb]);
}

// Bytes [c0 of row r, c1 of row r, c0 of row r+1, c1 of row r+1]
__device__ __forceinline__ uint32_t two_rows(const uint8_t (*a)[kRowB],
                                             int r, int cb) {
  return __byte_perm(row_bytes(a, r, cb), row_bytes(a, r + 1, cb), 0x5410);
}

// The two fp16 values of this thread's columns in row r, as floats
__device__ __forceinline__ void two_halves(const uint16_t (*h)[kRowH], int r,
                                           int c, float (&v)[2]) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(&h[r][c]);
  v[0] = half_bits(u & 0xFFFFu);
  v[1] = half_bits(u >> 16);
}

// byte i of q as a float, less offset: exact for bytes < 2^8
__device__ __forceinline__ float byte_f(uint32_t q, int i, float offset) {
  return __fsub_rn(__int_as_float(__byte_perm(q, 0x4B000000u, 0x7440 | i)),
                   8388608.f + offset);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows of a staged byte array that a tile's k16 steps read, loaded once a
// tile: of 16-row group q, half h, two_rows at row 16q + 2t + 8h
template <int GROUPS>
struct Rows {
  uint32_t w[GROUPS][2];
};
template <int GROUPS>
__device__ __forceinline__ void load_rows(Rows<GROUPS>& rw,
                                          const uint8_t (*a)[kRowB], int cb,
                                          int t) {
#pragma unroll
  for (int q = 0; q < GROUPS; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      rw.w[q][h] = two_rows(a, 16 * q + 2 * t + 8 * h, cb);
}

// Per-tile values of this thread's columns: the super-block's d and dmin,
// the packed rows its steps read (r0: qs/ql, r1: hmask/qh), and q3_k_o's
// sidecar rows (local index less 2t) and values.
template <int VARIANT>
struct Consts {
  static constexpr int kO = VARIANT == kQ3O ? 8 : 1;
  // 16-row groups of a0 and a1 that the steps read (1 where unused)
  static constexpr int kG0 =
      VARIANT == kQ2 || VARIANT == kQ3 || VARIANT == kQ3O ? 4
      : VARIANT == kQ80                                   ? 1
                                                          : 8;
  static constexpr int kG1 =
      VARIANT == kQ3 || VARIANT == kQ3O || VARIANT == kQ5 ? 2
      : VARIANT == kQ6                                    ? 4
                                                          : 1;
  float dd[2], dm[2];
  Rows<kG0> r0;
  Rows<kG1> r1;
  int od[2][kO];
  float ov[2][kO];
};

template <int VARIANT, int NG>
__device__ __forceinline__ void load_consts(const Tile<VARIANT, NG>& s,
                                            Consts<VARIANT>& c, int cb,
                                            int t) {
  using F = Fmt<VARIANT>;
  if constexpr (F::kH0 == 1) two_halves(s.h0, 0, cb, c.dd);
  if constexpr (F::kH1 == 1) two_halves(s.h1, 0, cb, c.dm);
  if constexpr (VARIANT != kQ80) load_rows(c.r0, s.a0, cb, t);
  if constexpr (VARIANT == kQ3 || VARIANT == kQ3O || VARIANT == kQ5 ||
                VARIANT == kQ6)
    load_rows(c.r1, s.a1, cb, t);
  if constexpr (VARIANT == kQ3O) {
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const uint32_t idx = row_bytes(s.a3, o, cb);
      float v[2];
      two_halves(s.h1, o, cb, v);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        c.od[i][o] = (int)((idx >> (8 * i)) & 0xFFu) - 2 * t;
        c.ov[i][o] = v[i];
      }
    }
  }
}

// The A fragment of k16 step B (rows 16B .. 16B+15 of the staged tile):
// a[0] = (column c0; k 2t, 2t+1), a[1] = (c1; 2t, 2t+1), a[2] = (c0; 2t+8,
// 2t+9), a[3] = (c1; 2t+8, 2t+9), each pair of bf16 lowest k first.
// Packed rows of row r = 16B + kk of the super-block, kk = 2t + 8h + j:
//   2-bit qs (q2_k, q3_k), 2-bit qh (q6_k): field r / 64 of row r % 64
//   1-bit hmask (q3_k), 1-bit qh (q5_k):    field r / 32 of row r % 32
//   4-bit ql (q6_k), qs (q4_k, q5_k):       field r / 128 of row r % 128
//   4-bit qs of q4_0 (32-row slabs):        field (r / 16) % 2 of row
//                                           (r / 32) * 16 + r % 16
//   int8 qs of q8_0:                        row r
template <int VARIANT, int NG, int B>
__device__ __forceinline__ void fragment(const Tile<VARIANT, NG>& s,
                                         const Consts<VARIANT>& c, int cb,
                                         int t, uint32_t (&a)[4]) {
  constexpr int kBB = B >> 1;   // 32-row block of the step
  float scale[2], mn[2] = {0.f, 0.f};
  if constexpr (VARIANT == kQ2) {
    const uint32_t u = row_bytes(s.a1, B, cb);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t scb = (u >> (8 * i)) & 0xFFu;
      scale[i] = __fmul_rn(c.dd[i], (float)(scb & 15u));
      mn[i] = __fmul_rn(c.dm[i], (float)(scb >> 4));
    }
  } else if constexpr (VARIANT == kQ3 || VARIANT == kQ3O) {
    const uint32_t u = row_bytes(s.a2, B, cb);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      scale[i] = __fmul_rn(c.dd[i], (float)((u >> (8 * i)) & 0xFFu) - 32.f);
  } else if constexpr (VARIANT == kQ6) {
    const uint32_t u = row_bytes(s.a2, B, cb);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      scale[i] = __fmul_rn(c.dd[i], (float)(int8_t)((u >> (8 * i)) & 0xFFu));
  } else if constexpr (VARIANT == kQ4 || VARIANT == kQ5) {
    const uint8_t(*sc)[kRowB] = VARIANT == kQ4 ? s.a1 : s.a2;
    const uint8_t(*mi)[kRowB] = VARIANT == kQ4 ? s.a2 : s.a3;
    const uint32_t us = row_bytes(sc, kBB, cb);
    const uint32_t um = row_bytes(mi, kBB, cb);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      scale[i] = __fmul_rn(c.dd[i], (float)((us >> (8 * i)) & 0xFFu));
      mn[i] = __fmul_rn(c.dm[i], (float)((um >> (8 * i)) & 0xFFu));
    }
  } else {  // q4_0, q8_0: one fp16 d per 32-row block
    two_halves(s.h0, kBB, cb, scale);
  }
  constexpr float kOffset = VARIANT == kQ3 || VARIANT == kQ3O ? 4.f
                            : VARIANT == kQ6                  ? 32.f
                            : VARIANT == kQ40                 ? 8.f
                            : VARIANT == kQ80                 ? 128.f
                                                              : 0.f;

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t q;
    if constexpr (VARIANT == kQ2) {
      q = (c.r0.w[B & 3][h] >> (2 * (B >> 2))) & 0x03030303u;
    } else if constexpr (VARIANT == kQ3 || VARIANT == kQ3O) {
      q = ((c.r0.w[B & 3][h] >> (2 * (B >> 2))) & 0x03030303u) |
          (((c.r1.w[B & 1][h] >> (B >> 1)) & 0x01010101u) << 2);
    } else if constexpr (VARIANT == kQ6) {
      q = ((c.r0.w[B & 7][h] >> (4 * (B >> 3))) & 0x0F0F0F0Fu) |
          (((c.r1.w[B & 3][h] >> (2 * (B >> 2))) & 0x03030303u) << 4);
    } else if constexpr (VARIANT == kQ4 || VARIANT == kQ5) {
      q = (c.r0.w[B & 7][h] >> (4 * (B >> 3))) & 0x0F0F0F0Fu;
      if constexpr (VARIANT == kQ5)
        q |= ((c.r1.w[B & 1][h] >> (B >> 1)) & 0x01010101u) << 4;
    } else if constexpr (VARIANT == kQ40) {
      q = (c.r0.w[kBB][h] >> (4 * (B & 1))) & 0x0F0F0F0Fu;
    } else {  // q8_0: int8 codes, biased to unsigned bytes
      q = two_rows(s.a0, 16 * B + 2 * t + 8 * h, cb) ^ 0x80808080u;
    }
    // w[i]: byte i of q, column i & 1, row 2t + 8h + (i >> 1) of the step
    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = __fmul_rn(scale[i & 1], byte_f(q, i, kOffset));
      if constexpr (VARIANT == kQ2 || VARIANT == kQ4 || VARIANT == kQ5)
        w[i] = __fsub_rn(w[i], mn[i & 1]);
      if constexpr (VARIANT == kQ3O) {
        // the reference's compare-select, in its order; od is the sidecar
        // row less 2t, so row 16B + 2t + 8h + j matches od == 16B + 8h + j
#pragma unroll
        for (int o = 0; o < 8; ++o)
          if (c.od[i & 1][o] == 16 * B + 8 * h + (i >> 1))
            w[i] = c.ov[i & 1][o];
      }
    }
    a[2 * h] = pack_bf16(w[0], w[2]);       // column c0, k r and r + 1
    a[2 * h + 1] = pack_bf16(w[1], w[3]);   // column c1
  }
}

// One k16 step: build the fragment once, then one mma per 8-token group.
// xaddr: this lane's ldmatrix row of the x tile (see tile_product).
template <int VARIANT, int NG, int B>
__device__ __forceinline__ void step(const Tile<VARIANT, NG>& s,
                                     const Consts<VARIANT>& c,
                                     float (&acc)[NG][4], int cb, int t,
                                     unsigned xaddr) {
  uint32_t a[4];
  fragment<VARIANT, NG, B>(s, c, cb, t, a);
#pragma unroll
  for (int j = 0; j < NG; j += 2) {
    uint32_t b[4];
    const unsigned addr = xaddr + (8 * j * kRowX + 16 * B) * 2;
    if constexpr (NG == 1) {
      ldmatrix_x2(b, addr);
      mma_bf16(acc[j], a, b[0], b[1]);
    } else {
      ldmatrix_x4(b, addr);
      mma_bf16(acc[j], a, b[0], b[1]);
      mma_bf16(acc[j + 1], a, b[2], b[3]);
    }
  }
}

template <int VARIANT, int NG, int... Bs>
__device__ __forceinline__ void steps(const Tile<VARIANT, NG>& s,
                                      const Consts<VARIANT>& c,
                                      float (&acc)[NG][4], int cb, int t,
                                      unsigned xaddr, int nsteps) {
  if constexpr (Fmt<VARIANT>::kSuper == kSB) {
    (step<VARIANT, NG, Bs>(s, c, acc, cb, t, xaddr), ...);
  } else {
    // the partial last tile of a 32-row format runs only its steps
    ((Bs < nsteps ? step<VARIANT, NG, Bs>(s, c, acc, cb, t, xaddr)
                  : void()),
     ...);
  }
}

template <int VARIANT, int NG>
__device__ __forceinline__ void tile_product(const Tile<VARIANT, NG>& s,
                                             float (&acc)[NG][4], int cb,
                                             int nsteps) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  Consts<VARIANT> c;
  load_consts(s, c, cb, t);
  // ldmatrix rows: lane l gives row l % 8 of matrix l / 8, that is token
  // 8 (l / 16) + l % 8 at k 8 ((l / 8) % 2) of the step
  const unsigned xaddr = static_cast<unsigned>(__cvta_generic_to_shared(
      &s.x[8 * (lane >> 4) + (lane & 7)][8 * ((lane >> 3) & 1)]));
  steps<VARIANT, NG, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15>(
      s, c, acc, cb, t, xaddr, nsteps);
}

// FOLD: the block runs every split of its tile in turn, each into fresh
// accumulators, and adds them in ascending s in registers: the same f32
// operations, in the same order, as sum_splits_kernel on the workspace.
template <int VARIANT, int NG, bool FOLD>
__global__ void __launch_bounds__(kThreads)
bfp_matmul_kernel(const __nv_bfloat16* __restrict__ x, const Ptrs p,
                  void* __restrict__ out, int out_dtype,
                  float* __restrict__ ws, int tiles_per_split, int M, int K,
                  int N, int ld) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tile<VARIANT, NG>* tiles = reinterpret_cast<Tile<VARIANT, NG>*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * 8 * NG;
  const int split = blockIdx.z;
  // this thread's columns of the block: A row g is column cl, row g + 8
  // column cl + 1
  const int cl = 16 * warp + 2 * g;

  // acc: the current split's sum; tot: the folded splits' sum
  float acc[NG][4], tot[FOLD ? NG : 1][4];
#pragma unroll
  for (int j = 0; j < NG; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  // one split's super-blocks, or (folded) every split's in turn
  const int sb0 = FOLD ? 0 : split * tiles_per_split;
  const int sb1 = FOLD ? ceil_div(K, kSB) : sb0 + tiles_per_split;
  start_tile_copies(tiles[0], sb0, x, p, M, K, N, ld, m0, col0);
  cp_async_commit();
  for (int sb = sb0; sb < sb1; ++sb) {
    const int i = sb - sb0;
    if (sb + 1 < sb1) {  // next tile's copies overlap this compute
      start_tile_copies(tiles[(i + 1) & 1], sb + 1, x, p, M, K, N, ld, m0,
                        col0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    tile_product<VARIANT, NG>(tiles[i & 1], acc, cl,
                              min(kSB, K - sb * kSB) / 16);
    if constexpr (FOLD) {
      if ((sb + 1) % tiles_per_split == 0) {
        // a split ends: tot = ((s0 + s1) + s2) + ...
#pragma unroll
        for (int j = 0; j < NG; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            tot[j][e] = sb + 1 == tiles_per_split
                            ? acc[j][e]
                            : __fadd_rn(tot[j][e], acc[j][e]);
            acc[j][e] = 0.f;
          }
      }
    }
    __syncthreads();  // tile i & 1 is refilled by the next iteration
  }
  if constexpr (FOLD) {
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = tot[j][e];
  }

  // the (8 NG tokens x kBN columns) f32 tile through shared memory, so the
  // stores coalesce along N
  float* os = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const int m = 8 * j + 2 * t;
    *reinterpret_cast<float2*>(&os[m * kRowO + cl]) =
        make_float2(acc[j][0], acc[j][2]);
    *reinterpret_cast<float2*>(&os[(m + 1) * kRowO + cl]) =
        make_float2(acc[j][1], acc[j][3]);
  }
  __syncthreads();
  for (int e = tid; e < 8 * NG * kBN; e += kThreads) {
    const int m = e / kBN, n = e % kBN;
    if (m0 + m >= M || col0 + n >= N) continue;
    const float v = os[m * kRowO + n];
    const size_t o = (size_t)(m0 + m) * N + col0 + n;
    if (ws != nullptr)
      ws[(size_t)split * M * N + o] = v;
    else if (out_dtype == kBF16)
      static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
    else
      static_cast<float*>(out)[o] = v;
  }
}

// out = cast(sum_s ws[s]) over the S partials of every output, s ascending
__global__ void __launch_bounds__(256)
sum_splits_kernel(const float* __restrict__ ws, void* __restrict__ out,
                  int out_dtype, int splits, size_t total) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = ws[i];
    for (int s = 1; s < splits; ++s) v = __fadd_rn(v, ws[s * total + i]);
    if (out_dtype == kBF16)
      static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
    else
      static_cast<float*>(out)[i] = v;
  }
}

// 8-token groups in a block's token tile
int groups(int M) {
  return M <= 8 ? 1 : M <= 16 ? 2 : M <= 32 ? 4 : kGroups;
}

// Does a launch write split partials to the workspace? Not with one split,
// nor where full token tiles alone give kFoldTiles blocks and the splits
// are folded.
bool spreads_splits(int M, int N, int splits) {
  const int ng = groups(M);
  return splits > 1 && (ng < kGroups || ceil_div(N, kBN) *
                                                ceil_div(M, 8 * ng) <
                                            kFoldTiles);
}

struct Args {
  const void* x;
  Ptrs p;
  void* out;
  int out_dtype;
  float* ws;
  int splits, M, K, N, ld;
  cudaStream_t stream;
};

template <int VARIANT, int NG, bool FOLD>
cudaError_t launch_kernel(const Args& a, dim3 grid, float* ws) {
  constexpr int kTiles = 2 * sizeof(Tile<VARIANT, NG>);
  constexpr int kOut = 8 * NG * kRowO * sizeof(float);
  constexpr int smem = kTiles > kOut ? kTiles : kOut;
  if constexpr (smem > 48 * 1024) {
    // above 48 KB a block needs the opt-in; set once per instantiation
    static const cudaError_t attr = cudaFuncSetAttribute(
        bfp_matmul_kernel<VARIANT, NG, FOLD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return attr;
  }
  bfp_matmul_kernel<VARIANT, NG, FOLD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.x), a.p, a.out, a.out_dtype, ws,
      ceil_div(a.K, kSB) / a.splits, a.M, a.K, a.N, a.ld);
  return cudaGetLastError();
}

template <int VARIANT, int NG>
cudaError_t launch_ng(const Args& a) {
  const bool spread = spreads_splits(a.M, a.N, a.splits);
  if (spread && a.ws == nullptr) return cudaErrorInvalidValue;
  const dim3 grid(ceil_div(a.N, kBN), ceil_div(a.M, 8 * NG),
                  spread ? a.splits : 1);
  if constexpr (NG == kGroups) {
    if (a.splits > 1 && !spread)
      return launch_kernel<VARIANT, NG, true>(a, grid, nullptr);
  }
  const cudaError_t err =
      launch_kernel<VARIANT, NG, false>(a, grid, spread ? a.ws : nullptr);
  if (err != cudaSuccess || !spread) return err;
  const size_t total = (size_t)a.M * a.N;
  const size_t want = (total + 255) / 256;
  const int blocks = want < 4096 ? (int)want : 4096;   // grid-stride
  sum_splits_kernel<<<blocks, 256, 0, a.stream>>>(a.ws, a.out, a.out_dtype,
                                                  a.splits, total);
  return cudaGetLastError();
}

template <int VARIANT>
cudaError_t launch(int out_dtype, const void* x, const void* a0,
                   const void* a1, const void* a2, const void* a3,
                   const void* h0, const void* h1, void* out, void* ws,
                   int splits, int M, int K, int N, int ld, void* stream) {
  // 16-byte copies: every packed row must start on a 16-byte boundary;
  // the split count must divide the 256-row tiles along K
  constexpr int kSuper = Fmt<VARIANT>::kSuper;
  if (M < 1 || N < 1 || ld < N || ld % 16 || K < kSuper || K % kSuper ||
      splits < 1 || ceil_div(K, kSB) % splits ||
      (out_dtype != kF32 && out_dtype != kBF16))
    return cudaErrorInvalidValue;
  Args a{x,
         {{static_cast<const uint8_t*>(a0), static_cast<const uint8_t*>(a1),
           static_cast<const uint8_t*>(a2), static_cast<const uint8_t*>(a3)},
          {static_cast<const uint16_t*>(h0),
           static_cast<const uint16_t*>(h1)}},
         out, out_dtype, static_cast<float*>(ws), splits, M, K, N, ld,
         static_cast<cudaStream_t>(stream)};
  // the token tile only sets how many 8-token groups share a dequantized
  // fragment; every row sums in the same order whichever tile it is in
  switch (groups(M)) {
    case 1: return launch_ng<VARIANT, 1>(a);
    case 2: return launch_ng<VARIANT, 2>(a);
    case 4: return launch_ng<VARIANT, 4>(a);
    default: return launch_ng<VARIANT, kGroups>(a);
  }
}

}  // namespace

// Plain C interface, bound with ctypes. Pointers are device pointers,
// 16-byte aligned: x (M, K) contiguous in bf16, out (M, N) contiguous, ws
// an f32 workspace of S * M * N (null when splits == 1), and every packed
// array (rows, N) with its rows ld elements apart (ld >= N, a multiple of
// 16); splits (S) divides ceil(K / 256); the stream is the caller's
// current CUDA stream. The return value is the cudaError_t of the launches
// (0 on success).
// 1 if a launch at (M, N) with this split count writes partials to the
// workspace (which must then hold splits * M * N floats), else 0
extern "C" int bfp_matmul_spreads_splits(int M, int N, int splits) {
  return M >= 1 && spreads_splits(M, N, splits) ? 1 : 0;
}

extern "C" int bfp_matmul_q2_k(const void* x, const void* qs,
                               const void* scales, const void* d,
                               const void* dmin, void* out, int out_dtype,
                               void* ws, int splits, int M, int K, int N,
                               int ld, void* stream) {
  return (int)launch<kQ2>(out_dtype, x, qs, scales, nullptr, nullptr, d,
                          dmin, out, ws, splits, M, K, N, ld, stream);
}

extern "C" int bfp_matmul_q3_k(const void* x, const void* qs,
                               const void* hmask, const void* scales,
                               const void* d, void* out, int out_dtype,
                               void* ws, int splits, int M, int K, int N,
                               int ld, void* stream) {
  return (int)launch<kQ3>(out_dtype, x, qs, hmask, scales, nullptr, d,
                          nullptr, out, ws, splits, M, K, N, ld, stream);
}

extern "C" int bfp_matmul_q3_k_o(const void* x, const void* qs,
                                 const void* hmask, const void* scales,
                                 const void* d, const void* oidx,
                                 const void* ovals, void* out, int out_dtype,
                                 void* ws, int splits, int M, int K, int N,
                                 int ld, void* stream) {
  return (int)launch<kQ3O>(out_dtype, x, qs, hmask, scales, oidx, d, ovals,
                           out, ws, splits, M, K, N, ld, stream);
}

extern "C" int bfp_matmul_q4_0(const void* x, const void* qs, const void* d,
                               void* out, int out_dtype, void* ws,
                               int splits, int M, int K, int N, int ld,
                               void* stream) {
  return (int)launch<kQ40>(out_dtype, x, qs, nullptr, nullptr, nullptr, d,
                           nullptr, out, ws, splits, M, K, N, ld, stream);
}

extern "C" int bfp_matmul_q4_k(const void* x, const void* qs,
                               const void* scales, const void* mins,
                               const void* d, const void* dmin, void* out,
                               int out_dtype, void* ws, int splits, int M,
                               int K, int N, int ld, void* stream) {
  return (int)launch<kQ4>(out_dtype, x, qs, scales, mins, nullptr, d, dmin,
                          out, ws, splits, M, K, N, ld, stream);
}

extern "C" int bfp_matmul_q5_k(const void* x, const void* qs, const void* qh,
                               const void* scales, const void* mins,
                               const void* d, const void* dmin, void* out,
                               int out_dtype, void* ws, int splits, int M,
                               int K, int N, int ld, void* stream) {
  return (int)launch<kQ5>(out_dtype, x, qs, qh, scales, mins, d, dmin, out,
                          ws, splits, M, K, N, ld, stream);
}

extern "C" int bfp_matmul_q6_k(const void* x, const void* ql, const void* qh,
                               const void* scales, const void* d, void* out,
                               int out_dtype, void* ws, int splits, int M,
                               int K, int N, int ld, void* stream) {
  return (int)launch<kQ6>(out_dtype, x, ql, qh, scales, nullptr, d, nullptr,
                          out, ws, splits, M, K, N, ld, stream);
}

extern "C" int bfp_matmul_q8_0(const void* x, const void* qs, const void* d,
                               void* out, int out_dtype, void* ws,
                               int splits, int M, int K, int N, int ld,
                               void* stream) {
  return (int)launch<kQ80>(out_dtype, x, qs, nullptr, nullptr, nullptr, d,
                           nullptr, out, ws, splits, M, K, N, ld, stream);
}
