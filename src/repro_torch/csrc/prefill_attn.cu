// Fused prefill attention for Hopper (sm_90a) on the tensor cores: flash
// attention with an online softmax, masked by position, GQA folded into
// rows.
//
// Replaces: src/repro/kernels/prefill_attn.py, prefill_attn_fused (its
// _kernel body and the pallas_call that launches it).
//
// What it computes, as the TPU kernel does: for query row (b, c, h) and
// key t of batch row b and KV head kh = h / G,
//   s = (q . k) * scale                 (f32 sum of exact products)
//   s = tanh(s / softcap) * softcap     (only with a softcap)
//   visible: kv_pos >= 0, kv_pos <= q_pos, kv_pos > q_pos - window
//   s = NEG_INF (-1e30, not -inf) where not visible
// with the running max m, denominator l and accumulator acc in f32, one
// divide by max(l, 1e-30) at the end and one cast to q's dtype. A row
// with no visible key at all is garbage, as on the reference's path.
//
// Bound on this card: chip_smoke.py computes it from the data of its run.
// At the serving shape (B=4, C=128, H=32, KH=4, D=64, T=1024+128, the
// ring holding positions 0..255) one call must read q (2.1 MB), K and V
// at the 384 slots some query sees (1.6 MB; the empty slots are never
// read) and write 2.1 MB: 1.7 us at 3.35 TB/s, 0.038 ms over the 22
// launches of a prefill-chunk forward. Its 164k visible (query, key)
// pairs a head need 1.3 GFLOP, 1.4 us on the bf16 tensor cores. So bytes
// bound it, narrowly.
//
// Design. A block owns 64 folded query rows of one (batch row b, KV head
// kh); folded row r is (c = r / G, g = r % G) and reads head h = kh * G + g
// in place, no transpose is materialised. It is 8 warps: 4 row groups of
// 16 rows (the A operand of mma.sync), each run by two warps that take the
// two halves of every key tile and merge their (acc, m, l) at the end as
// the online softmax merges a tile. The split doubles the warps an SM
// holds (16 at the serving shape, 2 blocks) and halves each warp's chain
// mma -> softmax -> mma a tile: the math, not the copies, sets the loop's
// time.
//   * Visible tiles only. The block reads its batch row's kv_pos once (the
//     first positions in flight with its q positions), and builds in
//     shared memory the ascending list of BK-key tiles that hold a key some
//     of its rows may see, with each tile's least and greatest position.
//     The main loop walks that list, so empty ring slots and causally
//     later keys cost neither copies nor synchronisation (6 of 18 tiles at
//     the serving shape, 5 in the first half of the chunk). A warp skips
//     the mask on a tile whose keys all lie in every one of its rows'
//     windows (the ring tiles at the serving shape). A tile that is wholly
//     masked for one row but not for its block-mates gives that row
//     p = exp(-1e30 - m) = 0, or, before the row's first visible key, exp(0)
//     terms that the later correction exp(-1e30 - m) = 0 wipes, in the
//     loop and in the merge; so a visible row's value does not depend on
//     which of its masked tiles ran, and depends on nothing but its own
//     row, head and batch row. Row 0 of a B=4 call equals the B=1 call bit
//     for bit.
//   * Staging in the input's dtype. q (once), K, V and the key positions
//     of a tile go to shared memory by 16-byte cp.async in their own
//     dtype, double-buffered: the next visible tile's copies are in
//     flight during the current tile's math. Rows are padded by 16 bytes,
//     so the fragment loads of 8 rows hit distinct banks. Keys past T and
//     lanes past D are zero-filled (positions -1); a head dim or a pointer
//     that does not allow 16-byte chunks is copied element by element.
//   * bf16 q and k/v: S = Q K^T by mma.sync.m16n8k16 bf16 -> f32, the Q
//     and K fragments by ldmatrix (K as stored, keys as rows). A bf16
//     product is exact in f32, so only the order of the sum differs from
//     the plain version. The scale, softcap, mask and online softmax run
//     in registers on the accumulator layout; a row's max and sum are
//     taken over its quad with xor shuffles, so every thread of a row
//     holds the same bits. O += P V: P (f32) is split into P_hi + P_lo,
//     both bf16, two mmas into the same f32 accumulator (residual about
//     2^-17 of P), the V fragments by ldmatrix.trans.
//   * f32 q or k/v (any mix): both products by 3xTF32,
//     mma.sync.m16n8k8 tf32 with every operand split into hi + lo and the
//     lo*lo term dropped (error about 2^-21), fragments by scalar shared
//     loads. Each k8 step's three products are summed from zero and added
//     to the running sum in f32 (see add_3xtf32). P V pairs keys
//     (2t, 2t+1) of the accumulator layout with the mma's k (t, t + 4),
//     and reads V in the same order.
//   * Any head dim: instances at padded widths 32, 64, 96, 128 and 256; a
//     head of D lanes runs in the least width >= D, its lanes past D zero
//     on load and never stored.
//   * Epilogue: divide, cast once, through the warp's own q rows in
//     shared memory, stored as 16-byte chunks for rows < C * G only.
// What the old kernel lacked: it ran on the CUDA cores in f32 (6.8
// TFLOP/s), loaded K/V synchronously widened to f32, and paid two or
// three block barriers and a scan for every 32-key tile, masked or not.
// wgmma and TMA remain for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kRowWarps = 4;                // 16 query rows each
constexpr int kKeySplit = 2;                // warps sharing a row group
constexpr int kWarps = kRowWarps * kKeySplit;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kRowWarps;       // folded query rows per block
constexpr int kScan = 8;  // key positions a thread loads with the q ones
constexpr float kNegInf = -1e30f;
// opt-in shared memory of a block (232,448 bytes), less room for the
// kernel's static shared variables
constexpr int kMaxSmem = 232448 - 1024;

// dtype codes shared with the Python wrapper
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// e^x in the online softmax: the bf16 route takes ex2.approx (about 1e-6
// relative for |x| < 20, far below its bf16 output's rounding), the f32
// route expf (within 2 ulp)
template <bool FAST>
__device__ __forceinline__ float softmax_exp(float x) {
  return FAST ? __expf(x) : expf(x);
}

__device__ __forceinline__ bool visible(int kp, int qp, int window) {
  return kp >= 0 && kp <= qp && (window <= 0 || kp > qp - window);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; !valid fills the 16 bytes with 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], unsigned a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  unsigned a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c (16 x 8, f32) += a (16 x 16) b (16 x 8), bf16 operands
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16 x 8, f32) += a (16 x 8) b (8 x 8), tf32 operands
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo to about 2^-22 of x, both tf32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a b to about 2^-21, a = ah + al and b = bh + bl split by
// split_tf32; al bl is dropped. The three products are summed from zero
// and then added to c by an f32 add that rounds to nearest: the tensor
// cores align an mma's addends to the largest and drop the bits below, so
// adding small products straight into a large running sum would lose
// them toward zero at every k step (enough to miss the f32 tolerance of
// 5e-6 at D = 256).
__device__ __forceinline__ void add_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t b0h, uint32_t b0l,
                                           uint32_t b1h, uint32_t b1l) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(p, al, b0h, b1h);
  mma_tf32(p, ah, b0l, b1l);
  mma_tf32(p, ah, b0h, b1h);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += p[e];
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
// (x0, x1) = hi + lo, each a pair of bf16 packed as the mma takes it (the
// lower index in the low half)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const bf16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
  hi = __bfloat16_as_ushort(h0) | (uint32_t)__bfloat16_as_ushort(h1) << 16;
  lo = bf16_bits(x0 - __bfloat162float(h0)) |
       bf16_bits(x1 - __bfloat162float(h1)) << 16;
}

template <int DP, typename QT, typename KT>
struct Cfg {
  static constexpr bool kBf16 =
      std::is_same<QT, bf16>::value && std::is_same<KT, bf16>::value;
  static constexpr int kBK = kBf16 && DP <= 128 ? 64 : 32;  // keys a tile
  static constexpr int kWK = kBK / kKeySplit;               // keys a warp
  static_assert(kWK % (kBf16 ? 16 : 8) == 0, "a warp's keys: whole k steps");
  static constexpr int kLdq = DP + 16 / (int)sizeof(QT);    // padded rows
  static constexpr int kLdk = DP + 16 / (int)sizeof(KT);
  // shared memory: q rows | K x2 | V x2 | key positions x2 | per tile: the
  // list, least and greatest key position
  static constexpr int kQBytes = kRows * kLdq * (int)sizeof(QT);
  static constexpr int kKVBytes = kBK * kLdk * (int)sizeof(KT);
  static constexpr int kFixed = kQBytes + 4 * kKVBytes + 2 * kBK * 4;
  // the key split's partial rows (acc, m, l a thread), handed over in the
  // K/V stages once the loop is done
  static constexpr int kHand = DP / 2 + 4;
  static_assert((kKeySplit - 1) * 32 * kRowWarps * kHand * 4 <= 4 * kKVBytes,
                "the partials fit in the K/V stages");
};

// Copy `rows` rows of D elements into shared rows of LD elements, lanes
// D..DP-1 zero. Row i comes from src(i), or is zero where src(i) is null.
// With vec (D * sizeof(T) a multiple of 16 and every row 16-byte aligned)
// by 16-byte cp.async; otherwise element by element.
template <int DP, int LD, typename T, typename Src>
__device__ __forceinline__ void stage_rows(T* dst, int rows, int D, bool vec,
                                           Src src, const T* any) {
  constexpr int kPer = 16 / (int)sizeof(T);   // elements a chunk
  constexpr int kChunks = DP / kPer;          // chunks a row
  for (int e = threadIdx.x; e < rows * kChunks; e += kThreads) {
    const int i = e / kChunks, d0 = (e % kChunks) * kPer;
    const T* s = src(i);
    T* out = dst + i * LD + d0;
    if (vec) {
      const bool ok = s != nullptr && d0 < D;
      cp_async16(out, ok ? s + d0 : any, ok);
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        out[j] = s != nullptr && d0 + j < D ? s[d0 + j] : from_float<T>(0.f);
    }
  }
}

// One BK-key tile of positions, K and V into stage buffers.
template <int DP, typename QT, typename KT>
__device__ __forceinline__ void stage_tile(KT* ks, KT* vs, int* kps,
                                           const KT* k, const KT* v,
                                           const int* kv_pos, int tile,
                                           int T, int KH, int D, bool vec) {
  using C = Cfg<DP, QT, KT>;
  const int t0 = tile * C::kBK;
  for (int i = threadIdx.x; i < C::kBK; i += kThreads) {
    if (t0 + i < T)
      cp_async4(kps + i, kv_pos + t0 + i);
    else
      kps[i] = -1;
  }
  const size_t row = (size_t)KH * D;
  stage_rows<DP, C::kLdk>(
      ks, C::kBK, D, vec,
      [&](int i) { return t0 + i < T ? k + (t0 + i) * row : nullptr; }, k);
  stage_rows<DP, C::kLdk>(
      vs, C::kBK, D, vec,
      [&](int i) { return t0 + i < T ? v + (t0 + i) * row : nullptr; }, v);
}

// S (16 rows x the warp's kWK keys) = Q K^T for the warp's rows, on the C
// layout of the mma: s[j] holds keys 8j + 2t, 8j + 2t + 1 of rows g and
// g + 8.
template <int DP, typename QT, typename KT>
__device__ __forceinline__ void scores(float (&s)[Cfg<DP, QT, KT>::kWK / 8][4],
                                       const QT* qs, const KT* ks, int lane) {
  using C = Cfg<DP, QT, KT>;
  constexpr int NJ = C::kWK / 8;
#pragma unroll
  for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  if constexpr (C::kBf16) {
    // Q: lane l gives row l % 16, dims 8 * (l / 16) of the k16 step; K:
    // lane l gives key (l % 8) + 8 * (l / 16), dims 8 * ((l / 8) % 2)
    const unsigned qa = smem_addr(qs + (lane % 16) * C::kLdq + 8 * (lane / 16));
    const unsigned ka = smem_addr(ks + ((lane % 8) + 8 * (lane / 16)) * C::kLdk +
                                  8 * ((lane / 8) % 2));
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, qa + kk * 32);
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        uint32_t b[4];
        ldmatrix_x4(b, ka + (jp * 16 * C::kLdk + kk * 16) * 2);
        mma_bf16(s[2 * jp], a, b[0], b[1]);
        mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
      }
    }
  } else {
    const int g = lane / 4, t = lane % 4;
#pragma unroll 2
    for (int kk = 0; kk < DP / 8; ++kk) {
      const int d = 8 * kk + t;
      uint32_t ah[4], al[4];
      split_tf32(to_float(qs[g * C::kLdq + d]), ah[0], al[0]);
      split_tf32(to_float(qs[(g + 8) * C::kLdq + d]), ah[1], al[1]);
      split_tf32(to_float(qs[g * C::kLdq + d + 4]), ah[2], al[2]);
      split_tf32(to_float(qs[(g + 8) * C::kLdq + d + 4]), ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const KT* kr = ks + (8 * j + g) * C::kLdk + d;
        uint32_t b0h, b0l, b1h, b1l;
        split_tf32(to_float(kr[0]), b0h, b0l);
        split_tf32(to_float(kr[4]), b1h, b1l);
        add_3xtf32(s[j], ah, al, b0h, b0l, b1h, b1l);
      }
    }
  }
}

// acc (16 rows x DP) += P V, P in s (the C layout of scores)
template <int DP, typename QT, typename KT>
__device__ __forceinline__ void accumulate(
    float (&acc)[DP / 8][4], const float (&s)[Cfg<DP, QT, KT>::kWK / 8][4],
    const KT* vs, int lane) {
  using C = Cfg<DP, QT, KT>;
  constexpr int NJ = C::kWK / 8;
  if constexpr (C::kBf16) {
    // lane l gives key (l % 8) + 8 * ((l / 8) % 2), dims 8 * (l / 16)
    const unsigned va = smem_addr(vs + ((lane % 8) + 8 * ((lane / 8) % 2)) *
                                           C::kLdk + 8 * (lane / 16));
#pragma unroll
    for (int kk = 0; kk < NJ / 2; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, va + (kk * 16 * C::kLdk + np * 16) * 2);
        mma_bf16(acc[2 * np], pl, b[0], b[1]);
        mma_bf16(acc[2 * np], ph, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], pl, b[2], b[3]);
        mma_bf16(acc[2 * np + 1], ph, b[2], b[3]);
      }
    }
  } else {
    // the mma's k = t, t + 4 are keys 8j + 2t, 8j + 2t + 1
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t ah[4], al[4];
      split_tf32(s[j][0], ah[0], al[0]);
      split_tf32(s[j][2], ah[1], al[1]);
      split_tf32(s[j][1], ah[2], al[2]);
      split_tf32(s[j][3], ah[3], al[3]);
      const KT* v0 = vs + (8 * j + 2 * t) * C::kLdk + g;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        uint32_t b0h, b0l, b1h, b1l;
        split_tf32(to_float(v0[8 * n]), b0h, b0l);
        split_tf32(to_float(v0[C::kLdk + 8 * n]), b1h, b1l);
        add_3xtf32(acc[n], ah, al, b0h, b0l, b1h, b1l);
      }
    }
  }
}

// At most 128 registers a thread (two blocks an SM) up to DP = 64, where
// that costs no spills; wider instances keep their accumulator unspilled.
template <int DP, typename QT, typename KT>
__global__ void __launch_bounds__(kThreads, DP <= 64 ? 2 : 1)
prefill_attn_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                    const KT* __restrict__ v,
                    const int* __restrict__ q_pos,
                    const int* __restrict__ kv_pos, QT* __restrict__ out,
                    int C, int T, int H, int KH, int D, int window,
                    float scale, float softcap, bool vec_q, bool vec_kv) {
  using Cf = Cfg<DP, QT, KT>;
  constexpr int BK = Cf::kBK, WK = Cf::kWK, NJ = WK / 8;
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char smem[];
  QT* qs = reinterpret_cast<QT*>(smem);
  KT* ks[2] = {reinterpret_cast<KT*>(smem + Cf::kQBytes),
               reinterpret_cast<KT*>(smem + Cf::kQBytes + Cf::kKVBytes)};
  KT* vs[2] = {reinterpret_cast<KT*>(smem + Cf::kQBytes + 2 * Cf::kKVBytes),
               reinterpret_cast<KT*>(smem + Cf::kQBytes + 3 * Cf::kKVBytes)};
  int* kps = reinterpret_cast<int*>(smem + Cf::kQBytes + 4 * Cf::kKVBytes);
  const int NT = (T + BK - 1) / BK;
  int* tiles = kps + 2 * BK;
  int* tmin = tiles + NT;
  int* tmax = tmin + NT;
  __shared__ int qmin_s, qmax_s, ntiles_s;

  const int G = H / KH, M = C * G;
  const int b = blockIdx.y / KH, kh = blockIdx.y % KH;
  const int r0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // the warp's 16 rows (rw) and its share of every tile's keys (half)
  const int rw = warp % kRowWarps, half = warp / kRowWarps;
  k += (size_t)b * T * KH * D + (size_t)kh * D;
  v += (size_t)b * T * KH * D + (size_t)kh * D;
  kv_pos += (size_t)b * T;
  // offset of folded row r's q (and out) row
  auto q_row = [&](int r) -> size_t {
    return (((size_t)b * C + r / G) * H + kh * G + r % G) * D;
  };

  // q rows, in flight during the prologue
  stage_rows<DP, Cf::kLdq>(
      qs, kRows, D, vec_q,
      [&](int i) { return r0 + i < M ? q + q_row(r0 + i) : nullptr; }, q);
  cp_async_commit();

  // prologue: the block's q positions and its visible tiles; the first
  // key positions are loaded with the q positions
  const bool own = tid < kRows && r0 + tid < M;
  const int qp_own = own ? q_pos[(size_t)b * C + (r0 + tid) / G] : 0;
  int kv0[kScan];
#pragma unroll
  for (int j = 0; j < kScan; ++j) {
    const int t = j * kThreads + tid;
    kv0[j] = t < T ? kv_pos[t] : -1;
  }
  for (int i = tid; i < NT; i += kThreads) {
    tiles[i] = 0;
    tmin[i] = i == NT - 1 && NT * BK > T ? -1 : INT_MAX;  // ragged: -1
    tmax[i] = INT_MIN;
  }
  if (tid == 0) {
    qmin_s = INT_MAX;
    qmax_s = INT_MIN;
  }
  __syncthreads();
  if (own) {
    atomicMin(&qmin_s, qp_own);
    atomicMax(&qmax_s, qp_own);
  }
  __syncthreads();
  const int qmin = qmin_s, qmax = qmax_s;
  // a warp notes 32 keys of one tile: whether some row of the block may
  // see one (a superset where q positions are not contiguous: an extra
  // tile only costs time), and the least and greatest position
  auto note = [&](int t, int kp) {
    const int tw = t - lane;
    if (tw >= T) return;   // uniform in the warp
    const bool in = t < T;
    const bool vis = in && kp >= 0 && kp <= qmax &&
                     (window <= 0 || kp > qmin - window);
    const bool any = __any_sync(kAll, vis);
    const int lo = __reduce_min_sync(kAll, in ? kp : INT_MAX);
    const int hi = __reduce_max_sync(kAll, in ? kp : INT_MIN);
    if (lane == 0) {
      const int tile = tw / BK;
      if (any) tiles[tile] = 1;
      atomicMin(tmin + tile, lo);
      atomicMax(tmax + tile, hi);
    }
  };
#pragma unroll
  for (int j = 0; j < kScan; ++j) note(j * kThreads + tid, kv0[j]);
  for (int t = kScan * kThreads + tid; t - lane < T; t += kThreads)
    note(t, t < T ? kv_pos[t] : -1);
  __syncthreads();
  if (warp == 0) {   // compact in place, ascending
    int n = 0;
    for (int base = 0; base < NT; base += 32) {
      const int i = base + lane;
      const bool f = i < NT && tiles[i];
      const unsigned bal = __ballot_sync(kAll, f);
      if (f) tiles[n + __popc(bal & ((1u << lane) - 1))] = i;
      n += __popc(bal);
    }
    if (lane == 0) ntiles_s = n;
  }
  __syncthreads();
  const int ntiles = ntiles_s;

  // this thread's rows g and g + 8 of the warp's 16; a row past M sees no
  // key (positions are never below -1)
  const int g = lane / 4, t4 = lane % 4;
  const int ra = r0 + 16 * rw + g, rb = ra + 8;
  const int qpa = ra < M ? q_pos[(size_t)b * C + ra / G] : INT_MIN;
  const int qpb = rb < M ? q_pos[(size_t)b * C + rb / G] : INT_MIN;
  // the least and greatest q position of the warp's rows: a tile whose
  // keys all lie in [wmax - window + 1, wmin] needs no mask
  const int wmin = __reduce_min_sync(
      kAll, min(ra < M ? qpa : INT_MAX, rb < M ? qpb : INT_MAX));
  const int wmax = __reduce_max_sync(kAll, max(qpa, qpb));
  const QT* qw = qs + 16 * rw * Cf::kLdq;

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  if (ntiles > 0) {
    stage_tile<DP, QT, KT>(ks[0], vs[0], kps, k, v, kv_pos, tiles[0], T, KH,
                           D, vec_kv);
    cp_async_commit();
  }
  for (int i = 0; i < ntiles; ++i) {
    const int st = i & 1, ti = tiles[i];
    if (i + 1 < ntiles) {
      stage_tile<DP, QT, KT>(ks[st ^ 1], vs[st ^ 1], kps + (st ^ 1) * BK, k,
                             v, kv_pos, tiles[i + 1], T, KH, D, vec_kv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[NJ][4];
    scores<DP, QT, KT>(s, qw, ks[st] + half * WK * Cf::kLdk, lane);

    // scale, softcap, mask; the online softmax, rows g (0) and g + 8 (1)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        s[j][e] = x;
      }
    }
    const bool unmasked =
        tmin[ti] >= 0 && tmax[ti] <= wmin &&
        (window <= 0 || (long long)tmin[ti] > (long long)wmax - window);
    if (!unmasked) {
      const int* kp = kps + st * BK + half * WK;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!visible(kp[8 * j + 2 * t4 + (e & 1)], e < 2 ? qpa : qpb,
                       window))
            s[j][e] = kNegInf;
        }
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kAll, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kAll, mx[r], 2));
      mx[r] = fmaxf(m[r], mx[r]);
      corr[r] = softmax_exp<Cf::kBf16>(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = softmax_exp<Cf::kBf16>(s[j][e] - m[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(kAll, sum[r], 1);
      sum[r] += __shfl_xor_sync(kAll, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    accumulate<DP, QT, KT>(acc, s, vs[st] + half * WK * Cf::kLdk, lane);
    __syncthreads();   // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();  // the q copies, where no tile ran
  __syncthreads();

  // the key split: each warp of a row group ran its share of every tile;
  // the others hand (acc, m, l) to the first through the K/V stages, which
  // merges them as the online softmax merges a tile
  float* hand = reinterpret_cast<float*>(smem + Cf::kQBytes);
  const int slot = rw * 32 + lane;
  constexpr int kStride = kRowWarps * 32;
  if (half > 0) {
    float* h = hand + (size_t)(half - 1) * Cf::kHand * kStride + slot;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) h[(4 * n + e) * kStride] = acc[n][e];
    }
    h[(DP / 2) * kStride] = m[0];
    h[(DP / 2 + 1) * kStride] = m[1];
    h[(DP / 2 + 2) * kStride] = l[0];
    h[(DP / 2 + 3) * kStride] = l[1];
  }
  __syncthreads();
  if (half > 0) return;
  for (int o = 1; o < kKeySplit; ++o) {
    const float* h = hand + (size_t)(o - 1) * Cf::kHand * kStride + slot;
    float c0[2], c1[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mo = h[(DP / 2 + r) * kStride];
      const float mm = fmaxf(m[r], mo);
      c0[r] = expf(m[r] - mm);
      c1[r] = expf(mo - mm);
      l[r] = l[r] * c0[r] + h[(DP / 2 + 2 + r) * kStride] * c1[r];
      m[r] = mm;
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = acc[n][e] * c0[e >> 1] +
                    h[(4 * n + e) * kStride] * c1[e >> 1];
    }
  }

  // epilogue: out = acc / max(l, 1e-30) in q's dtype, through the warp's
  // own q rows
  QT* ow = qs + 16 * rw * Cf::kLdq;
  const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ow[(g + 8 * (e >> 1)) * Cf::kLdq + 8 * n + 2 * t4 + (e & 1)] =
          from_float<QT>(acc[n][e] / den[e >> 1]);
    }
  }
  __syncwarp();
  constexpr int kPer = 16 / (int)sizeof(QT);
  const int chunks = (D + kPer - 1) / kPer;
  for (int e = lane; e < 16 * chunks; e += 32) {
    const int i = e / chunks, d0 = (e % chunks) * kPer;
    const int r = r0 + 16 * rw + i;
    if (r >= M) continue;
    QT* dst = out + q_row(r) + d0;
    const QT* src = ow + i * Cf::kLdq + d0;
    if (vec_q) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int j = 0; j < kPer && d0 + j < D; ++j) dst[j] = src[j];
    }
  }
}

template <int DP, typename QT, typename KT>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const int* q_pos, const int* kv_pos, void* out,
                         int B, int C, int T, int H, int KH, int D,
                         int window, float scale, float softcap,
                         cudaStream_t stream) {
  using Cf = Cfg<DP, QT, KT>;
  const int nt = (T + Cf::kBK - 1) / Cf::kBK;
  const long smem = Cf::kFixed + 12L * nt;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static long allowed = 48 * 1024;  // per instance: raised as T grows
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        prefill_attn_kernel<DP, QT, KT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec_q = D * sizeof(QT) % 16 == 0 && aligned(q) && aligned(out);
  const bool vec_kv = D * sizeof(KT) % 16 == 0 && aligned(k) && aligned(v);
  dim3 grid((C * (H / KH) + kRows - 1) / kRows, B * KH);
  prefill_attn_kernel<DP, QT, KT><<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), q_pos, kv_pos, static_cast<QT*>(out), C, T,
      H, KH, D, window, scale, softcap, vec_q, vec_kv);
  return cudaGetLastError();
}

template <int DP, typename QT>
cudaError_t launch_kv(int kv_dtype, const void* q, const void* k,
                      const void* v, const int* q_pos, const int* kv_pos,
                      void* out, int B, int C, int T, int H, int KH, int D,
                      int window, float scale, float softcap,
                      cudaStream_t s) {
  if (kv_dtype == kF32)
    return launch_typed<DP, QT, float>(q, k, v, q_pos, kv_pos, out, B, C, T,
                                       H, KH, D, window, scale, softcap, s);
  if (kv_dtype == kBF16)
    return launch_typed<DP, QT, bf16>(q, k, v, q_pos, kv_pos, out, B, C, T,
                                      H, KH, D, window, scale, softcap, s);
  return cudaErrorInvalidValue;
}

template <int DP>
cudaError_t launch_d(int q_dtype, int kv_dtype, const void* q, const void* k,
                     const void* v, const int* q_pos, const int* kv_pos,
                     void* out, int B, int C, int T, int H, int KH, int D,
                     int window, float scale, float softcap,
                     cudaStream_t s) {
  if (q_dtype == kF32)
    return launch_kv<DP, float>(kv_dtype, q, k, v, q_pos, kv_pos, out, B, C,
                                T, H, KH, D, window, scale, softcap, s);
  if (q_dtype == kBF16)
    return launch_kv<DP, bf16>(kv_dtype, q, k, v, q_pos, kv_pos, out, B, C,
                               T, H, KH, D, window, scale, softcap, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, bound with ctypes. q (B, C, H, D) and out in q_dtype,
// k and v (B, T, KH, D) in kv_dtype, q_pos (B, C) and kv_pos (B, T) int32,
// all contiguous device tensors; any 1 <= D <= 256. window <= 0 means no
// window, softcap <= 0 no softcap. The stream is the caller's current CUDA
// stream. The return value is the cudaError_t of the launch (0 on
// success).
extern "C" int prefill_attn(const void* q, const void* k, const void* v,
                            const void* q_pos, const void* kv_pos, void* out,
                            int q_dtype, int kv_dtype, int B, int C, int T,
                            int H, int KH, int D, int window, float scale,
                            float softcap, void* stream) {
  if (B < 1 || C < 1 || T < 1 || KH < 1 || H % KH || B * KH > 65535 ||
      D < 1 || D > 256)
    return (int)cudaErrorInvalidValue;
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PREFILL_ATTN_WIDTH(DP)                                               \
  if (D <= DP)                                                               \
    return (int)launch_d<DP>(q_dtype, kv_dtype, q, k, v, qp, kp, out, B, C,  \
                             T, H, KH, D, window, scale, softcap, s);
  PREFILL_ATTN_WIDTH(32)
  PREFILL_ATTN_WIDTH(64)
  PREFILL_ATTN_WIDTH(96)
  PREFILL_ATTN_WIDTH(128)
  PREFILL_ATTN_WIDTH(256)
#undef PREFILL_ATTN_WIDTH
  return (int)cudaErrorInvalidValue;
}
