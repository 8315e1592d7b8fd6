// Fused prefill attention for Hopper (sm_90a): flash-style causal attention
// with an online softmax, masked by position, GQA folded into rows.
//
// Replaces: src/repro/kernels/prefill_attn.py, prefill_attn_fused (its
// _kernel body and the pallas_call that launches it).
//
// What it computes, as the TPU kernel does: for query row (b, c, h) and
// key t of batch row b and KV head kh = h / G,
//   s = (q . k) * scale                 (f32 dot of f32-cast inputs)
//   s = tanh(s / softcap) * softcap     (only with a softcap)
//   visible: kv_pos >= 0, kv_pos <= q_pos, kv_pos > q_pos - window
//   s = NEG_INF (-1e30, not -inf) where not visible
// with the running max m, denominator l and accumulator acc in f32, one
// divide by max(l, 1e-30) at the end and one cast to q's dtype. A key tile
// wholly masked before a row's first visible key adds exp(0) = 1 terms
// that the correction exp(-1e30 - m) = 0 wipes later; a row with no
// visible key at all is garbage, as on the reference's path.
//
// Bound on this card: chip_smoke.py computes it from the data of its run.
// At the serving shape (B=4, C=128, H=32, KH=4, D=64, T=1024+128) with the
// ring holding positions 0..255, one call must read q (2.1 MB), K and V at
// the 384 slots some query sees (1.6 MB; the empty slots are never read)
// and write 2.1 MB, about 1.7 us at 3.35 TB/s; its 164k visible
// (query, key) pairs need 1.3 GFLOP, about 1.4 us on the bf16 tensor
// cores. So bytes bound it. This kernel uses CUDA cores only, in f32.
//
// Design (simple and correct first): one block of 128 threads per
// (b * KH + kh, tile of folded query rows). Folded row r of a KV head is
// (c = r / G, g = r % G) and reads head h = kh * G + g in place: no
// transpose is materialised. D / 32 neighbouring threads share a row, each
// holding 32 of its dims (dim u + (D/32) * i for thread u of the row) of q
// and of the accumulator in registers; a score is their partial dots added
// with xor shuffles, which every thread of the row gets bit-identical. The
// block walks the keys in ascending tiles of 32. It loads a tile's
// positions first; when no key of the tile is visible to any row of the
// block (an empty ring slot, a causally later key, a key behind the
// window) it skips the tile, which leaves every visible row bit-identical.
// Otherwise it stages K and V of the tile in shared memory as f32, every
// thread reads them by broadcast, and the online softmax runs over the
// tile. A row's value depends on nothing but its own row, head and batch
// row, so row 0 of a B=4 call equals the B=1 call bit for bit. Tensor
// cores (wgmma), TMA and overlapped loads are for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBK = 32;          // keys per shared-memory tile
constexpr float kNegInf = -1e30f;

// dtype codes shared with the Python wrapper
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_from_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_float(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ bool visible(int kp, int qp, int window) {
  return kp >= 0 && kp <= qp && (window <= 0 || kp > qp - window);
}

template <int D, typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
prefill_attn_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                    const KT* __restrict__ v,
                    const int* __restrict__ q_pos,
                    const int* __restrict__ kv_pos, QT* __restrict__ out,
                    int C, int T, int H, int KH, int window, float scale,
                    float softcap) {
  constexpr int TPR = D / 32;              // threads per query row
  constexpr int RB = kThreads / TPR;       // query rows per block
  __shared__ float ks[kBK][D];
  __shared__ float vs[kBK][D];
  __shared__ int kps[kBK];

  const int G = H / KH;
  const int b = blockIdx.y / KH, kh = blockIdx.y % KH;
  const int tid = threadIdx.x;
  const int u = tid % TPR;
  const int r = blockIdx.x * RB + tid / TPR;
  const bool row_ok = r < C * G;
  const int c = row_ok ? r / G : 0;
  const int h = kh * G + (row_ok ? r % G : 0);
  // a row past the end sees no key (positions are never negative)
  const int qp = row_ok ? q_pos[(size_t)b * C + c] : -1;
  const size_t qoff = (((size_t)b * C + c) * H + h) * D;

  float qr[32], acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    qr[i] = row_ok ? to_float(q[qoff + u + TPR * i]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  for (int t0 = 0; t0 < T; t0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    if (tid < kBK) {
      kps[tid] = t0 + tid < T ? kv_pos[(size_t)b * T + t0 + tid] : -1;
    }
    __syncthreads();
    bool any = false;
#pragma unroll 8
    for (int j = 0; j < kBK; ++j) any |= visible(kps[j], qp, window);
    if (!__syncthreads_or(any)) continue;  // uniform across the block

    for (int e = tid; e < kBK * D; e += kThreads) {
      const int j = e / D, dd = e % D;
      float kv = 0.f, vv = 0.f;
      if (t0 + j < T) {
        const size_t off = (((size_t)b * T + t0 + j) * KH + kh) * D + dd;
        kv = to_float(k[off]);
        vv = to_float(v[off]);
      }
      ks[j][dd] = kv;
      vs[j][dd] = vv;
    }
    __syncthreads();

    float s[kBK];
    float smax = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) dot = fmaf(qr[i], ks[j][u + TPR * i], dot);
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      float sj = dot * scale;
      if (softcap > 0.f) sj = tanhf(sj / softcap) * softcap;
      if (!visible(kps[j], qp, window)) sj = kNegInf;
      s[j] = sj;
      smax = fmaxf(smax, sj);
    }
    const float m_new = fmaxf(m, smax);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * corr + psum;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        acc[i] = fmaf(s[j], vs[j][u + TPR * i], acc[i]);
    }
    m = m_new;
  }

  if (row_ok) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      store_from_float(out + qoff + u + TPR * i, acc[i] / denom);
  }
}

template <int D, typename QT, typename KT>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const int* q_pos, const int* kv_pos, void* out,
                         int B, int C, int T, int H, int KH, int window,
                         float scale, float softcap, cudaStream_t stream) {
  constexpr int RB = kThreads / (D / 32);
  dim3 grid((C * (H / KH) + RB - 1) / RB, B * KH);
  prefill_attn_kernel<D, QT, KT><<<grid, kThreads, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), q_pos, kv_pos, static_cast<QT*>(out), C, T,
      H, KH, window, scale, softcap);
  return cudaGetLastError();
}

template <int D, typename QT>
cudaError_t launch_kv(int kv_dtype, const void* q, const void* k,
                      const void* v, const int* q_pos, const int* kv_pos,
                      void* out, int B, int C, int T, int H, int KH,
                      int window, float scale, float softcap,
                      cudaStream_t s) {
  if (kv_dtype == kF32)
    return launch_typed<D, QT, float>(q, k, v, q_pos, kv_pos, out, B, C, T,
                                      H, KH, window, scale, softcap, s);
  if (kv_dtype == kBF16)
    return launch_typed<D, QT, __nv_bfloat16>(q, k, v, q_pos, kv_pos, out, B,
                                              C, T, H, KH, window, scale,
                                              softcap, s);
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_d(int q_dtype, int kv_dtype, const void* q, const void* k,
                     const void* v, const int* q_pos, const int* kv_pos,
                     void* out, int B, int C, int T, int H, int KH,
                     int window, float scale, float softcap,
                     cudaStream_t s) {
  if (q_dtype == kF32)
    return launch_kv<D, float>(kv_dtype, q, k, v, q_pos, kv_pos, out, B, C,
                               T, H, KH, window, scale, softcap, s);
  if (q_dtype == kBF16)
    return launch_kv<D, __nv_bfloat16>(kv_dtype, q, k, v, q_pos, kv_pos, out,
                                       B, C, T, H, KH, window, scale,
                                       softcap, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, bound with ctypes. q (B, C, H, D) and out in q_dtype,
// k and v (B, T, KH, D) in kv_dtype, q_pos (B, C) and kv_pos (B, T) int32,
// all contiguous device tensors. window <= 0 means no window, softcap <= 0
// no softcap. The stream is the caller's current CUDA stream. The return
// value is the cudaError_t of the launch (0 on success).
extern "C" int prefill_attn(const void* q, const void* k, const void* v,
                            const void* q_pos, const void* kv_pos, void* out,
                            int q_dtype, int kv_dtype, int B, int C, int T,
                            int H, int KH, int D, int window, float scale,
                            float softcap, void* stream) {
  if (B < 1 || C < 1 || T < 1 || KH < 1 || H % KH || B * KH > 65535)
    return (int)cudaErrorInvalidValue;
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return (int)launch_d<64>(q_dtype, kv_dtype, q, k, v, qp, kp, out, B, C, T,
                             H, KH, window, scale, softcap, s);
  if (D == 128)
    return (int)launch_d<128>(q_dtype, kv_dtype, q, k, v, qp, kp, out, B, C,
                              T, H, KH, window, scale, softcap, s);
  return (int)cudaErrorInvalidValue;
}
