// Q8_K activation quantization for Hopper (sm_90a): x (M, K) f32 or bf16,
// K % 256 == 0 -> qs int8 (M, K), d f32 (M, K/256), bsums int16 (M, K/16).
//
// Replaces: src/repro/kernels/q8k_quant.py, q8k_quantize_pallas (its
// _kernel body and the pallas_call that launches it).
//
// What it computes, as the TPU kernel does, for each row and each
// 256-value super-block:
//   amax = max |x|
//   d    = amax / 127                  (IEEE division, __fdiv_rn)
//   inv  = d > 0 ? 1 / d : 0           (IEEE division)
//   q    = clamp(rint(x * inv), -127, 127)   (__fmul_rn; rint rounds half
//                                             to even, as torch.round and
//                                             jnp.round do)
//   bsums[b] = sum of the 16 q of 16-value block b, as int16
// A row whose optional mask byte is 0 writes exactly 0 to qs, d and bsums
// (a select, not a multiply by the mask). Every step is correctly rounded
// and nothing is contracted into an FMA, so the payloads equal the plain
// version's (core/quantize.py::quantize_q8_k) byte for byte. Never build
// this file with --use_fast_math.
//
// Bound on this card: bytes. Per value it reads 4 bytes of f32 (2 of bf16)
// and writes 1 byte of qs, 4/256 of d and 2/16 of bsums: 5.140625 bytes a
// value in f32, about 35 us at (4096, 5632) at 3.35 TB/s. It does a few
// flops a value, far below any compute ceiling.
//
// Design (simple): one warp per (row, super-block), 8 warps a block. Lane
// l holds values 4l..4l+3 and 128+4l..128+4l+3 of the super-block, so each
// of its two loads (16 bytes of f32, 8 of bf16) is one fully coalesced
// warp-wide access, as is each of its two 4-byte stores of qs. The max
// runs over the warp with xor shuffles; a 16-value block spans 4 lanes,
// so two more xor shuffles form its sum, and the first lane of the four
// stores it. Nothing carries over between super-blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;       // warps (super-blocks) per block
constexpr unsigned kAll = 0xffffffffu;

// dtype codes shared with the Python wrapper
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// quantize 4 values with inv; returns them packed as 4 int8 and adds
// their sum to *sum
__device__ __forceinline__ uint32_t quant4(const float (&v)[4], float inv,
                                           int* sum) {
  uint32_t packed = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float q = rintf(__fmul_rn(v[i], inv));
    q = fminf(fmaxf(q, -127.f), 127.f);
    const int qi = (int)q;
    *sum += qi;
    packed |= (uint32_t)(uint8_t)(int8_t)qi << (8 * i);
  }
  return packed;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
q8k_quant_kernel(const T* __restrict__ x, const uint8_t* __restrict__ valid,
                 int8_t* __restrict__ qs, float* __restrict__ d,
                 int16_t* __restrict__ bsums, int M, int K) {
  const int nsb = K / 256;
  const long long task = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (task >= (long long)M * nsb) return;   // whole warps leave together
  const int lane = threadIdx.x % 32;
  const int row = (int)(task / nsb);
  const int sb = (int)(task % nsb);
  const size_t base = (size_t)row * K + (size_t)sb * 256;
  const int lo = 4 * lane, hi = 128 + 4 * lane;

  uint32_t q_lo = 0, q_hi = 0;
  int s_lo = 0, s_hi = 0;
  float dd = 0.f;
  if (valid == nullptr || valid[row] != 0) {
    float a[4], b[4];
    load4(x + base + lo, a);
    load4(x + base + hi, b);
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      amax = fmaxf(amax, fmaxf(fabsf(a[i]), fabsf(b[i])));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(kAll, amax, o));
    dd = __fdiv_rn(amax, 127.f);
    const float inv = dd > 0.f ? __fdiv_rn(1.f, dd) : 0.f;
    q_lo = quant4(a, inv, &s_lo);
    q_hi = quant4(b, inv, &s_hi);
    // a 16-value block is 4 neighbouring lanes of each half
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      s_lo += __shfl_xor_sync(kAll, s_lo, o);
      s_hi += __shfl_xor_sync(kAll, s_hi, o);
    }
  }
  *reinterpret_cast<uint32_t*>(qs + base + lo) = q_lo;
  *reinterpret_cast<uint32_t*>(qs + base + hi) = q_hi;
  if (lane % 4 == 0) {
    int16_t* bs = bsums + (size_t)row * (K / 16) + (size_t)sb * 16;
    bs[lane / 4] = (int16_t)s_lo;
    bs[8 + lane / 4] = (int16_t)s_hi;
  }
  if (lane == 0) d[(size_t)row * nsb + sb] = dd;
}

}  // namespace

// Plain C interface, bound with ctypes. Pointers are device pointers of
// contiguous tensors (x 16-byte aligned; valid may be null, else one byte
// a row); the stream is the caller's current CUDA stream. The return
// value is the cudaError_t of the launch (0 on success).
extern "C" int q8k_quantize(const void* x, const void* valid, void* qs,
                            void* d, void* bsums, int x_dtype, int M, int K,
                            void* stream) {
  if (M < 1 || K < 256 || K % 256) return (int)cudaErrorInvalidValue;
  const long long tasks = (long long)M * (K / 256);
  const long long blocks = (tasks + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  if (x_dtype == kF32) {
    q8k_quant_kernel<float><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const float*>(x), v, static_cast<int8_t*>(qs),
        static_cast<float*>(d), static_cast<int16_t*>(bsums), M, K);
  } else if (x_dtype == kBF16) {
    q8k_quant_kernel<__nv_bfloat16><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), v, static_cast<int8_t*>(qs),
        static_cast<float*>(d), static_cast<int16_t*>(bsums), M, K);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
