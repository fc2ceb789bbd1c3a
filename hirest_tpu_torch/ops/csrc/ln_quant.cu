// K2: LayerNorm in f32 followed by per-row symmetric int8 quantization, and
// K10: the same LayerNorm written back in bf16.
//
// K2 replaces hirest_tpu/ops/quant.py::ln_quant (kernel body
// _ln_quant_kernel), K10 hirest_tpu/ops/quant.py::ln_bf16 (kernel body
// _ln_kernel_flat). For each row x of [M, C] (bf16 in), with g, b the f32
// LayerNorm params:
//   mu  = mean(x),  xc = x - mu,  var = mean(xc * xc)          (two passes)
//   y   = (xc * rsqrt(var + eps)) * g + b                       (f32)
// K2: s = max(max|y| / 127, 1e-8), q = clamp(round_half_even(y / s), +-127)
//     (IEEE division; y is never rounded to bf16).
// K10: out = bf16(y), which is eva_scan._ln's arithmetic.
//
// Bound on an H100 SXM (EVA-g, M = 128 * 257 = 32896, C = 1408): K2 reads
// x (92.6 MB) and writes q (46.3 MB) and s: 139 MB, 0.0415 ms at 3.35 TB/s;
// K10 reads x and writes 92.6 MB of bf16: 185.3 MB, 0.0553 ms. Their few f32
// operations per element are far below the f32 rate. Both are bound by
// memory.
//
// Design: one warp per row. The row stays in registers (C / 32 values a
// lane) between the passes, so x is read from device memory once and the
// output written once: the traffic is the bound's. Loads and stores are 8
// bytes a lane (4 values), neighbouring lanes on neighbouring addresses.
// Products and sums that the reference rounds one by one use __fmul_rn /
// __fadd_rn, so nvcc cannot contract them into FMAs; the row reductions run
// in another order than the plain version's, and rsqrtf is not correctly
// rounded, so a code may differ by one from it, and a K10 output by one
// bf16 ulp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rowquant.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxVecs = 16;  // 4-value vectors a lane holds: C <= 2048

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// kQuant: codes to q and scales to s (K2); else bf16 to y (K10).
template <bool kQuant>
__global__ void __launch_bounds__(kThreads)
    ln_kernel(const __nv_bfloat16* __restrict__ x,
              const float* __restrict__ g, const float* __restrict__ b,
              int8_t* __restrict__ q, float* __restrict__ s,
              __nv_bfloat16* __restrict__ y, int M, int C, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= M) return;
  const int nvec = C / 4;
  const __nv_bfloat16* xr = x + (size_t)row * C;

  float v[kMaxVecs][4];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int vi = i * 32 + lane;
#pragma unroll
    for (int k = 0; k < 4; ++k) v[i][k] = 0.f;
    if (vi < nvec) {
      const uint2 raw = *reinterpret_cast<const uint2*>(xr + vi * 4);
      const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
      const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
      v[i][0] = __low2float(lo);
      v[i][1] = __high2float(lo);
      v[i][2] = __low2float(hi);
      v[i][3] = __high2float(hi);
#pragma unroll
      for (int k = 0; k < 4; ++k) sum = __fadd_rn(sum, v[i][k]);
    }
  }
  const float mu = __fdiv_rn(warp_sum(sum), (float)C);

  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    if (i * 32 + lane < nvec) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[i][k] = __fsub_rn(v[i][k], mu);
        ss = __fadd_rn(ss, __fmul_rn(v[i][k], v[i][k]));
      }
    }
  }
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(ss), (float)C), eps));

  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int vi = i * 32 + lane;
    if (vi < nvec) {
      const float4 gv = *reinterpret_cast<const float4*>(g + vi * 4);
      const float4 bv = *reinterpret_cast<const float4*>(b + vi * 4);
      const float gg[4] = {gv.x, gv.y, gv.z, gv.w};
      const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[i][k] = __fadd_rn(__fmul_rn(__fmul_rn(v[i][k], r), gg[k]), bb[k]);
        amax = fmaxf(amax, fabsf(v[i][k]));
      }
    }
  }

  if constexpr (kQuant) {
    const float sc = row_scale(warp_max(amax));
    uint32_t* qr = reinterpret_cast<uint32_t*>(q + (size_t)row * C);
#pragma unroll
    for (int i = 0; i < kMaxVecs; ++i) {
      const int vi = i * 32 + lane;
      if (vi < nvec) qr[vi] = code4(v[i], sc);
    }
    if (lane == 0) s[row] = sc;
  } else {
    uint2* yr = reinterpret_cast<uint2*>(y + (size_t)row * C);
#pragma unroll
    for (int i = 0; i < kMaxVecs; ++i) {
      const int vi = i * 32 + lane;
      if (vi < nvec) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v[i][0], v[i][1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v[i][2], v[i][3]);
        yr[vi] = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                            *reinterpret_cast<const uint32_t*>(&hi));
      }
    }
  }
}

bool bad_shape(int M, int C) {
  return M <= 0 || C <= 0 || C % 4 || C > kMaxVecs * 128;
}

}  // namespace

// x [M, C] bf16, g/b [C] f32, q [M, C] int8, s [M] f32, all contiguous;
// C % 4 == 0 and C <= 2048. Launches on `stream`; returns cudaGetLastError().
extern "C" int hirest_ln_quant(const void* x, const void* g, const void* b,
                               void* q, void* s, int M, int C, float eps,
                               void* stream) {
  if (bad_shape(M, C)) return (int)cudaErrorInvalidValue;
  const int blocks = (M + kWarps - 1) / kWarps;
  ln_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(g),
      static_cast<const float*>(b), static_cast<int8_t*>(q),
      static_cast<float*>(s), nullptr, M, C, eps);
  return (int)cudaGetLastError();
}

// As above with the LayerNorm written to y [M, C] bf16 (K10).
extern "C" int hirest_ln_bf16(const void* x, const void* g, const void* b,
                              void* y, int M, int C, float eps, void* stream) {
  if (bad_shape(M, C)) return (int)cudaErrorInvalidValue;
  const int blocks = (M + kWarps - 1) / kWarps;
  ln_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(g),
      static_cast<const float*>(b), nullptr, nullptr,
      static_cast<__nv_bfloat16*>(y), M, C, eps);
  return (int)cudaGetLastError();
}

extern "C" const char* hirest_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
