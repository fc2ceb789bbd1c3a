// K2: LayerNorm in f32 followed by per-row symmetric int8 quantization, and
// K10: the same LayerNorm written back in bf16.
//
// K2 replaces hirest_tpu/ops/quant.py:145 ln_quant (kernel body
// _ln_quant_kernel), K10 hirest_tpu/ops/quant.py:220 ln_bf16 (kernel body
// _ln_kernel_flat). For each row x of [M, C] (bf16 in), with g, b the f32
// LayerNorm params:
//   mu  = mean(x),  xc = x - mu,  var = mean(xc * xc)          (two passes)
//   y   = (xc * rsqrt(var + eps)) * g + b                       (f32)
// K2: s = max(max|y| / 127, 1e-8), q = clamp(round_half_even(y / s), +-127)
//     (correctly rounded division; y is never rounded to bf16).
// K10: out = bf16(y), which is eva_scan._ln's arithmetic.
// Both have f32 forms for f32 x (ln_f32_kernel), K10's writing y in f32.
//
// Bound on an H100 SXM (EVA-g, M = 128 * 257 = 32896, C = 1408): K2 reads
// x (92.6 MB) and writes q (46.3 MB) and s: 139 MB, 0.0415 ms at 3.35 TB/s;
// K10 reads x and writes 92.6 MB of bf16: 185.3 MB, 0.0553 ms. Their
// arithmetic is well below that: the widening, the LayerNorm (the sum, the
// centring, the square and its sum, x r g + b: 7) and K2's quantization
// (|y|'s max, the quotient, the rounding, the pack: 5.75) or K10's bf16
// pack (0.5) make 13.75 and 8.5 f32 issue slots a value, 0.019 and 0.012
// ms on 132 SMs x 128 lanes x 1.98 GHz: both are bound by bytes. On f32
// rows K2 moves 231.7 MB (0.0692 ms) and K10 370.6 MB (0.1106 ms). The first
// version (one warp a row, the row in registers, eight rows a block)
// issued a row's loads and then stopped loading while its warps reduced
// and divided.
//
// Design: a persistent grid of 256-thread blocks, eight warps each, two
// blocks an SM, fed by the bulk-copy row ring of rowring.cuh: each warp
// takes its rows one at a time, reads the row out of its slot into
// registers (lane l the 4-value vectors l, l + 32, ...; 8-byte reads,
// consecutive across the warp) and at once hands the slot back for the row
// after next, so the next rows land while it reduces. g and b are staged
// in shared memory once a block, while the first rows land. The sums run
// in the first version's order (each lane its values in turn, then the
// warp's butterfly), the mean and the centred sum of squares in two
// passes, never E[x^2] - E[x]^2; products and sums that the reference
// rounds one by one use __fmul_rn / __fadd_rn, so nvcc cannot contract
// them into FMAs. K2's division is code4_recip (rowquant.cuh: __fdiv_rn's
// fast path with the row's reciprocal hoisted). EVA-g's width, C = 1408,
// has an instantiation of its own, whose loop bounds and tests fold away
// (on the card K2 14 % and K10 5 % faster than the general one). The plain
// version reduces in another order, so a code may differ
// by one from it and a K10 output by one bf16 ulp; both differ on the same
// elements as the first version's. The reciprocal square root is rsqrtf,
// which the plain version matches on more codes than the correctly rounded
// __frsqrt_rn (PERF.md §6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rowquant.cuh"
#include "rowring.cuh"

namespace {

constexpr int kG = 32;  // a warp a row
constexpr int kGroups = kRowThreads / kG;
constexpr int kMaxWidth = 2048;
constexpr int kEvaWidth = 1408;
constexpr int kMaxVecs = kMaxWidth / 4 / kG;  // 4-value vectors a lane, 16

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// kQuant: codes to q and scales to s (K2); else bf16 to y (K10). Lane l
// takes the row's 4-value vectors l, l + 32, ...: its 8-byte reads of the
// slot, its reads of g and b and its stores are consecutive across the
// warp, and its sums run in the first version's order. kWidth: the row
// width built in (its loops' bounds and tests fold away), or 0 for width.
template <bool kQuant, int kWidth>
__global__ void __launch_bounds__(kRowThreads, 2)
    ln_kernel(const __nv_bfloat16* __restrict__ x,
              const float* __restrict__ g, const float* __restrict__ b,
              int8_t* __restrict__ q, float* __restrict__ s,
              __nv_bfloat16* __restrict__ y, int M, int width, float eps) {
  const int C = kWidth ? kWidth : width;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x % 32;
  const auto ring = RowRing<kG>::make<kGroups>(smem, x, M, C, C);
  __syncthreads();
  // the first rows land while the block stages g and b
  for (int i = 0; i < kRowStages; ++i) ring.issue(i, lane);
  float* gs = reinterpret_cast<float*>(smem + ring_bytes<kGroups>(C));
  float* bs = gs + C;
  for (int e = threadIdx.x; e < C; e += kRowThreads) {
    gs[e] = g[e];
    bs[e] = b[e];
  }
  __syncthreads();
  const float4* g4 = reinterpret_cast<const float4*>(gs);
  const float4* b4 = reinterpret_cast<const float4*>(bs);

  const int nv = C / 4;
  const int n = ring.rows();
  for (int i = 0; i < n; ++i) {
    const uint2* xs = reinterpret_cast<const uint2*>(ring.wait(i));
    float v[kMaxVecs][4];
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxVecs; ++k) {
      if (lane + k * kG < nv) {
        const uint2 w = xs[lane + k * kG];
        v[k][0] = __uint_as_float(w.x << 16);
        v[k][1] = __uint_as_float(w.x & 0xffff0000u);
        v[k][2] = __uint_as_float(w.y << 16);
        v[k][3] = __uint_as_float(w.y & 0xffff0000u);
#pragma unroll
        for (int e = 0; e < 4; ++e) sum = __fadd_rn(sum, v[k][e]);
      }
    }
    __syncwarp();  // every lane has its row out of the slot: refill it
    ring.issue(i + kRowStages, lane);
    const float mu = __fdiv_rn(warp_sum(sum), (float)C);

    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxVecs; ++k) {
      if (lane + k * kG < nv) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[k][e] = __fsub_rn(v[k][e], mu);
          ss = __fadd_rn(ss, __fmul_rn(v[k][e], v[k][e]));
        }
      }
    }
    const float r =
        rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(ss), (float)C), eps));

    float amax = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxVecs; ++k) {
      const int vi = lane + k * kG;
      if (vi < nv) {
        const float4 gv = g4[vi], bv = b4[vi];
        const float gg[4] = {gv.x, gv.y, gv.z, gv.w};
        const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[k][e] = __fadd_rn(__fmul_rn(__fmul_rn(v[k][e], r), gg[e]), bb[e]);
          amax = fmaxf(amax, fabsf(v[k][e]));
        }
      }
    }

    const long long row = ring.row(i);
    if constexpr (kQuant) {
      const float sc = row_scale(warp_max(amax)), rc = row_recip(sc);
      uint32_t* qr = reinterpret_cast<uint32_t*>(q + row * C);
#pragma unroll
      for (int k = 0; k < kMaxVecs; ++k) {
        const int vi = lane + k * kG;
        if (vi < nv) qr[vi] = code4_recip(v[k], sc, rc);
      }
      if (lane == 0) s[row] = sc;
    } else {
      uint2* yr = reinterpret_cast<uint2*>(y + row * C);
#pragma unroll
      for (int k = 0; k < kMaxVecs; ++k) {
        const int vi = lane + k * kG;
        if (vi < nv)
          yr[vi] = make_uint2(pack_bf16x2(v[k][0], v[k][1]),
                              pack_bf16x2(v[k][2], v[k][3]));
      }
    }
  }
}

// K2 (kQuant) and K10 on f32 rows (the f32 paths hand ln_quant and ln_bf16
// f32, as the JAX kernels compute in the dtype they are given): the same
// arithmetic in the same order as ln_kernel, one warp a row, eight rows a
// block, the row read straight from global memory by 16-byte loads. A first
// version: right, not fast. C % 4 == 0, C <= 2048, x 16-byte aligned. K2
// writes codes to q and scales to s; K10 the LayerNorm to y [M, C] f32, x's
// dtype, by 16-byte stores.
template <bool kQuant>
__global__ void __launch_bounds__(kRowThreads)
    ln_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                  const float* __restrict__ b, int8_t* __restrict__ q,
                  float* __restrict__ s, float* __restrict__ y, int M, int C,
                  float eps) {
  const int lane = threadIdx.x % 32;
  const long long row =
      (long long)blockIdx.x * kGroups + threadIdx.x / 32;
  if (row >= M) return;
  const float4* xr = reinterpret_cast<const float4*>(x + row * C);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  const int nv = C / 4;
  float v[kMaxVecs][4];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxVecs; ++k) {
    if (lane + k * kG < nv) {
      const float4 w = xr[lane + k * kG];
      v[k][0] = w.x;
      v[k][1] = w.y;
      v[k][2] = w.z;
      v[k][3] = w.w;
#pragma unroll
      for (int e = 0; e < 4; ++e) sum = __fadd_rn(sum, v[k][e]);
    }
  }
  const float mu = __fdiv_rn(warp_sum(sum), (float)C);
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxVecs; ++k) {
    if (lane + k * kG < nv) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[k][e] = __fsub_rn(v[k][e], mu);
        ss = __fadd_rn(ss, __fmul_rn(v[k][e], v[k][e]));
      }
    }
  }
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(ss), (float)C), eps));
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxVecs; ++k) {
    const int vi = lane + k * kG;
    if (vi < nv) {
      const float4 gv = g4[vi], bv = b4[vi];
      const float gg[4] = {gv.x, gv.y, gv.z, gv.w};
      const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[k][e] = __fadd_rn(__fmul_rn(__fmul_rn(v[k][e], r), gg[e]), bb[e]);
        if constexpr (kQuant) amax = fmaxf(amax, fabsf(v[k][e]));
      }
    }
  }
  if constexpr (kQuant) {
    const float sc = row_scale(warp_max(amax)), rc = row_recip(sc);
    uint32_t* qr = reinterpret_cast<uint32_t*>(q + row * C);
#pragma unroll
    for (int k = 0; k < kMaxVecs; ++k) {
      const int vi = lane + k * kG;
      if (vi < nv) qr[vi] = code4_recip(v[k], sc, rc);
    }
    if (lane == 0) s[row] = sc;
  } else {
    float4* yr = reinterpret_cast<float4*>(y + row * C);
#pragma unroll
    for (int k = 0; k < kMaxVecs; ++k) {
      const int vi = lane + k * kG;
      if (vi < nv) yr[vi] = make_float4(v[k][0], v[k][1], v[k][2], v[k][3]);
    }
  }
}

// ln_f32_kernel's checks and launch.
template <bool kQuant>
cudaError_t launch_ln_f32(const void* x, const void* g, const void* b,
                          void* q, void* s, void* y, int M, int C, float eps,
                          cudaStream_t stream) {
  if (M <= 0 || C <= 0 || C % 4 || C > kMaxWidth ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return cudaErrorInvalidValue;
  ln_f32_kernel<kQuant><<<(M + kGroups - 1) / kGroups, kRowThreads, 0,
                          stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<const float*>(b), static_cast<int8_t*>(q),
      static_cast<float*>(s), static_cast<float*>(y), M, C, eps);
  return cudaGetLastError();
}

constexpr uint32_t smem_bytes(int C) {
  return ring_bytes<kGroups>(C) + 2 * C * 4;
}

template <bool kQuant, int kWidth>
cudaError_t launch(const void* x, const void* g, const void* b, void* q,
                   void* s, void* y, int M, int C, float eps,
                   cudaStream_t stream) {
  const auto kernel = ln_kernel<kQuant, kWidth>;
  // the shared-memory opt-in, once an instantiation, for the widest row
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(kMaxWidth));
  if (opt_in != cudaSuccess) return opt_in;
  const uint32_t smem = smem_bytes(C);
  const int grid = ring_grid(M, kGroups, smem);
  if (grid < 1) return cudaErrorInvalidDevice;
  kernel<<<grid, kRowThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(g),
      static_cast<const float*>(b), static_cast<int8_t*>(q),
      static_cast<float*>(s), static_cast<__nv_bfloat16*>(y), M, C, eps);
  return cudaGetLastError();
}

// EVA-g's trunk width, the main paths' rows, gets an instantiation of its
// own; any other C % 8 == 0 up to 2048 the general one.
template <bool kQuant>
cudaError_t launch_ln(const void* x, const void* g, const void* b, void* q,
                      void* s, void* y, int M, int C, float eps,
                      cudaStream_t stream) {
  if (M <= 0 || C <= 0 || C % 8 || C > kMaxWidth)
    return cudaErrorInvalidValue;
  return C == kEvaWidth
             ? launch<kQuant, kEvaWidth>(x, g, b, q, s, y, M, C, eps, stream)
             : launch<kQuant, 0>(x, g, b, q, s, y, M, C, eps, stream);
}

}  // namespace

// x [M, C] bf16, g/b [C] f32, q [M, C] int8, s [M] f32, all contiguous, x
// 16-byte aligned; C % 8 == 0 and C <= 2048. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int hirest_ln_quant(const void* x, const void* g, const void* b,
                               void* q, void* s, int M, int C, float eps,
                               void* stream) {
  return (int)launch_ln<true>(x, g, b, q, s, nullptr, M, C, eps,
                              (cudaStream_t)stream);
}

// As above with the LayerNorm written to y [M, C] bf16 (K10).
extern "C" int hirest_ln_bf16(const void* x, const void* g, const void* b,
                              void* y, int M, int C, float eps, void* stream) {
  return (int)launch_ln<false>(x, g, b, nullptr, nullptr, y, M, C, eps,
                               (cudaStream_t)stream);
}

// K2 on f32 x [M, C] (16-byte aligned), g/b [C] f32, q [M, C] int8, s [M]
// f32, all contiguous; C % 4 == 0 and C <= 2048. Launches on `stream`;
// returns cudaGetLastError().
extern "C" int hirest_ln_quant_f32(const void* x, const void* g,
                                   const void* b, void* q, void* s, int M,
                                   int C, float eps, void* stream) {
  return (int)launch_ln_f32<true>(x, g, b, q, s, nullptr, M, C, eps,
                                  (cudaStream_t)stream);
}

// K10 on f32 x [M, C] (16-byte aligned), g/b [C] f32, y [M, C] f32, all
// contiguous; C % 4 == 0 and C <= 2048. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int hirest_ln_f32(const void* x, const void* g, const void* b,
                             void* y, int M, int C, float eps, void* stream) {
  return (int)launch_ln_f32<false>(x, g, b, nullptr, nullptr, y, M, C, eps,
                                   (cudaStream_t)stream);
}

extern "C" const char* hirest_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
