// K4: the int8 MLP of the EVA trunk in one kernel: fc1 -> activation ->
// per-(row, chunk) int8 requant -> fc2 -> + bias + residual.
//
// Replaces hirest_tpu/ops/quant.py::fused_mlp_int8 (kernel body
// _fused_mlp_kernel). With h_q [M, C] int8 and row scales h_s, w1 [F, C] and
// w2 [C, F] int8 (nn.Linear's [out, in] layout, contiguous along the reduced
// axis) with channel scales s1 [F], s2 [C], biases b1, b2 and the residual
// x [M, C] bf16, for each 1024-unit chunk of the F hidden units:
//   y    = act(((f32(h_q w1^T) * h_s) * s1) + b1)                (f32)
//   sc   = max(max|y| / 127, 1e-8) per (row, chunk)
//   q2   = clamp(round_half_even(y / sc), -127, 127)
//   part = (f32(q2 w2^T) * sc) * s2
//   acc  = (x + b2) + part on the first chunk, acc + part after
// and out = bf16(acc). Products are exact in int32; every f32 step is
// rounded where the reference rounds it (__fmul_rn / __fadd_rn keep nvcc
// from contracting them into FMAs), so with act = gelu_poly the codes and
// the output match the plain version bit for bit.
//
// Bound on an H100 SXM (EVA-g, M = 128 * 257 = 32896, C = 1408, F = 6144):
// 1.138 TOP of int8 products, 0.575 ms at 1979 TOP/s dense int8, against
// 249 MB that it must move (h_q, x, out and 17.3 MB of weights), 0.074 ms
// at 3.35 TB/s. It is bound by operations.
//
// Design (simple first version; mma.sync, no TMA, wgmma or pipelining):
// - One block of 8 warps per 32 rows. The block stages its h_q rows in
//   shared memory once and walks the six chunks.
// - fc1: each warp computes 128 of the chunk's 1024 columns for all 32 rows,
//   64 at a time, with mma.sync m16n8k32 s8 (int32 accumulate), w1's
//   fragments straight from device memory. The dequantized, activated f32
//   values are parked in shared memory (32 x 1024 f32, 129 KB): the row's
//   scale needs all 1024 columns of the chunk.
// - requant: one warp per row takes the row max, then writes the int8 codes
//   over the start of the same row (every lane has read the row first).
// - fc2: each warp computes 176 of the 1408 output columns, 88 at a time,
//   from the codes in shared memory and w2's fragments from device memory.
//   Between chunks the f32 sum lives in a [M, C] workspace; each element is
//   written and read back by the same thread, so it needs no atomics.
// - Each block reads all of w1 and w2 (17.3 MB) once, from L2 for all but
//   the first blocks: about 18 GB of L2 traffic a call at M = 32896.
// - Fragment k-order: for a 32-deep step at k0 a lane (g, t) holds bytes
//   k0 + 8t .. k0 + 8t + 7 of its A rows and of its B column, so every
//   fragment is one 8-byte load. The mma's k index 4t + i stands for
//   k0 + 8t + i and 16 + 4t + i for k0 + 8t + 4 + i, in A and B alike: a
//   permutation of the 32 products summed, so the int32 result is the same.
// - Row strides of 1440 bytes (h_q) and 4128 bytes (parked rows and codes)
//   are 32 mod 128, so the 8-byte fragment loads and the float2 stores of a
//   half-warp fall in 32 different banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gelu.cuh"

namespace {

constexpr int kC = 1408;  // trunk width: fc1's depth, fc2's width
constexpr int kNC = 1024;  // hidden units per chunk (one requant scale a row)
constexpr int kBM = 32;    // rows per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kHqStride = kC + 32;        // bytes per staged h_q row
constexpr int kYStride = kNC + 8;         // floats per parked hidden row
constexpr int kQ2Stride = kYStride * 4;   // bytes per row of codes (in place)
constexpr int kFc1WarpCols = kNC / kWarps;  // 128
constexpr int kFc1Nt = 8;                   // 8-column tiles per fc1 pass
constexpr int kFc2WarpCols = kC / kWarps;   // 176
constexpr int kFc2Nt = 11;                  // 8-column tiles per fc2 pass
constexpr size_t kSmem = (size_t)kBM * kHqStride +
                         (size_t)kBM * kYStride * sizeof(float) +
                         2 * kBM * sizeof(float);
static_assert(kFc1WarpCols % (kFc1Nt * 8) == 0, "fc1 passes");
static_assert(kFc2WarpCols % (kFc2Nt * 8) == 0, "fc2 passes");
static_assert(kC % 32 == 0 && kNC % 128 == 0, "k steps");
static_assert(kBM % kWarps == 0, "requant rows");

// A rows g (lo) and g + 8 (hi), B column g; fragment k-order as above.
__device__ __forceinline__ void mma_s8(int (&c)[4], uint2 lo, uint2 hi,
                                       uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(lo.x), "r"(hi.x), "r"(lo.y), "r"(hi.y), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ uint2 ld_smem8(const int8_t* p) {
  return *reinterpret_cast<const uint2*>(p);
}

__device__ __forceinline__ uint2 ld_global8(const int8_t* p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}

template <int kAct>
__device__ __forceinline__ float fc1_value(int acc, float hs, float s1,
                                           float b1) {
  const float y = __fadd_rn(__fmul_rn(__fmul_rn((float)acc, hs), s1), b1);
  if constexpr (kAct == 0) {
    return gelu_poly(y);
  } else {
    return gelu_erf(y);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ uint32_t code4(float4 y, float s) {
  const float yy[4] = {y.x, y.y, y.z, y.w};
  uint32_t packed = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = max(-127, min(127, __float2int_rn(__fdiv_rn(yy[k], s))));
    packed |= (uint32_t)(uint8_t)(int8_t)c << (8 * k);
  }
  return packed;
}

template <int kAct>
__global__ void __launch_bounds__(kThreads, 1)
    fused_mlp_int8_kernel(const int8_t* __restrict__ hq,
                          const float* __restrict__ hs,
                          const int8_t* __restrict__ w1,
                          const float* __restrict__ s1,
                          const float* __restrict__ b1,
                          const int8_t* __restrict__ w2,
                          const float* __restrict__ s2,
                          const float* __restrict__ b2,
                          const __nv_bfloat16* __restrict__ x,
                          float* __restrict__ ws,
                          __nv_bfloat16* __restrict__ out, int M, int F) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* hq_s = reinterpret_cast<int8_t*>(smem);                 // [kBM][kHqStride]
  float* y_s = reinterpret_cast<float*>(smem + kBM * kHqStride);  // [kBM][kYStride]
  const int8_t* q2_s = reinterpret_cast<const int8_t*>(y_s);      // [kBM][kQ2Stride]
  float* hs_s = y_s + kBM * kYStride;                             // [kBM]
  float* sc_s = hs_s + kBM;                                       // [kBM]

  const int m0 = blockIdx.x * kBM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  // Stage the block's h_q rows (zero past M) and their scales.
  constexpr int kRowVecs = kC / 16;
  for (int i = threadIdx.x; i < kBM * kRowVecs; i += kThreads) {
    const int r = i / kRowVecs, v = i % kRowVecs;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (m0 + r < M)
      val = __ldg(reinterpret_cast<const uint4*>(hq + (size_t)(m0 + r) * kC) + v);
    *reinterpret_cast<uint4*>(hq_s + r * kHqStride + v * 16) = val;
  }
  if (threadIdx.x < kBM) {
    const int r = threadIdx.x;
    hs_s[r] = m0 + r < M ? hs[m0 + r] : 0.f;
  }
  __syncthreads();

  const int n_chunks = F / kNC;
  for (int j = 0; j < n_chunks; ++j) {
    // fc1 for this chunk -> dequantize -> activation -> y_s (f32).
#pragma unroll 1
    for (int pass = 0; pass < kFc1WarpCols / (kFc1Nt * 8); ++pass) {
      const int col0 = warp * kFc1WarpCols + pass * kFc1Nt * 8;  // in chunk
      int acc[2][kFc1Nt][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < kFc1Nt; ++nt)
          acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;
      const int8_t* wb = w1 + (size_t)(j * kNC + col0 + g) * kC + 8 * t;
      const int8_t* ab = hq_s + g * kHqStride + 8 * t;
#pragma unroll 2
      for (int k0 = 0; k0 < kC; k0 += 32) {
        uint2 bv[kFc1Nt];
#pragma unroll
        for (int nt = 0; nt < kFc1Nt; ++nt)
          bv[nt] = ld_global8(wb + (size_t)nt * 8 * kC + k0);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const uint2 lo = ld_smem8(ab + mt * 16 * kHqStride + k0);
          const uint2 hi = ld_smem8(ab + (mt * 16 + 8) * kHqStride + k0);
#pragma unroll
          for (int nt = 0; nt < kFc1Nt; ++nt) mma_s8(acc[mt][nt], lo, hi, bv[nt]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int ra = mt * 16 + g, rb = ra + 8;
        const float hsa = hs_s[ra], hsb = hs_s[rb];
#pragma unroll
        for (int nt = 0; nt < kFc1Nt; ++nt) {
          const int cl = col0 + nt * 8 + 2 * t;
          const float2 sv = *reinterpret_cast<const float2*>(s1 + j * kNC + cl);
          const float2 bv = *reinterpret_cast<const float2*>(b1 + j * kNC + cl);
          const int* a = acc[mt][nt];
          *reinterpret_cast<float2*>(y_s + ra * kYStride + cl) =
              make_float2(fc1_value<kAct>(a[0], hsa, sv.x, bv.x),
                          fc1_value<kAct>(a[1], hsa, sv.y, bv.y));
          *reinterpret_cast<float2*>(y_s + rb * kYStride + cl) =
              make_float2(fc1_value<kAct>(a[2], hsb, sv.x, bv.x),
                          fc1_value<kAct>(a[3], hsb, sv.y, bv.y));
        }
      }
    }
    __syncthreads();

    // Requantize each row of the chunk in place: f32 y_s -> int8 codes.
    constexpr int kVecs = kNC / 128;  // float4 a lane per row
#pragma unroll 1
    for (int rr = 0; rr < kBM / kWarps; ++rr) {
      const int r = warp * (kBM / kWarps) + rr;
      const float4* src = reinterpret_cast<const float4*>(y_s + r * kYStride);
      float4 v[kVecs];
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {
        v[i] = src[i * 32 + lane];
        amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v[i].x), fabsf(v[i].y)),
                                 fmaxf(fabsf(v[i].z), fabsf(v[i].w))));
      }
      const float sc = fmaxf(__fdiv_rn(warp_max(amax), 127.f), 1e-8f);
      __syncwarp();  // the whole row is in registers before codes overwrite it
      uint32_t* dst = reinterpret_cast<uint32_t*>(y_s + r * kYStride);
#pragma unroll
      for (int i = 0; i < kVecs; ++i) dst[i * 32 + lane] = code4(v[i], sc);
      if (lane == 0) sc_s[r] = sc;
    }
    __syncthreads();

    // fc2 partial of this chunk -> scale -> accumulate (workspace or out).
    const bool first = j == 0, last = j == n_chunks - 1;
#pragma unroll 1
    for (int pass = 0; pass < kFc2WarpCols / (kFc2Nt * 8); ++pass) {
      const int col0 = warp * kFc2WarpCols + pass * kFc2Nt * 8;
      int acc[2][kFc2Nt][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < kFc2Nt; ++nt)
          acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;
      const int8_t* wb = w2 + (size_t)(col0 + g) * F + (size_t)j * kNC + 8 * t;
      const int8_t* ab = q2_s + g * kQ2Stride + 8 * t;
#pragma unroll 2
      for (int k0 = 0; k0 < kNC; k0 += 32) {
        uint2 bv[kFc2Nt];
#pragma unroll
        for (int nt = 0; nt < kFc2Nt; ++nt)
          bv[nt] = ld_global8(wb + (size_t)nt * 8 * F + k0);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const uint2 lo = ld_smem8(ab + mt * 16 * kQ2Stride + k0);
          const uint2 hi = ld_smem8(ab + (mt * 16 + 8) * kQ2Stride + k0);
#pragma unroll
          for (int nt = 0; nt < kFc2Nt; ++nt) mma_s8(acc[mt][nt], lo, hi, bv[nt]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = mt * 16 + g + 8 * half;
          const int m = m0 + r;
          if (m >= M) continue;
          const float sc = sc_s[r];
#pragma unroll
          for (int nt = 0; nt < kFc2Nt; ++nt) {
            const int n = col0 + nt * 8 + 2 * t;
            const float2 sv = *reinterpret_cast<const float2*>(s2 + n);
            const size_t at = (size_t)m * kC + n;
            float v0 = __fmul_rn(__fmul_rn((float)acc[mt][nt][2 * half], sc), sv.x);
            float v1 = __fmul_rn(__fmul_rn((float)acc[mt][nt][2 * half + 1], sc), sv.y);
            float2 prev;
            if (first) {
              const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + at);
              const float2 bv = *reinterpret_cast<const float2*>(b2 + n);
              prev = make_float2(__fadd_rn(__low2float(xv), bv.x),
                                 __fadd_rn(__high2float(xv), bv.y));
            } else {
              prev = *reinterpret_cast<const float2*>(ws + at);
            }
            v0 = __fadd_rn(prev.x, v0);
            v1 = __fadd_rn(prev.y, v1);
            if (last)
              *reinterpret_cast<__nv_bfloat162*>(out + at) = __floats2bfloat162_rn(v0, v1);
            else
              *reinterpret_cast<float2*>(ws + at) = make_float2(v0, v1);
          }
        }
      }
    }
    __syncthreads();  // the next chunk's fc1 overwrites the codes
  }
}

template <int kAct>
cudaError_t launch(const void* hq, const void* hs, const void* w1,
                   const void* s1, const void* b1, const void* w2,
                   const void* s2, const void* b2, const void* x, void* ws,
                   void* out, int M, int F, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_int8_kernel<kAct>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return err;
  fused_mlp_int8_kernel<kAct><<<(M + kBM - 1) / kBM, kThreads, kSmem, stream>>>(
      static_cast<const int8_t*>(hq), static_cast<const float*>(hs),
      static_cast<const int8_t*>(w1), static_cast<const float*>(s1),
      static_cast<const float*>(b1), static_cast<const int8_t*>(w2),
      static_cast<const float*>(s2), static_cast<const float*>(b2),
      static_cast<const __nv_bfloat16*>(x), static_cast<float*>(ws),
      static_cast<__nv_bfloat16*>(out), M, F);
  return cudaGetLastError();
}

}  // namespace

// h_q [M, 1408] int8, h_s [M] f32, w1 [F, 1408] int8, s1/b1 [F] f32,
// w2 [1408, F] int8, s2/b2 [1408] f32, x and out [M, 1408] bf16, all
// contiguous; F a multiple of 1024; ws [M, 1408] f32 scratch (unused when
// F == 1024). act 0 is gelu_bf16_poly, 1 exact GELU. Launches on `stream`;
// returns cudaGetLastError().
extern "C" int hirest_fused_mlp_int8(const void* hq, const void* hs,
                                     const void* w1, const void* s1,
                                     const void* b1, const void* w2,
                                     const void* s2, const void* b2,
                                     const void* x, void* ws, void* out, int M,
                                     int F, int act, void* stream) {
  if (M <= 0 || F <= 0 || F % kNC) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (act == 0)
    return (int)launch<0>(hq, hs, w1, s1, b1, w2, s2, b2, x, ws, out, M, F, st);
  if (act == 1)
    return (int)launch<1>(hq, hs, w1, s1, b1, w2, s2, b2, x, ws, out, M, F, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* hirest_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
