// E1 and E2: the scanned EVA block's projection epilogues, the elementwise
// work that follows each of its four cuBLAS products.
//
// They replace no Pallas kernel. On the TPU, XLA fused each of them into the
// dot it follows (hirest_tpu/models/eva_scan.py:253-264): the qkv bias
// (:309-310), proj's bias and residual (:347), fc1's bias and GELU (:350),
// fc2's bias and residual (:351), and the int8 dyn path's GELU on int8_mm's
// output (:342). As eager PyTorch they were a chain of launches a product
// (gelu_bf16_poly alone some 15 f32 passes over [M, 6144]).
//
//   E1 bias_act:      y <- act(y + b)      in place on y [M, C]; b [C] or
//                                          none; act gelu_bf16_poly (0),
//                                          exact-erf GELU (1) or none (2)
//   E2 bias_residual: y <- x + (y + b)     in place on the fresh product
//                                          y [M, C], residual x [M, C]
//
// Each is the plain version rounding for rounding (ops/epilogue.py): in bf16
// the bias sum is rounded to bf16, as `y.add_(b)` stores it, and widened
// again for the GELU (gelu.cuh, operation by operation) or the residual sum,
// whose result is rounded once; in f32 nothing is rounded between the steps.
// __fadd_rn keeps nvcc from contracting a sum into an FMA.
//
// Bound on an H100 SXM (EVA-g, M = 128 * 257 = 32896), by bytes: each reads
// its operands once and writes y once. E1 at [M, 6144] moves 2 x 404.2 MB
// in bf16, 0.2413 ms at 3.35 TB/s (f32 0.4826); E1 on the qkv projection,
// [M, 4224], 2 x 277.9 MB, 0.1659 ms; E2 at [M, 1408], 3 x 92.6 MB, 0.0830
// ms. E1's gelu_bf16_poly takes 22 f32 issue slots a value and the bias,
// the widenings and the pack about 4 more: 0.16 ms on 132 SMs x 128 lanes
// x 1.98 GHz, under its bytes only if the loads overlap the arithmetic.
//
// Design: a grid-stride loop over 16-byte vectors (8 bf16 or 4 f32), the
// grid sized to fill every SM once (the occupancy calculator's blocks an
// SM times the SMs), each thread with kUnroll vectors of y (and of x) in
// flight before it computes any. The bias row, whose column pattern
// repeats every C values, is copied once a block into shared memory, so
// each vector's bias is one 16-byte shared load. y is not staged in shared
// memory: each value is read and written once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <initializer_list>

#include "gelu.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;       // 16-byte vectors a thread loads at a time
constexpr int kMaxWidth = 8192;  // widest row: its bias fits in 32 KB

// 16 bytes of T: 8 bf16 or 4 f32, widened to f32 and packed back.
template <typename T>
struct Pack;

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const uint4& u, float (&f)[N]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint4 store(const float (&f)[N]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i])) |
             ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1]))
              << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  // v as the plain version stores it between two steps: rounded to bf16
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ static void load(const uint4& u, float (&f)[N]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 store(const float (&f)[N]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ static float round(float v) { return v; }
};

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if constexpr (ACT == 0) {
    return gelu_poly(v);
  } else if constexpr (ACT == 1) {
    return gelu_erf(v);
  } else {
    return v;
  }
}

// The bias row [cvec vectors] into the block's shared memory.
__device__ __forceinline__ void stage_bias(uint4* bs, const void* b,
                                           unsigned cvec) {
  const uint4* bv = static_cast<const uint4*>(b);
  for (unsigned i = threadIdx.x; i < cvec; i += kThreads)
    bs[i] = __ldg(bv + i);
  __syncthreads();
}

// E1 on y [nvec vectors], rows of cvec vectors; b [cvec vectors] when kBias.
template <typename T, int ACT, bool kBias>
__global__ void __launch_bounds__(kThreads)
    bias_act_kernel(uint4* __restrict__ y, const void* __restrict__ b,
                    unsigned nvec, unsigned cvec) {
  using P = Pack<T>;
  extern __shared__ uint4 bs[];
  if constexpr (kBias) stage_bias(bs, b, cvec);
  const unsigned step = gridDim.x * kThreads * kUnroll;
  for (unsigned base = blockIdx.x * kThreads * kUnroll + threadIdx.x;
       base < nvec; base += step) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned i = base + u * kThreads;
      if (i < nvec) v[u] = y[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned i = base + u * kThreads;
      if (i < nvec) {
        float f[P::N];
        P::load(v[u], f);
        if constexpr (kBias) {
          float g[P::N];
          P::load(bs[i % cvec], g);
#pragma unroll
          for (int k = 0; k < P::N; ++k)
            f[k] = P::round(__fadd_rn(f[k], g[k]));
        }
#pragma unroll
        for (int k = 0; k < P::N; ++k) f[k] = activate<ACT>(f[k]);
        y[i] = P::store(f);
      }
    }
  }
}

// E2 on y and x [nvec vectors], rows of cvec vectors; b [cvec vectors].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bias_residual_kernel(uint4* __restrict__ y, const uint4* __restrict__ x,
                         const void* __restrict__ b, unsigned nvec,
                         unsigned cvec) {
  using P = Pack<T>;
  extern __shared__ uint4 bs[];
  stage_bias(bs, b, cvec);
  const unsigned step = gridDim.x * kThreads * kUnroll;
  for (unsigned base = blockIdx.x * kThreads * kUnroll + threadIdx.x;
       base < nvec; base += step) {
    uint4 v[kUnroll], r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned i = base + u * kThreads;
      if (i < nvec) {
        v[u] = y[i];
        r[u] = __ldg(x + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned i = base + u * kThreads;
      if (i < nvec) {
        float f[P::N], g[P::N], h[P::N];
        P::load(v[u], f);
        P::load(bs[i % cvec], g);
        P::load(r[u], h);
#pragma unroll
        for (int k = 0; k < P::N; ++k)
          f[k] = __fadd_rn(h[k], P::round(__fadd_rn(f[k], g[k])));
        y[i] = P::store(f);
      }
    }
  }
}

// The card's SMs, read once.
int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    return n;
  }();
  return sms;
}

// Launch `kernel` over nvec vectors with smem bytes of bias a block: as many
// blocks as fill every SM once, never more than the vectors need.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t smem, unsigned nvec,
                   cudaStream_t stream, Args... args) {
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  if (sms <= 0 || per_sm <= 0) return cudaErrorInvalidConfiguration;
  const long long need = ((long long)nvec + kThreads * kUnroll - 1) /
                         (kThreads * kUnroll);
  const long long most = (long long)sms * per_sm;
  kernel<<<(unsigned)(need < most ? need : most), kThreads, smem, stream>>>(
      args...);
  return cudaGetLastError();
}

// The shapes both kernels take: M, C > 0, C a multiple of the vector's
// values and at most kMaxWidth, M * C an int, pointers 16-byte aligned.
bool shape_ok(int M, int C, int per_vec,
              std::initializer_list<const void*> ptrs) {
  if (M <= 0 || C <= 0 || C % per_vec || C > kMaxWidth ||
      (long long)M * C > INT_MAX)
    return false;
  for (const void* p : ptrs)
    if (p && reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

template <typename T>
cudaError_t bias_act(void* y, const void* b, int M, int C, int act,
                     cudaStream_t st) {
  constexpr int V = Pack<T>::N;
  if (!shape_ok(M, C, V, {y, b}) || act < 0 || act > 2 || (!b && act == 2))
    return cudaErrorInvalidValue;
  const unsigned nvec = (unsigned)((long long)M * C / V), cvec = C / V;
  uint4* yv = static_cast<uint4*>(y);
  const size_t smem = b ? cvec * sizeof(uint4) : 0;
  if (b) {
    switch (act) {
      case 0:
        return launch(bias_act_kernel<T, 0, true>, smem, nvec, st, yv, b, nvec,
                      cvec);
      case 1:
        return launch(bias_act_kernel<T, 1, true>, smem, nvec, st, yv, b, nvec,
                      cvec);
      default:
        return launch(bias_act_kernel<T, 2, true>, smem, nvec, st, yv, b, nvec,
                      cvec);
    }
  }
  if (act == 0)
    return launch(bias_act_kernel<T, 0, false>, smem, nvec, st, yv, b, nvec,
                  cvec);
  return launch(bias_act_kernel<T, 1, false>, smem, nvec, st, yv, b, nvec,
                cvec);
}

template <typename T>
cudaError_t bias_residual(void* y, const void* x, const void* b, int M, int C,
                          cudaStream_t st) {
  constexpr int V = Pack<T>::N;
  if (!x || !b || !shape_ok(M, C, V, {y, x, b})) return cudaErrorInvalidValue;
  const unsigned nvec = (unsigned)((long long)M * C / V), cvec = C / V;
  return launch(bias_residual_kernel<T>, cvec * sizeof(uint4), nvec, st,
                static_cast<uint4*>(y), static_cast<const uint4*>(x), b, nvec,
                cvec);
}

}  // namespace

// E1: y [M, C] bf16 in place, b [C] bf16 or null; all contiguous and
// 16-byte aligned; C % 8 == 0, C <= 8192; act 0 gelu_bf16_poly, 1 exact
// GELU, 2 none (not without b). Launches on `stream`; returns
// cudaGetLastError().
extern "C" int hirest_bias_act(void* y, const void* b, int M, int C, int act,
                               void* stream) {
  return (int)bias_act<__nv_bfloat16>(y, b, M, C, act, (cudaStream_t)stream);
}

// E1 on f32 y and b, C % 4 == 0; otherwise as hirest_bias_act.
extern "C" int hirest_bias_act_f32(void* y, const void* b, int M, int C,
                                   int act, void* stream) {
  return (int)bias_act<float>(y, b, M, C, act, (cudaStream_t)stream);
}

// E2: y [M, C] bf16 in place, x [M, C] and b [C] bf16; all contiguous and
// 16-byte aligned; C % 8 == 0, C <= 8192. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int hirest_bias_residual(void* y, const void* x, const void* b,
                                    int M, int C, void* stream) {
  return (int)bias_residual<__nv_bfloat16>(y, x, b, M, C,
                                           (cudaStream_t)stream);
}

// E2 on f32 y, x and b, C % 4 == 0; otherwise as hirest_bias_residual.
extern "C" int hirest_bias_residual_f32(void* y, const void* x, const void* b,
                                        int M, int C, void* stream) {
  return (int)bias_residual<float>(y, x, b, M, C, (cudaStream_t)stream);
}

extern "C" const char* hirest_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
