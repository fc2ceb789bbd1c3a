// E3 and E4: the int8 projections' dequant epilogue and the dynamic per-row
// quantizer of the int8 towers.
//
// They replace no Pallas kernel. On the TPU, XLA fused each into the dot it
// belongs to: E3 is the epilogue of hirest_tpu/models/eva_scan.py:92-101
// (_int8_mm) and of hirest_tpu/ops/quant.py:41-56 (int8_matmul), with the
// residual sum that follows it at eva_scan.py:320, :334, :338 and :345; E4
// is eva_scan.py:84-89 (_dyn_quant_rows) and int8_matmul's quantization. As
// eager PyTorch each was a chain of passes over int32 or f32 [M, N] tensors.
//
//   E3 dequant:   out = dt((f32(acc) * xs) * ws + b)      acc int32 [M, N],
//                 or, with a residual x [M, N] of dt,     xs f32 [M], ws and
//                 out = dt(x + dt((f32(acc) * xs) * ws + b))   b f32 [N]
//   E4 row_quant: s = max(max|x| / 127, 1e-8)             x bf16 or f32
//                 q = clamp(round_half_even(x / s), -127, 127)   [M, C]
//
// Each is the plain version rounding for rounding (ops/quant.py:
// int8_epilogue_ref, dyn_quant_rows_ref). E3's arithmetic is
// int8_dequant.cuh's, which G1 (int8_gemm.cu) runs in its own epilogue:
// since G1 takes the int8 products whole, E3 runs on no path of the port.
// E4's divisions are IEEE (__fdiv_rn, rowquant.cuh's row_scale and code4),
// then __float2int_rn (half to even) and the clip. row_quant_kernel takes
// only the rows that the bulk-copy ring does not (ops/quant.py::
// row_quant_route): the unrolled tower's 588-wide patch rows (1,176 bytes
// a row: neither a multiple of 16 bytes nor 16-byte aligned) and f32 rows;
// bf16 rows a bulk copy takes run K5's ring body (act_quant.cu,
// hirest_row_quant_ring).
//
// Bound on an H100 SXM (EVA-g, M = 128 * 257 = 32896), by bytes. E3 on the
// qkv projection, [M, 4224]: 555.8 MB of int32 in, 277.9 MB of bf16 out,
// 0.2489 ms at 3.35 TB/s; on proj / fc2, [M, 1408], with the residual:
// 185.3 + 92.6 + 92.6 MB, 0.1106 ms; on fc1 (int8 dyn), [M, 6144]: 0.3620
// ms. E4 at [M, 1408] from bf16: 92.6 MB in, 46.3 MB of codes out, 0.0415
// ms; at [M, 6144]: 0.1811 ms.
//
// Design. E3: a grid-stride loop over vectors of 4 values (16 bytes of
// int32), the grid sized to fill every SM once, each thread with kUnroll
// vectors in flight before it computes any; the ws and b rows are copied
// once a block into shared memory, as epilogue.cu does with its bias. E4:
// one group of kG threads a row (a warp up to 2048 values, else a
// warpgroup), eight warps or two warpgroups a block, each thread holding
// up to kVecs vectors of 4 values in registers until the row's max is
// known (warp shuffles, then for a warpgroup shared memory). E4 writes its
// codes into rows ldq >= C wide, zero past C, and zero codes and scale
// into rows M..rows-1: int8_matmul's operand of G1, zero-padded along K
// (the patch rows' 588 to 592), so no pad pass follows it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "int8_dequant.cuh"
#include "rowquant.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;       // E3: vectors a thread loads at a time
constexpr int kMaxWidth = 8192;  // widest row of either kernel
constexpr int kWarpRowWidth = 2048;  // E4: rows up to this go to warps

// 4 values of T: bf16 (8 bytes) or f32 (16 bytes), widened and packed.
template <typename T>
struct Vec4;

template <>
struct Vec4<__nv_bfloat16> {
  using Raw = uint2;
  __device__ static void load(const Raw& u, float (&f)[4]) {
    f[0] = __uint_as_float(u.x << 16);
    f[1] = __uint_as_float(u.x & 0xffff0000u);
    f[2] = __uint_as_float(u.y << 16);
    f[3] = __uint_as_float(u.y & 0xffff0000u);
  }
  __device__ static uint32_t pack2(float a, float b) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
  }
  __device__ static Raw store(const float (&f)[4]) {
    return make_uint2(pack2(f[0], f[1]), pack2(f[2], f[3]));
  }
};

template <>
struct Vec4<float> {
  using Raw = float4;
  __device__ static void load(const Raw& u, float (&f)[4]) {
    f[0] = u.x;
    f[1] = u.y;
    f[2] = u.z;
    f[3] = u.w;
  }
  __device__ static Raw store(const float (&f)[4]) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// E3 on acc [nvec vectors of 4], rows of cvec vectors: ws and b (when
// kBias) staged in shared memory, x read when kResidual.
template <typename T, bool kBias, bool kResidual>
__global__ void __launch_bounds__(kThreads)
    dequant_kernel(const int4* __restrict__ acc, const float* __restrict__ xs,
                   const float4* __restrict__ ws, const float4* __restrict__ b,
                   const typename Vec4<T>::Raw* __restrict__ x,
                   typename Vec4<T>::Raw* __restrict__ out, unsigned nvec,
                   unsigned cvec) {
  using V = Vec4<T>;
  extern __shared__ float4 rows[];  // ws, then b
  for (unsigned i = threadIdx.x; i < cvec; i += kThreads) {
    rows[i] = __ldg(ws + i);
    if constexpr (kBias) rows[cvec + i] = __ldg(b + i);
  }
  __syncthreads();
  const unsigned step = gridDim.x * kThreads * kUnroll;
  for (unsigned base = blockIdx.x * kThreads * kUnroll + threadIdx.x;
       base < nvec; base += step) {
    int4 a[kUnroll];
    typename V::Raw r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned i = base + u * kThreads;
      if (i < nvec) {
        a[u] = __ldcs(acc + i);  // read once: stream it past the L2
        if constexpr (kResidual) r[u] = __ldg(x + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned i = base + u * kThreads;
      if (i < nvec) {
        const unsigned c = i % cvec;
        const float s = __ldg(xs + i / cvec);
        const float4 w = rows[c];
        const int av[4] = {a[u].x, a[u].y, a[u].z, a[u].w};
        const float wv[4] = {w.x, w.y, w.z, w.w};
        float f[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          f[k] = int8_dequant(av[k], s, wv[k]);
        if constexpr (kBias) {
          const float4 bb = rows[cvec + c];
          const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) f[k] = int8_dequant_bias(f[k], bv[k]);
        }
        if constexpr (kResidual) {
          float h[4];
          V::load(r[u], h);
#pragma unroll
          for (int k = 0; k < 4; ++k) f[k] = int8_residual_sum<T>(h[k], f[k]);
        }
        out[i] = V::store(f);
      }
    }
  }
}

// E4: groups of kG threads (32 or 128), a row each, each thread up to
// kVecs vectors of 4 values. x rows ldx values apart; q rows ldq bytes.
template <typename T, int kG, int kVecs>
__global__ void __launch_bounds__(kThreads)
    row_quant_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ s, int M, int rows, int C,
                     long long ldx, int ldq) {
  using V = Vec4<T>;
  constexpr int kGroups = kThreads / kG;
  constexpr int kWarps = kG / 32;
  __shared__ float red[kGroups][kWarps];
  const int group = threadIdx.x / kG, t = threadIdx.x % kG;
  const long long row = (long long)blockIdx.x * kGroups + group;
  if (row >= rows) return;  // whole groups: no barrier below is skipped
  const bool live = row < M;  // rows past M are zero padding
  const int nv = C / 4;
  const auto* xr = reinterpret_cast<const typename V::Raw*>(x + row * ldx);
  float v[kVecs][4];
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    if (live && t + k * kG < nv) {
      V::load(__ldcs(xr + t + k * kG), v[k]);
#pragma unroll
      for (int e = 0; e < 4; ++e) amax = fmaxf(amax, fabsf(v[k][e]));
    }
  }
  amax = warp_max(amax);
  if constexpr (kWarps > 1) {
    if (t % 32 == 0) red[group][t / 32] = amax;
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "n"(kG) : "memory");
#pragma unroll
    for (int w = 0; w < kWarps; ++w) amax = fmaxf(amax, red[group][w]);
  }
  uint32_t* qr = reinterpret_cast<uint32_t*>(q + row * ldq);
  if (!live) {
    for (int i = t; i < ldq / 4; i += kG) qr[i] = 0u;
    if (t == 0) s[row] = 0.f;
    return;
  }
  const float sc = row_scale(amax);
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    if (t + k * kG < nv) qr[t + k * kG] = code4(v[k], sc);
  }
  for (int i = nv + t; i < ldq / 4; i += kG) qr[i] = 0u;
  if (t == 0) s[row] = sc;
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

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, bool kBias, bool kResidual>
cudaError_t launch_dequant(const void* acc, const float* xs, const float* ws,
                           const float* b, const void* x, void* out,
                           unsigned nvec, unsigned cvec, cudaStream_t st) {
  using Raw = typename Vec4<T>::Raw;
  const auto kernel = dequant_kernel<T, kBias, kResidual>;
  // the shared-memory opt-in, once an instantiation, for its widest rows
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(2 * kMaxWidth * sizeof(float)));
  if (opt_in != cudaSuccess) return opt_in;
  const size_t smem = (kBias ? 2 : 1) * cvec * sizeof(float4);
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  if (sms <= 0 || per_sm <= 0) return cudaErrorInvalidConfiguration;
  const long long need = ((long long)nvec + kThreads * kUnroll - 1) /
                         (kThreads * kUnroll);
  const long long most = (long long)sms * per_sm;
  kernel<<<(unsigned)(need < most ? need : most), kThreads, smem, st>>>(
      static_cast<const int4*>(acc), xs, reinterpret_cast<const float4*>(ws),
      reinterpret_cast<const float4*>(b), static_cast<const Raw*>(x),
      static_cast<Raw*>(out), nvec, cvec);
  return cudaGetLastError();
}

// E3's shapes: M, N > 0, N % 4 == 0 and at most kMaxWidth, M * N an int;
// acc, ws, b, x and out 16-byte aligned (x and out of bf16: 8 bytes).
template <typename T>
cudaError_t dequant(const void* acc, const float* xs, const float* ws,
                    const float* b, const void* x, void* out, int M, int N,
                    cudaStream_t st) {
  const int vb = 4 * sizeof(T);
  if (M <= 0 || N <= 0 || N % 4 || N > kMaxWidth ||
      (long long)M * N > INT_MAX || !acc || !xs || !ws || !out ||
      !aligned(acc, 16) || !aligned(ws, 16) || (b && !aligned(b, 16)) ||
      (x && !aligned(x, vb)) || !aligned(out, vb))
    return cudaErrorInvalidValue;
  const unsigned nvec = (unsigned)((long long)M * N / 4), cvec = N / 4;
  if (b) {
    if (x)
      return launch_dequant<T, true, true>(acc, xs, ws, b, x, out, nvec, cvec,
                                           st);
    return launch_dequant<T, true, false>(acc, xs, ws, b, x, out, nvec, cvec,
                                          st);
  }
  if (x)
    return launch_dequant<T, false, true>(acc, xs, ws, b, x, out, nvec, cvec,
                                          st);
  return launch_dequant<T, false, false>(acc, xs, ws, b, x, out, nvec, cvec,
                                         st);
}

template <typename T, int kG, int kVecs>
cudaError_t launch_rows(const T* x, int8_t* q, float* s, int M, int rows,
                        int C, long long ldx, int ldq, cudaStream_t st) {
  constexpr int kGroups = kThreads / kG;
  row_quant_kernel<T, kG, kVecs>
      <<<(rows + kGroups - 1) / kGroups, kThreads, 0, st>>>(x, q, s, M, rows,
                                                            C, ldx, ldq);
  return cudaGetLastError();
}

// E4's instantiation for rows of C: a warp a row up to 2048 values, else a
// warpgroup, each with the fewest vectors a thread (4, 8, 12 or 16) the row
// needs. EVA-g's widths: 1408 a warp with 12 (11 used), 6144 a warpgroup
// with 12, the unrolled tower's patch rows (588) a warp with 8 (5 used).
template <typename T>
cudaError_t row_quant(const void* x, void* q, void* s, int M, int rows, int C,
                      long long ldx, int ldq, cudaStream_t st) {
  if (M <= 0 || rows < M || C <= 0 || C % 4 || C > kMaxWidth || ldx < C ||
      ldx % 4 || ldq < C || ldq % 4 || !x || !q || !s ||
      !aligned(x, 4 * sizeof(T)) || !aligned(q, 4) ||
      (long long)rows * ldq > INT_MAX)
    return cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  auto* qp = static_cast<int8_t*>(q);
  auto* sp = static_cast<float*>(s);
  const int nv = C / 4;
  if (C <= kWarpRowWidth) {
    const int vecs = (nv + 31) / 32;
    if (vecs <= 4)
      return launch_rows<T, 32, 4>(xp, qp, sp, M, rows, C, ldx, ldq, st);
    if (vecs <= 8)
      return launch_rows<T, 32, 8>(xp, qp, sp, M, rows, C, ldx, ldq, st);
    if (vecs <= 12)
      return launch_rows<T, 32, 12>(xp, qp, sp, M, rows, C, ldx, ldq, st);
    return launch_rows<T, 32, 16>(xp, qp, sp, M, rows, C, ldx, ldq, st);
  }
  const int vecs = (nv + 127) / 128;
  if (vecs <= 8)
    return launch_rows<T, 128, 8>(xp, qp, sp, M, rows, C, ldx, ldq, st);
  if (vecs <= 12)
    return launch_rows<T, 128, 12>(xp, qp, sp, M, rows, C, ldx, ldq, st);
  return launch_rows<T, 128, 16>(xp, qp, sp, M, rows, C, ldx, ldq, st);
}

}  // namespace

// E3 with bf16 out: acc [M, N] int32, xs [M] f32, ws [N] f32, b [N] f32 or
// null, x [M, N] bf16 or null (the residual), out [M, N] bf16; contiguous;
// acc, ws, b 16-byte aligned, x and out 8-byte; N % 4 == 0, N <= 8192.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int hirest_dequant(const void* acc, const void* xs, const void* ws,
                              const void* b, const void* x, void* out, int M,
                              int N, void* stream) {
  return (int)dequant<__nv_bfloat16>(
      acc, static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<const float*>(b), x, out, M, N, (cudaStream_t)stream);
}

// E3 with f32 out and an f32 residual (16-byte aligned); otherwise as
// hirest_dequant.
extern "C" int hirest_dequant_f32(const void* acc, const void* xs,
                                  const void* ws, const void* b, const void* x,
                                  void* out, int M, int N, void* stream) {
  return (int)dequant<float>(
      acc, static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<const float*>(b), x, out, M, N, (cudaStream_t)stream);
}

// E4 on bf16 rows: x [M, C] with rows ldx values apart (8-byte aligned,
// C % 4 == 0, ldx % 4 == 0, C <= 8192) -> q [rows, ldq] int8 (ldq >= C,
// ldq % 4 == 0; zero past C and in rows M..rows-1), s [rows] f32 (zero past
// M). Launches on `stream`; returns cudaGetLastError().
extern "C" int hirest_row_quant(const void* x, void* q, void* s, int M,
                                int rows, int C, long long ldx, int ldq,
                                void* stream) {
  return (int)row_quant<__nv_bfloat16>(x, q, s, M, rows, C, ldx, ldq,
                                       (cudaStream_t)stream);
}

// E4 on f32 rows (16-byte aligned); otherwise as hirest_row_quant.
extern "C" int hirest_row_quant_f32(const void* x, void* q, void* s, int M,
                                    int rows, int C, long long ldx, int ldq,
                                    void* stream) {
  return (int)row_quant<float>(x, q, s, M, rows, C, ldx, ldq,
                               (cudaStream_t)stream);
}

extern "C" const char* hirest_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
