// K6 and K7: softmax attention over split-heads or packed-heads bf16 tensors.
//
// Replaces hirest_tpu/ops/attention.py::_pallas_attention (K6, kernel
// bodies _attn_kernel and _attn_kernel_masked) and _pallas_attention_packed
// (K7, bodies _attn_kernel_packed and _attn_kernel_packed_masked). Both
// compute, for each (b, h), over keys j < Sk with valid(j) = (no mask, or
// mask[b, j] != 0):
//   s   = (q k^T in f32) * scale;   s[:, j] = -1e30 where !valid(j)
//   m   = rowmax(s),   l = sum_j exp(s - m)          f32
//   p   = bf16(exp(s - m) / l)                       normalised, then rounded
//   o   = bf16(p v accumulated in f32)
// The kernel takes element strides of [B, H, S, D] views of q, k, v and o,
// so K6's split-heads views of one qkv projection and K7's packed
// [B, S, H*D] tensors are the same launch, and neither needs a copy.
//
// Bound on an H100 SXM: K6 on the unrolled EVA-g tower, [128, 16, 257, 88]:
// q, k and v read and o written, 4 x 92.6 MB = 370.5 MB, 111 us at
// 3.35 TB/s, against 48 us for 47.6 GFLOP of QK^T and PV at 989 TFLOP/s.
// K7 on the padded tower, [128, 257, 16 * 128]: 4 x 134.7 MB = 539 MB,
// 161 us, against 70 us for 69.3 GFLOP. Both are bound by memory.
//
// Design (simple first version, K1's layout; no TMA, wgmma or pipelining):
// - One block per (b, h), 8 warps. The block stages k_h row-major, v_h
//   transposed and the keys' validity in shared memory (106,944 bytes at
//   Sk=257, d=88: two blocks an SM; 146,752 at d=128: one), so every input
//   byte is read from device memory once.
// - Each warp walks 16-row query tiles; q fragments go from device memory
//   straight into registers. QK^T and PV run on mma.sync m16n8k16.
// - p is normalised in f32 before it is rounded to bf16, so the row sum is
//   needed before the PV product. Pass 1 folds each score into a running
//   (max, sum of exp) and merges the lanes' pairs at the end; pass 2
//   recomputes the scores, forms p = bf16(exp(s - m) / l) with a correctly
//   rounded division, and feeds it from registers into PV. The online sum
//   differs from the reference's sum against the final max by a few f32
//   roundings, as another summation order would.
// - The product s * scale is rounded before the max is subtracted
//   (__fmul_rn), as the reference rounds it, and never contracted into an
//   FMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr size_t kMaxSmem = 232448;  // what one block may have on Hopper

struct Strides {  // element strides (batch, head, row) of the [B, H, S, D] views
  long long q[3], k[3], v[3], o[3];
};

template <int D>
size_t smem_bytes(int Sk) {
  const int s_pad = round_up16(Sk);
  return sizeof(__nv_bfloat16) *
             ((size_t)s_pad * Tile<D>::kKStride + (size_t)D * (s_pad + 8)) +
         sizeof(int) * s_pad;
}

// A score as the reference sees it: scaled, or -1e30 for a masked key.
__device__ __forceinline__ float scaled(float s, float scale, int keep) {
  return keep ? __fmul_rn(s, scale) : -1e30f;
}

// Fold two scores of one row, each counted only if its key exists (keep
// >= 0), into a running max m and sum l of exp(s - m). The sum is rescaled
// only when the max grows, so most scores cost one expf.
__device__ __forceinline__ void fold(float& m, float& l, float a, int ka,
                                     float b, int kb) {
  const float t = fmaxf(ka >= 0 ? a : -INFINITY, kb >= 0 ? b : -INFINITY);
  if (t == -INFINITY) return;
  if (t > m) {
    l *= expf(m - t);  // 0 while m is still -inf
    m = t;
  }
  l += (ka >= 0 ? expf(a - m) : 0.f) + (kb >= 0 ? expf(b - m) : 0.f);
}

// Merge the (max, sum) pairs of the four lanes that hold one row.
__device__ __forceinline__ void merge_quad(float& m, float& l) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float lo = __shfl_xor_sync(0xffffffffu, l, off);
    const float mn = fmaxf(m, mo);
    if (mn != -INFINITY) {
      l = l * expf(m - mn) + lo * expf(mo - mn);
      m = mn;
    }
  }
}

__device__ __forceinline__ __nv_bfloat16 prob(float s, float scale, int keep,
                                              float m, float l) {
  if (keep < 0) return __float2bfloat16_rn(0.f);
  return __float2bfloat16_rn(__fdiv_rn(expf(scaled(s, scale, keep) - m), l));
}

template <int D>
__global__ void __launch_bounds__(kThreads, D > 96 ? 1 : 2)
    attention_split_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const int* __restrict__ mask,
                           __nv_bfloat16* __restrict__ o, int H, int Sq,
                           int Sk, Strides st, float scale) {
  using T = Tile<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int s_pad = round_up16(Sk);
  const int vt_stride = s_pad + 8;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vt = ks + s_pad * T::kKStride;  // [D][vt_stride]
  // per key: 1 valid, 0 masked (score -1e30), -1 past Sk (left out)
  int* keep = reinterpret_cast<int*>(vt + D * vt_stride);

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const __nv_bfloat16* qg = q + b * st.q[0] + h * st.q[1];
  const __nv_bfloat16* kg = k + b * st.k[0] + h * st.k[1];
  const __nv_bfloat16* vg = v + b * st.v[0] + h * st.v[1];
  __nv_bfloat16* og = o + b * st.o[0] + h * st.o[1];

  stage_kv<D, kThreads>(ks, vt, kg, st.k[2], vg, st.v[2], Sk, s_pad,
                        vt_stride);
  for (int j = threadIdx.x; j < s_pad; j += kThreads)
    keep[j] = j >= Sk ? -1 : (mask == nullptr || mask[(size_t)b * Sk + j] != 0);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  for (int qt = warp; qt * 16 < Sq; qt += kWarps) {
    const int r0 = qt * 16 + g, r1 = r0 + 8;
    uint32_t qa[T::kChunks][4];
    load_q<D>(qa, qg, st.q[2], r0, Sq, t);

    // Pass 1: running row max and sum of exp over the keys that exist.
    float m0 = -INFINITY, l0 = 0.f, m1 = -INFINITY, l1 = 0.f;
    for (int nt = 0; nt < s_pad / 8; ++nt) {
      float s[4];
      qk_tile<D>(s, qa, ks, nt, g, t);
      const int k0 = keep[nt * 8 + 2 * t], k1 = keep[nt * 8 + 2 * t + 1];
      fold(m0, l0, scaled(s[0], scale, k0), k0, scaled(s[1], scale, k1), k1);
      fold(m1, l1, scaled(s[2], scale, k0), k0, scaled(s[3], scale, k1), k1);
    }
    merge_quad(m0, l0);
    merge_quad(m1, l1);

    // Pass 2: p = bf16(exp(s - m) / l), o += p v.
    float acc[T::kOTiles][4];
#pragma unroll
    for (int dt = 0; dt < T::kOTiles; ++dt)
      acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
    for (int kb = 0; kb < s_pad / 16; ++kb) {
      float sa[4], sb[4];
      qk_tile<D>(sa, qa, ks, 2 * kb, g, t);
      qk_tile<D>(sb, qa, ks, 2 * kb + 1, g, t);
      const int key = kb * 16 + 2 * t;
      const int ka0 = keep[key], ka1 = keep[key + 1];
      const int kb0 = keep[key + 8], kb1 = keep[key + 9];
      // The score tiles' C layout is the A layout of the PV product.
      const uint32_t pa[4] = {
          pack_bf16(prob(sa[0], scale, ka0, m0, l0),
                    prob(sa[1], scale, ka1, m0, l0)),
          pack_bf16(prob(sa[2], scale, ka0, m1, l1),
                    prob(sa[3], scale, ka1, m1, l1)),
          pack_bf16(prob(sb[0], scale, kb0, m0, l0),
                    prob(sb[1], scale, kb1, m0, l0)),
          pack_bf16(prob(sb[2], scale, kb0, m1, l1),
                    prob(sb[3], scale, kb1, m1, l1))};
#pragma unroll
      for (int dt = 0; dt < T::kOTiles; ++dt) {
        const __nv_bfloat16* vrow = vt + (dt * 8 + g) * vt_stride + kb * 16 + 2 * t;
        mma_bf16(acc[dt], pa, ld_u32(vrow), ld_u32(vrow + 8));
      }
    }

    __nv_bfloat16* o0 = og + r0 * st.o[2] + 2 * t;
    __nv_bfloat16* o1 = og + r1 * st.o[2] + 2 * t;
#pragma unroll
    for (int dt = 0; dt < T::kOTiles; ++dt) {
      if (r0 < Sq)
        *reinterpret_cast<uint32_t*>(o0 + dt * 8) =
            pack_bf16(__float2bfloat16_rn(acc[dt][0]),
                      __float2bfloat16_rn(acc[dt][1]));
      if (r1 < Sq)
        *reinterpret_cast<uint32_t*>(o1 + dt * 8) =
            pack_bf16(__float2bfloat16_rn(acc[dt][2]),
                      __float2bfloat16_rn(acc[dt][3]));
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, void* o, int B, int H, int Sq, int Sk,
                   const Strides& st, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(Sk);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_split_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  attention_split_kernel<D><<<B * H, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(mask),
      static_cast<__nv_bfloat16*>(o), H, Sq, Sk, st, scale);
  return cudaGetLastError();
}

}  // namespace

// q [B, H, Sq, D], k and v [B, H, Sk, D], o [B, H, Sq, D]: bf16 views with
// unit stride along D and 16-byte aligned rows; `strides` holds the
// (batch, head, row) element strides of q, k, v and o in that order. mask is
// null or int32 [B, Sk] (nonzero marks a valid key). D = 64, 88 or 128; Sk
// up to what shared memory holds. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int hirest_attention_split(const void* q, const void* k,
                                      const void* v, const void* mask, void* o,
                                      int B, int H, int Sq, int Sk, int D,
                                      const long long* strides, float scale,
                                      void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 64:
      return (int)launch<64>(q, k, v, mask, o, B, H, Sq, Sk, st, scale, s);
    case 88:
      return (int)launch<88>(q, k, v, mask, o, B, H, Sq, Sk, st, scale, s);
    case 128:
      return (int)launch<128>(q, k, v, mask, o, B, H, Sq, Sk, st, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* hirest_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
