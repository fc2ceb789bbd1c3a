// K6, K7 and K8: softmax attention over split-heads or packed-heads bf16
// tensors, with bf16 output, or with an int8 row-quantization epilogue.
//
// Replaces hirest_tpu/ops/attention.py::_pallas_attention (K6, kernel
// bodies _attn_kernel and _attn_kernel_masked), _pallas_attention_packed
// (K7, bodies _attn_kernel_packed and _attn_kernel_packed_masked) and
// fused_attention_qkv (K8, v1, bodies _attn_kernel_qkvfused and
// _attn_kernel_qkvfused_quant). All three compute, for each (b, h), over
// keys j < Sk with valid(j) = (no mask, or mask[b, j] != 0):
//   q   = bf16(q + q_bias),  v = bf16(v + v_bias)    K8 only: bf16 adds
//   s   = (q k^T in f32) * scale;   s[:, j] = -1e30 where !valid(j)
//   m   = rowmax(s),   l = sum_j exp(s - m)          f32
//   p   = bf16(exp(s - m) / l)                       normalised, then rounded
//   o   = p v accumulated in f32
// and write bf16(o), or (K8's quant_out) quantize each token's whole H*D
// row of f32 o: sc = max(max|o| / 127, 1e-8), q = clamp(rint(o / sc), +-127).
// The kernel takes element strides of [B, H, S, D] views of q, k, v and o,
// so K6's split-heads views of one qkv projection, K7's packed [B, S, H*D]
// tensors and K8's q, k and v thirds of one fused [B, S, 3*H*D] projection
// are the same launch, and none needs a copy.
//
// Bound on an H100 SXM: K6 on the unrolled EVA-g tower, [128, 16, 257, 88]:
// q, k and v read and o written, 4 x 92.6 MB = 370.5 MB, 111 us at
// 3.35 TB/s, against 48 us for 47.6 GFLOP of QK^T and PV at 989 TFLOP/s.
// K8 moves the same bytes (its biases are 5.6 KB); with quant_out it writes
// 46.3 MB of codes and 0.13 MB of scales instead of o: 324.3 MB, 97 us.
// K7 on the padded tower, [128, 257, 16 * 128]: 4 x 134.7 MB = 539 MB,
// 161 us, against 70 us for 69.3 GFLOP. All are bound by memory.
//
// Design (simple first version, K1's layout; no TMA, wgmma or pipelining):
// - One block per (b, h), 8 warps. The block stages k_h row-major, v_h
//   transposed and the keys' validity in shared memory (106,944 bytes at
//   Sk=257, d=88: two blocks an SM; 146,752 at d=128: one), so every input
//   byte is read from device memory once.
// - Each warp walks 16-row query tiles; q fragments go from device memory
//   straight into registers. QK^T and PV run on mma.sync m16n8k16.
// - K8's biases are added as the operands arrive, rounded to bf16 as the
//   reference adds them: q's to the fragments as they are loaded, v's to
//   each 16-byte vector before it is staged. So the biased q and v never
//   exist in device memory.
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
// - K8's int8 epilogue is K3's (rowquant.cuh): each block parks its f32
//   head output in an [B*Sq, H*D] workspace and folds the rows' max |o|
//   into a row maximum with atomicMax; a second kernel quantizes the rows.
//   The workspace costs 370 MB of traffic more than the bound counts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "rowquant.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr size_t kMaxSmem = 232448;  // what one block may have on Hopper

struct Strides {  // element strides (batch, head, row) of the [B, H, S, D] views
  long long q[3], k[3], v[3], o[3];
};

struct Args {
  const __nv_bfloat16 *q, *k, *v;
  const int* mask;                    // null, or [B, Sk]: nonzero marks a valid key
  const __nv_bfloat16 *qbias, *vbias;  // null, or [H * D] each (K8)
  __nv_bfloat16* o;                   // bf16 output (through its strides)
  float* ws;                          // or quant_out: the f32 workspace [B * Sq, H * D]
  unsigned int* rowmax;               // and its row maxima [B * Sq]
  int B, H, Sq, Sk;
  Strides st;
  float scale;
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

// kBias: K8's q/v biases are added. A compile-time choice, so that K6 and
// K7 carry no bias code: with the biases a runtime option they ran 8 % and
// 12 % slower (PERF.md).
template <int D, bool kBias, bool kQuant>
__global__ void __launch_bounds__(kThreads, D > 96 ? 1 : 2)
    attention_split_kernel(const Args a) {
  using T = Tile<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Sq = a.Sq, Sk = a.Sk;
  const Strides& st = a.st;
  const int s_pad = round_up16(Sk);
  const int vt_stride = s_pad + 8;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vt = ks + s_pad * T::kKStride;  // [D][vt_stride]
  // per key: 1 valid, 0 masked (score -1e30), -1 past Sk (left out)
  int* keep = reinterpret_cast<int*>(vt + D * vt_stride);

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const __nv_bfloat16* qg = a.q + b * st.q[0] + h * st.q[1];
  const __nv_bfloat16* kg = a.k + b * st.k[0] + h * st.k[1];
  const __nv_bfloat16* vg = a.v + b * st.v[0] + h * st.v[1];
  const __nv_bfloat16* qb = kBias ? a.qbias + h * D : nullptr;
  const __nv_bfloat16* vb = kBias ? a.vbias + h * D : nullptr;

  stage_kv<D, kThreads>(ks, vt, kg, st.k[2], vg, st.v[2], Sk, s_pad,
                        vt_stride, vb);
  for (int j = threadIdx.x; j < s_pad; j += kThreads)
    keep[j] = j >= Sk ? -1
                      : (a.mask == nullptr || a.mask[(size_t)b * Sk + j] != 0);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const float scale = a.scale;

  for (int qt = warp; qt * 16 < Sq; qt += kWarps) {
    const int r0 = qt * 16 + g, r1 = r0 + 8;
    uint32_t qa[T::kChunks][4];
    load_q<D>(qa, qg, st.q[2], r0, Sq, t, qb);

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

    if constexpr (kQuant) {
      const size_t hd = (size_t)a.H * D;
      float* w0 = a.ws + ((size_t)b * Sq + r0) * hd + h * D + 2 * t;
      unsigned int* mx = a.rowmax + (size_t)b * Sq + r0;
      park_f32_tile<T::kOTiles>(acc, w0, w0 + 8 * hd, r0 < Sq, r1 < Sq, mx,
                                mx + 8, t);
    } else {
      __nv_bfloat16* og = a.o + b * st.o[0] + h * st.o[1];
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
}

template <int D, bool kBias, bool kQuant>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(a.Sk);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_split_kernel<D, kBias, kQuant>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attention_split_kernel<D, kBias, kQuant>
      <<<a.B * a.H, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kBias, bool kQuant>
cudaError_t launch_width(const Args& a, int D, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<64, kBias, kQuant>(a, stream);
    case 88:
      return launch<88, kBias, kQuant>(a, stream);
    case 128:
      return launch<128, kBias, kQuant>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// Both biases, or neither.
bool bad_biases(const void* qbias, const void* vbias) {
  return (qbias == nullptr) != (vbias == nullptr);
}

// The arguments both entry points share; strides holds the (batch, head,
// row) element strides of q, k, v and (bf16 output only) o, in that order.
Args make_args(const void* q, const void* k, const void* v, const void* mask,
               const void* qbias, const void* vbias, int B, int H, int Sq,
               int Sk, const long long* strides, int n_strides, float scale) {
  Args a = {};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.mask = static_cast<const int*>(mask);
  a.qbias = static_cast<const __nv_bfloat16*>(qbias);
  a.vbias = static_cast<const __nv_bfloat16*>(vbias);
  a.B = B;
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.scale = scale;
  long long* all[4] = {a.st.q, a.st.k, a.st.v, a.st.o};
  for (int i = 0; i < n_strides; ++i) all[i / 3][i % 3] = strides[i];
  return a;
}

}  // namespace

// q [B, H, Sq, D], k and v [B, H, Sk, D], o [B, H, Sq, D]: bf16 views with
// unit stride along D and 16-byte aligned rows; `strides` holds the
// (batch, head, row) element strides of q, k, v and o in that order. mask is
// null or int32 [B, Sk] (nonzero marks a valid key). qbias and vbias are
// both null, or both bf16 [H * D], 16-byte aligned, added to q and v (K8).
// D = 64, 88 or 128; Sk up to what shared memory holds. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int hirest_attention_split(const void* q, const void* k,
                                      const void* v, const void* mask,
                                      const void* qbias, const void* vbias,
                                      void* o, int B, int H, int Sq, int Sk,
                                      int D, const long long* strides,
                                      float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || bad_biases(qbias, vbias))
    return (int)cudaErrorInvalidValue;
  Args a = make_args(q, k, v, mask, qbias, vbias, B, H, Sq, Sk, strides, 12,
                     scale);
  a.o = static_cast<__nv_bfloat16*>(o);
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(qbias != nullptr ? launch_width<true, false>(a, D, st)
                                : launch_width<false, false>(a, D, st));
}

// As above with the int8 epilogue instead of o (K8's quant_out, so the
// biases are required): codes [B, Sq, H*D] int8 and scales [B, Sq] f32
// out; ws [B, Sq, H*D] f32 and rowmax [B, Sq] (4 bytes each) are scratch.
// `strides` holds q's, k's and v's only. Zeroes rowmax and launches both
// steps on `stream`.
extern "C" int hirest_attention_split_quant(
    const void* q, const void* k, const void* v, const void* mask,
    const void* qbias, const void* vbias, void* ws, void* rowmax, void* codes,
    void* scales, int B, int H, int Sq, int Sk, int D,
    const long long* strides, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || (H * D) % 4 ||
      qbias == nullptr || vbias == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  Args a = make_args(q, k, v, mask, qbias, vbias, B, H, Sq, Sk, strides, 9,
                     scale);
  a.ws = static_cast<float*>(ws);
  a.rowmax = static_cast<unsigned int*>(rowmax);
  const int rows = B * Sq;
  cudaError_t err = cudaMemsetAsync(rowmax, 0, sizeof(unsigned int) * rows, st);
  if (err != cudaSuccess) return (int)err;
  err = launch_width<true, true>(a, D, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_quant_rows(a.ws, a.rowmax, codes, scales, rows, H * D, st);
}

extern "C" const char* hirest_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
