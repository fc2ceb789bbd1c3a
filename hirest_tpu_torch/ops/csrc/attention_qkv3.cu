// K1 and K3: batched-heads softmax attention over fused, bias-complete qkv
// rows, with bf16 output (K1) or an int8 row-quantization epilogue (K3).
// K9 launches the same entry points.
//
// Replaces hirest_tpu/ops/attention.py::fused_attention_qkv3 (kernel bodies
// _attn_heads_batched via _attn_kernel_qkv3, and _attn_kernel_qkv3_quant
// with the pad-key mask _mask_pad_keys), and fused_attention_qkv2 (K9,
// bodies _attn_kernel_qkv2 and _attn_kernel_qkv2_quant), which computes the
// same function one head at a time: the loop over heads is TPU scheduling,
// and this kernel's blocks are already one per (b, h). For each (b, h),
// with q/k/v the head-h column slices of qkv[b] and n_keys = min(n_real, S)
// (S when n_real is 0):
//   s   = q k^T            f32, unscaled; keys >= n_keys excluded
//   m   = rowmax(s)
//   p   = bf16(exp2((s - m) * c)),  c = scale * log2(e)
//   den = sum(float(p))     f32
//   o   = (p v accumulated in f32) / den
// K1 writes out[b, :, h*D:(h+1)*D] = bf16(o). The reference masks keys >=
// n_real to -1e30 before the row max, which makes their p exactly 0; leaving
// them out of the max and the sums gives the same bits.
// K3 quantizes each token's whole H*D row of f32 o (all heads, never rounded
// to bf16): sc = max(max|o| / 127, 1e-8), q = clamp(rint(o / sc), +-127).
//
// Bound on an H100 SXM (EVA-g, B=128, S=257, H=16, D=88): the call reads
// qkv [128, 257, 4224] bf16 (278 MB) and writes [128, 257, 1408] bf16
// (93 MB; K3: 46 MB of int8 and 0.13 MB of scales): 111 us (K3: 97 us) at
// 3.35 TB/s, against 48 us for its 47.6 GFLOP of QK^T and PV at the
// 989 TFLOP/s dense bf16 rate. It is bound by memory. At the padded head
// width (models/eva_pad.py: H=16, D=128) it reads 404 MB and writes 135 MB
// (K3: 67 MB of int8): 161 us (K3: 141 us), against 70 us for 69.3 GFLOP.
//
// Design (simple first version; no TMA, wgmma or pipelining):
// - One block per (b, h), 8 warps. The block stages k_h row-major and v_h
//   transposed in shared memory (about 105 KB at S=257, so two blocks fit on
//   an SM), so each byte of qkv is read from device memory once and each
//   output byte written once: the traffic is the bound's.
// - Each warp walks 16-row query tiles. Its q fragments come straight from
//   device memory into registers; d is zero-padded from 88 to 96. At
//   d=128 K and V^T take 145,664 bytes, so one block fits on an SM.
// - QK^T and PV run on the tensor cores with mma.sync m16n8k16 (bf16 in,
//   f32 accumulate). The row max is taken in a first pass over all keys and
//   the scores are recomputed in the second pass, so p is rounded to bf16
//   against the final row max exactly as the reference does (no online
//   rescaling). This spends a second QK^T to keep the reference's numbers.
// - Staging and compute do not overlap inside a block; the second resident
//   block on the SM is what hides the loads.
// - K3's row scale needs all 16 heads of a row, which 16 different blocks
//   compute. Each block writes its f32 head output to a [B, S, H*D] workspace
//   and folds its per-row max |o| into a zeroed [B, S] buffer with atomicMax
//   on the bits of the non-negative float (monotone as unsigned integers).
//   A second kernel then quantizes the workspace rows (rowquant.cuh, shared
//   with K8's epilogue in attention_split.cu). This moves 370 MB more than
//   the bound counts; a 16-block cluster reducing the row max in distributed
//   shared memory would not.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "rowquant.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

template <int D>
size_t smem_bytes(int S) {
  const int s_pad = round_up16(S);
  return sizeof(__nv_bfloat16) *
         ((size_t)s_pad * Tile<D>::kKStride + (size_t)D * (s_pad + 8));
}

__device__ __forceinline__ __nv_bfloat16 prob(float s, float m, float c,
                                              bool valid) {
  return __float2bfloat16_rn(valid ? exp2f((s - m) * c) : 0.f);
}

// Two blocks an SM at d=88 (105,856 bytes of shared memory each); at d=128
// one block fits, which leaves it all 255 registers.
template <int D, bool kQuant>
__global__ void __launch_bounds__(kThreads, D > 96 ? 1 : 2)
    attention_qkv3_kernel(const __nv_bfloat16* __restrict__ qkv,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ ws,
                          unsigned int* __restrict__ rowmax, int S, int H,
                          int n_keys, float c) {
  using T = Tile<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int s_pad = round_up16(S);
  const int vt_stride = s_pad + 8;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vt = ks + s_pad * T::kKStride;  // [D][vt_stride]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hd = H * D;
  const long long row_stride = 3 * (long long)hd;
  const __nv_bfloat16* base = qkv + (size_t)b * S * row_stride;
  const __nv_bfloat16* qg = base + h * D;
  const __nv_bfloat16* kg = base + hd + h * D;
  const __nv_bfloat16* vg = base + 2 * hd + h * D;

  // Stage k_h (row-major, keys S..s_pad zero) and v_h^T (keys S..s_pad zero).
  stage_kv<D, kThreads>(ks, vt, kg, row_stride, vg, row_stride, S, s_pad,
                        vt_stride);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int key_tiles = s_pad / 8;

  for (int qt = warp; qt * 16 < S; qt += kWarps) {
    const int r0 = qt * 16 + g, r1 = r0 + 8;
    // q fragments (A operand, row-major 16x16 per d-chunk), zero past S / D.
    uint32_t qa[T::kChunks][4];
    load_q<D>(qa, qg, row_stride, r0, S, t);

    // Pass 1: row max over the real keys.
    float m0 = -INFINITY, m1 = -INFINITY;
    for (int nt = 0; nt < key_tiles; ++nt) {
      float s[4];
      qk_tile<D>(s, qa, ks, nt, g, t);
      const int key = nt * 8 + 2 * t;
      if (key < n_keys) {
        m0 = fmaxf(m0, s[0]);
        m1 = fmaxf(m1, s[2]);
      }
      if (key + 1 < n_keys) {
        m0 = fmaxf(m0, s[1]);
        m1 = fmaxf(m1, s[3]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }

    // Pass 2: p = bf16(exp2((s - m) c)), den += p, o += p v.
    float o[T::kOTiles][4];
#pragma unroll
    for (int dt = 0; dt < T::kOTiles; ++dt)
      o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
    float l0 = 0.f, l1 = 0.f;
    for (int kb = 0; kb < s_pad / 16; ++kb) {
      float sa[4], sb[4];
      qk_tile<D>(sa, qa, ks, 2 * kb, g, t);
      qk_tile<D>(sb, qa, ks, 2 * kb + 1, g, t);
      const int key = kb * 16 + 2 * t;
      const __nv_bfloat16 p0 = prob(sa[0], m0, c, key < n_keys);
      const __nv_bfloat16 p1 = prob(sa[1], m0, c, key + 1 < n_keys);
      const __nv_bfloat16 p2 = prob(sa[2], m1, c, key < n_keys);
      const __nv_bfloat16 p3 = prob(sa[3], m1, c, key + 1 < n_keys);
      const __nv_bfloat16 p4 = prob(sb[0], m0, c, key + 8 < n_keys);
      const __nv_bfloat16 p5 = prob(sb[1], m0, c, key + 9 < n_keys);
      const __nv_bfloat16 p6 = prob(sb[2], m1, c, key + 8 < n_keys);
      const __nv_bfloat16 p7 = prob(sb[3], m1, c, key + 9 < n_keys);
      l0 += __bfloat162float(p0) + __bfloat162float(p1) +
            __bfloat162float(p4) + __bfloat162float(p5);
      l1 += __bfloat162float(p2) + __bfloat162float(p3) +
            __bfloat162float(p6) + __bfloat162float(p7);
      // The score tiles' C layout is the A layout of the PV product.
      const uint32_t pa[4] = {pack_bf16(p0, p1), pack_bf16(p2, p3),
                              pack_bf16(p4, p5), pack_bf16(p6, p7)};
#pragma unroll
      for (int dt = 0; dt < T::kOTiles; ++dt) {
        const __nv_bfloat16* vrow = vt + (dt * 8 + g) * vt_stride + kb * 16 + 2 * t;
        mma_bf16(o[dt], pa, ld_u32(vrow), ld_u32(vrow + 8));
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }

    if constexpr (kQuant) {
#pragma unroll
      for (int dt = 0; dt < T::kOTiles; ++dt) {
        o[dt][0] = __fdiv_rn(o[dt][0], l0);
        o[dt][1] = __fdiv_rn(o[dt][1], l0);
        o[dt][2] = __fdiv_rn(o[dt][2], l1);
        o[dt][3] = __fdiv_rn(o[dt][3], l1);
      }
      float* w0 = ws + ((size_t)b * S + r0) * hd + h * D + 2 * t;
      unsigned int* m0 = rowmax + (size_t)b * S + r0;
      park_f32_tile<T::kOTiles>(o, w0, w0 + 8 * (size_t)hd, r0 < S, r1 < S,
                                m0, m0 + 8, t);
    } else {
      __nv_bfloat16* o0 = out + ((size_t)b * S + r0) * hd + h * D + 2 * t;
      __nv_bfloat16* o1 = o0 + 8 * (size_t)hd;
#pragma unroll
      for (int dt = 0; dt < T::kOTiles; ++dt) {
        if (r0 < S)
          *reinterpret_cast<uint32_t*>(o0 + dt * 8) =
              pack_bf16(__float2bfloat16_rn(o[dt][0] / l0),
                        __float2bfloat16_rn(o[dt][1] / l0));
        if (r1 < S)
          *reinterpret_cast<uint32_t*>(o1 + dt * 8) =
              pack_bf16(__float2bfloat16_rn(o[dt][2] / l1),
                        __float2bfloat16_rn(o[dt][3] / l1));
      }
    }
  }
}

template <int D, bool kQuant>
cudaError_t launch_attention(const void* qkv, void* out, float* ws,
                             unsigned int* rowmax, int B, int S, int H,
                             int n_keys, float c, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(S);
  cudaError_t err = cudaFuncSetAttribute(
      attention_qkv3_kernel<D, kQuant>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attention_qkv3_kernel<D, kQuant><<<B * H, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<__nv_bfloat16*>(out), ws, rowmax, S, H, n_keys, c);
  return cudaGetLastError();
}

// The head widths the kernel is built for: EVA-g's 88, and 128 for the
// padded heads of models/eva_pad.py.
template <bool kQuant>
cudaError_t launch_attention(const void* qkv, void* out, float* ws,
                             unsigned int* rowmax, int B, int S, int H, int D,
                             int n_keys, float c, cudaStream_t stream) {
  if (D == 88)
    return launch_attention<88, kQuant>(qkv, out, ws, rowmax, B, S, H, n_keys,
                                        c, stream);
  return launch_attention<128, kQuant>(qkv, out, ws, rowmax, B, S, H, n_keys,
                                       c, stream);
}

bool bad_shape(int B, int S, int H, int D, int n_keys) {
  return (D != 88 && D != 128) || B <= 0 || S <= 0 || H <= 0 || n_keys <= 0 ||
         n_keys > S;
}

}  // namespace

// qkv [B, S, 3*H*D] bf16 contiguous, biases pre-added, D = 88 or 128;
// out [B, S, H*D] bf16.
// Keys >= n_keys (1 <= n_keys <= S) are left out. c = scale * log2(e).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int hirest_attention_qkv3_bf16(const void* qkv, void* out, int B,
                                          int S, int H, int D, int n_keys,
                                          float c, void* stream) {
  if (bad_shape(B, S, H, D, n_keys)) return (int)cudaErrorInvalidValue;
  return (int)launch_attention<false>(qkv, out, nullptr, nullptr, B, S, H, D,
                                      n_keys, c, (cudaStream_t)stream);
}

// As above with the int8 epilogue: q [B, S, H*D] int8 and s [B, S] f32 out;
// ws [B, S, H*D] f32 and rowmax [B, S] (4 bytes each) are scratch. Zeroes
// rowmax and launches both steps on `stream`.
extern "C" int hirest_attention_qkv3_quant(const void* qkv, void* ws,
                                           void* rowmax, void* q, void* s,
                                           int B, int S, int H, int D,
                                           int n_keys, float c, void* stream) {
  if (bad_shape(B, S, H, D, n_keys)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int rows = B * S;
  cudaError_t err = cudaMemsetAsync(rowmax, 0, sizeof(unsigned int) * rows, st);
  if (err != cudaSuccess) return (int)err;
  err = launch_attention<true>(qkv, nullptr, static_cast<float*>(ws),
                               static_cast<unsigned int*>(rowmax), B, S, H, D,
                               n_keys, c, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_quant_rows(static_cast<const float*>(ws),
                                static_cast<const unsigned int*>(rowmax), q, s,
                                rows, H * D, st);
}

extern "C" const char* hirest_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
