// K1: batched-heads softmax attention over fused, bias-complete qkv rows.
//
// Replaces hirest_tpu/ops/attention.py::fused_attention_qkv3 with bf16 output
// and no pad mask (kernel body _attn_heads_batched via _attn_kernel_qkv3).
// For each (b, h), with q/k/v the head-h column slices of qkv[b]:
//   s   = q k^T            f32, unscaled
//   m   = rowmax(s)
//   p   = bf16(exp2((s - m) * c)),  c = scale * log2(e)
//   den = sum(float(p))     f32
//   out[b, :, h*D:(h+1)*D] = bf16((p v accumulated in f32) / den)
//
// Bound on an H100 SXM (EVA-g, B=128, S=257, H=16, D=88): the call reads
// qkv [128, 257, 4224] bf16 (278 MB) and writes [128, 257, 1408] bf16
// (93 MB): 111 us at 3.35 TB/s, against 48 us for its 47.6 GFLOP of QK^T and
// PV at the 989 TFLOP/s dense bf16 rate. It is bound by memory.
//
// Design (simple first version; no TMA, wgmma or pipelining):
// - One block per (b, h), 8 warps. The block stages k_h row-major and v_h
//   transposed in shared memory (about 105 KB at S=257, so two blocks fit on
//   an SM), so each byte of qkv is read from device memory once and each
//   output byte written once: the traffic is the bound's.
// - Each warp walks 16-row query tiles. Its q fragments come straight from
//   device memory into registers; d is zero-padded from 88 to 96.
// - QK^T and PV run on the tensor cores with mma.sync m16n8k16 (bf16 in,
//   f32 accumulate). The row max is taken in a first pass over all keys and
//   the scores are recomputed in the second pass, so p is rounded to bf16
//   against the final row max exactly as the reference does (no online
//   rescaling). This spends a second QK^T to keep the reference's numbers.
// - Staging and compute do not overlap inside a block; the second resident
//   block on the SM is what hides the loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

template <int D>
struct Tile {
  static_assert(D % 8 == 0, "head width must be a multiple of 8");
  static constexpr int kChunks = (D + 15) / 16;  // k-steps of QK^T over d
  static constexpr int kDPad = kChunks * 16;     // d zero-padded for QK^T
  static constexpr int kKStride = kDPad + 8;     // bank-conflict-free rows
  static constexpr int kOTiles = D / 8;          // n-tiles of the PV product
  static constexpr int kVecs = D / 8;            // 16-byte vectors per slice
};

__host__ __device__ constexpr int round_up16(int x) { return (x + 15) & ~15; }

template <int D>
size_t smem_bytes(int S) {
  const int s_pad = round_up16(S);
  return sizeof(__nv_bfloat16) *
         ((size_t)s_pad * Tile<D>::kKStride + (size_t)D * (s_pad + 8));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One 16x8 tile of scores: query rows of the warp's tile against keys
// [8*nt, 8*nt + 8). Lane (g, t) holds rows g and g+8, keys 2t and 2t+1.
template <int D>
__device__ __forceinline__ void qk_tile(float (&s)[4],
                                        const uint32_t (&qa)[Tile<D>::kChunks][4],
                                        const __nv_bfloat16* ks, int nt, int g,
                                        int t) {
  s[0] = s[1] = s[2] = s[3] = 0.f;
  const __nv_bfloat16* krow = ks + (nt * 8 + g) * Tile<D>::kKStride + 2 * t;
#pragma unroll
  for (int kc = 0; kc < Tile<D>::kChunks; ++kc)
    mma_bf16(s, qa[kc], ld_u32(krow + kc * 16), ld_u32(krow + kc * 16 + 8));
}

__device__ __forceinline__ __nv_bfloat16 prob(float s, float m, float c,
                                              bool valid) {
  return __float2bfloat16_rn(valid ? exp2f((s - m) * c) : 0.f);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    attention_qkv3_kernel(const __nv_bfloat16* __restrict__ qkv,
                          __nv_bfloat16* __restrict__ out, int S, int H,
                          float c) {
  using T = Tile<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int s_pad = round_up16(S);
  const int vt_stride = s_pad + 8;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vt = ks + s_pad * T::kKStride;  // [D][vt_stride]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hd = H * D;
  const size_t row_stride = 3 * (size_t)hd;
  const __nv_bfloat16* base = qkv + (size_t)b * S * row_stride;
  const __nv_bfloat16* qg = base + h * D;
  const __nv_bfloat16* kg = base + hd + h * D;
  const __nv_bfloat16* vg = base + 2 * hd + h * D;

  // Stage k_h (row-major, keys S..s_pad zero) and v_h^T (keys S..s_pad zero).
  for (int i = threadIdx.x; i < s_pad * T::kVecs; i += kThreads) {
    const int r = i / T::kVecs, v = i % T::kVecs;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (r < S) {
      kv = *reinterpret_cast<const uint4*>(kg + r * row_stride + v * 8);
      vv = *reinterpret_cast<const uint4*>(vg + r * row_stride + v * 8);
    }
    *reinterpret_cast<uint4*>(ks + r * T::kKStride + v * 8) = kv;
    const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
    for (int j = 0; j < 8; ++j) vt[(v * 8 + j) * vt_stride + r] = ve[j];
  }
  // Zero k_h's padded columns D..kKStride (QK^T reads up to kDPad).
  constexpr int kPadCols = T::kKStride - D;
  for (int i = threadIdx.x; i < s_pad * kPadCols; i += kThreads)
    ks[(i / kPadCols) * T::kKStride + D + i % kPadCols] = __float2bfloat16(0.f);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int key_tiles = s_pad / 8;

  for (int qt = warp; qt * 16 < S; qt += kWarps) {
    const int r0 = qt * 16 + g, r1 = r0 + 8;
    // q fragments (A operand, row-major 16x16 per d-chunk), zero past S / D.
    uint32_t qa[T::kChunks][4];
#pragma unroll
    for (int kc = 0; kc < T::kChunks; ++kc) {
      const int c0 = kc * 16 + 2 * t, c1 = c0 + 8;
      qa[kc][0] = (r0 < S && c0 < D) ? ld_u32(qg + r0 * row_stride + c0) : 0u;
      qa[kc][1] = (r1 < S && c0 < D) ? ld_u32(qg + r1 * row_stride + c0) : 0u;
      qa[kc][2] = (r0 < S && c1 < D) ? ld_u32(qg + r0 * row_stride + c1) : 0u;
      qa[kc][3] = (r1 < S && c1 < D) ? ld_u32(qg + r1 * row_stride + c1) : 0u;
    }

    // Pass 1: row max over the real keys.
    float m0 = -INFINITY, m1 = -INFINITY;
    for (int nt = 0; nt < key_tiles; ++nt) {
      float s[4];
      qk_tile<D>(s, qa, ks, nt, g, t);
      const int key = nt * 8 + 2 * t;
      if (key < S) {
        m0 = fmaxf(m0, s[0]);
        m1 = fmaxf(m1, s[2]);
      }
      if (key + 1 < S) {
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
      const __nv_bfloat16 p0 = prob(sa[0], m0, c, key < S);
      const __nv_bfloat16 p1 = prob(sa[1], m0, c, key + 1 < S);
      const __nv_bfloat16 p2 = prob(sa[2], m1, c, key < S);
      const __nv_bfloat16 p3 = prob(sa[3], m1, c, key + 1 < S);
      const __nv_bfloat16 p4 = prob(sb[0], m0, c, key + 8 < S);
      const __nv_bfloat16 p5 = prob(sb[1], m0, c, key + 9 < S);
      const __nv_bfloat16 p6 = prob(sb[2], m1, c, key + 8 < S);
      const __nv_bfloat16 p7 = prob(sb[3], m1, c, key + 9 < S);
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

}  // namespace

// qkv [B, S, 3*H*D] bf16 contiguous, biases pre-added; out [B, S, H*D] bf16.
// c = scale * log2(e). Launches on `stream` and returns cudaGetLastError().
extern "C" int hirest_attention_qkv3_bf16(const void* qkv, void* out, int B,
                                          int S, int H, int D, float c,
                                          void* stream) {
  if (D != 88 || B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<88>(S);
  cudaError_t err = cudaFuncSetAttribute(
      attention_qkv3_kernel<88>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_qkv3_kernel<88><<<B * H, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out),
      S, H, c);
  return (int)cudaGetLastError();
}

extern "C" const char* hirest_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
