// Softmax attention in float32 on the CUDA cores: the f32 counterpart of
// K1, K6, K7, K8 and K9.
//
// Replaces, for f32 inputs, hirest_tpu/ops/attention.py::_pallas_attention
// (K6), _pallas_attention_packed (K7), fused_attention_qkv (K8, bf16-out
// form), fused_attention_qkv2 (K9) and fused_attention_qkv3 (K1), each of
// which the JAX package runs in whatever dtype it is given (the EVA-CLIP
// factory and the CLIP towers hand them f32). For each (b, h) it computes,
// over keys j < Sk with valid(j) = (no mask, or mask[b, j] != 0):
//   q   = q + q_bias,  v = v + v_bias        (optional, f32 adds)
//   s   = (q k^T) * scale;   s[:, j] = -1e30 where !valid(j)
//   o   = sum_j exp(s - m) v_j / sum_j exp(s - m),  m = rowmax(s)
// all in f32 with FFMA (no TF32: it would move the results by ~1e-3). The
// max and sum are taken online, a 64-key tile at a time, and the division
// comes after PV. The TPU kernels' two softmax forms (K1/K9's exp2 with the
// divide after PV, K6/K7/K8's normalised p) differ in f32 only in the order
// of roundings, ~1e-7 relative, so this one body serves all of them.
//
// The int8-out forms (K3, K9 and K8 with quant_out) take the same body and
// the attention kernels' two-step epilogue (rowquant.cuh): o is an f32
// [B, Sq, H*D] workspace, never rounded, and each block folds its rows'
// max |o| into rowmax[b * Sq + row] with atomicMax on the float's bits;
// then quant_rows_kernel writes the codes and the row scales (one scale
// over all heads of a row: max / 127 floored at 1e-8, round-half-even
// quotients clipped to +-127).
//
// Bound on an H100 SXM: ViT-B/32's [128, 12, 50, 64]: q, k, v read and o
// written, 4 x 19.7 MB = 78.6 MB, 0.023 ms at 3.35 TB/s, against 0.98
// GFLOP at 67 TFLOP/s of f32 FFMA (0.015 ms): bound by memory. EVA-g's
// [128, 16, 257, 88]: 47.6 GFLOP, 0.71 ms, against 370 MB, 0.11 ms: bound
// by operations.
//
// Design (a first version; it is meant to be right, not fast):
// - One block of 256 threads per (b, h, 64-query tile); grid (query tiles,
//   H, B). The Q tile (biased) stays in shared memory for the whole loop.
// - Keys go in tiles of 64 through one shared buffer, K first and then V
//   (biased), row stride D + 1 floats (conflict-free column reads).
// - Thread (rq, kq) = (tid / 16, tid % 16) owns 4 query rows 4 rq .. 4 rq
//   + 3. For scores it takes the 4 keys kq + 16 b of the tile (a 4 x 4
//   register tile: 8 shared loads per 16 FFMAs); the 16 threads of a row
//   group sit in one half-warp, so the row max and sum are shuffles. p goes
//   to shared memory; for PV the thread owns output columns kq + 16 i
//   (i < ceil(D / 16), guarded at D = 88) of its 4 rows.
// - Keys past Sk score -inf (left out); masked keys -1e30, as the reference
//   sets them, so a row whose keys are all masked gets a uniform p.

#include <cuda_runtime.h>
#include <math.h>

#include "rowquant.cuh"

namespace {

constexpr int kRows = 64;     // query rows a block
constexpr int kKeys = 64;     // keys a tile
constexpr int kThreads = 256;

struct Strides {
  long long q[3], k[3], v[3], o[3];  // (batch, head, row) element strides
};

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const int* mask;     // [B, Sk] or null
  const float* qbias;  // [H * D] or null
  const float* vbias;  // [H * D] or null
  float* o;
  unsigned int* rowmax;  // [B * Sq] for the int8 epilogue, or null
  int B, H, Sq, Sk;
  float scale;
  Strides st;
};

template <int D>
constexpr int smem_bytes() {
  return (2 * kRows * (D + 1) + kRows * (kKeys + 1)) * (int)sizeof(float);
}

// kQuant: the int8 epilogue's first step (each row's max |o| folded into
// a.rowmax); an instantiation of its own, so that the f32-out form keeps
// its registers.
template <int D, bool kQuant>
__global__ void __launch_bounds__(kThreads)
attention_f32_kernel(const Args a) {
  constexpr int LD = D + 1;
  constexpr int NC = (D + 15) / 16;  // output columns a thread
  extern __shared__ float smem[];
  float* sq = smem;                  // [kRows][LD]
  float* skv = sq + kRows * LD;      // [kKeys][LD]: K, then V
  float* sp = skv + kKeys * LD;      // [kRows][kKeys + 1]

  const int tid = threadIdx.x;
  const int rq = tid >> 4, kq = tid & 15;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const float* qg = a.q + b * a.st.q[0] + h * a.st.q[1];
  const float* kg = a.k + b * a.st.k[0] + h * a.st.k[1];
  const float* vg = a.v + b * a.st.v[0] + h * a.st.v[1];
  const int* mask = a.mask ? a.mask + (long long)b * a.Sk : nullptr;
  const float* qbias = a.qbias ? a.qbias + h * D : nullptr;
  const float* vbias = a.vbias ? a.vbias + h * D : nullptr;

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    float x = 0.f;
    if (q0 + r < a.Sq) {
      x = qg[(q0 + r) * a.st.q[2] + d];
      if (qbias) x += qbias[d];
    }
    sq[r * LD + d] = x;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < a.Sk; k0 += kKeys) {
    const int nk = min(kKeys, a.Sk - k0);
    __syncthreads();  // the last tile's PV is done with skv and sp
    for (int i = tid; i < kKeys * D; i += kThreads) {
      const int j = i / D, d = i - j * D;
      skv[j * LD + d] = j < nk ? kg[(k0 + j) * a.st.k[2] + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = sq[(4 * rq + r) * LD + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = skv[(kq + 16 * c) * LD + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

    bool valid[4], live[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = kq + 16 * c;
      live[c] = j < nk;
      valid[c] = live[c] && (mask == nullptr || mask[k0 + j] != 0);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float tmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = !live[c] ? -INFINITY
                  : valid[c] ? __fmul_rn(s[r][c], a.scale) : -1e30f;
        tmax = fmaxf(tmax, s[r][c]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float mnew = fmaxf(m[r], tmax);  // finite: a tile has a live key
      const float alpha = expf(m[r] - mnew);  // 0 on the first tile
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - mnew);
        psum += p;
        sp[(4 * rq + r) * (kKeys + 1) + kq + 16 * c] = p;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[r] = l[r] * alpha + psum;
      m[r] = mnew;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();  // every score of K read, p written

    for (int i = tid; i < kKeys * D; i += kThreads) {
      const int j = i / D, d = i - j * D;
      float x = 0.f;
      if (j < nk) {
        x = vg[(k0 + j) * a.st.v[2] + d];
        if (vbias) x += vbias[d];
      }
      skv[j * LD + d] = x;
    }
    __syncthreads();

    for (int j = 0; j < nk; ++j) {
      float p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = sp[(4 * rq + r) * (kKeys + 1) + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = kq + 16 * c;
        if (D % 16 == 0 || d < D) {
          const float vv = skv[j * LD + d];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(p[r], vv, acc[r][c]);
        }
      }
    }
  }

  float* og = a.o + b * a.st.o[0] + h * a.st.o[1];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + 4 * rq + r;
    if constexpr (kQuant) {
      float amax = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = kq + 16 * c;
        if (row < a.Sq && (D % 16 == 0 || d < D)) {
          const float y = acc[r][c] / l[r];
          og[row * a.st.o[2] + d] = y;
          amax = fmaxf(amax, fabsf(y));
        }
      }
      // the 16 threads of the row group share a half-warp
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      if (kq == 0 && row < a.Sq)
        atomicMax(a.rowmax + (long long)b * a.Sq + row, __float_as_uint(amax));
    } else {
      if (row >= a.Sq) continue;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = kq + 16 * c;
        if (D % 16 == 0 || d < D) og[row * a.st.o[2] + d] = acc[r][c] / l[r];
      }
    }
  }
}

template <int D, bool kQuant>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      attention_f32_kernel<D, kQuant>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kRows - 1) / kRows, a.H, a.B);
  attention_f32_kernel<D, kQuant><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_width(const Args& a, cudaStream_t stream) {
  return a.rowmax ? launch<D, true>(a, stream) : launch<D, false>(a, stream);
}

int launch_f32(const void* q, const void* k, const void* v, const void* mask,
               const void* qbias, const void* vbias, void* o, int B, int H,
               int Sq, int Sk, int D, const long long* strides, float scale,
               cudaStream_t st, Args a) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.mask = static_cast<const int*>(mask);
  a.qbias = static_cast<const float*>(qbias);
  a.vbias = static_cast<const float*>(vbias);
  a.o = static_cast<float*>(o);
  a.B = B;
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.scale = scale;
  long long* all[4] = {a.st.q, a.st.k, a.st.v, a.st.o};
  for (int i = 0; i < 12; ++i) all[i / 3][i % 3] = strides[i];
  switch (D) {
    case 64: return (int)launch_width<64>(a, st);
    case 88: return (int)launch_width<88>(a, st);
    case 128: return (int)launch_width<128>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, H, Sq, D], k and v [B, H, Sk, D], o [B, H, Sq, D]: f32 views with
// unit stride along D; `strides` holds the (batch, head, row) element
// strides of q, k, v and o, in that order. mask is null or int32 [B, Sk]
// (nonzero marks a valid key); qbias and vbias are each null or f32
// [H * D], added to q and v. D = 64, 88 or 128; any Sq and Sk; B and H up
// to 65535. Launches on `stream` and returns cudaGetLastError().
extern "C" int hirest_attention_f32(const void* q, const void* k,
                                    const void* v, const void* mask,
                                    const void* qbias, const void* vbias,
                                    void* o, int B, int H, int Sq, int Sk,
                                    int D, const long long* strides,
                                    float scale, void* stream) {
  return launch_f32(q, k, v, mask, qbias, vbias, o, B, H, Sq, Sk, D, strides,
                    scale, (cudaStream_t)stream, Args{});
}

// The int8-out forms: q, k, v, mask and the biases as above, with the
// (batch, head, row) strides of q, k and v in `strides`; ws [B, Sq, H * D]
// f32 (16-byte aligned) and rowmax [B * Sq] uint32 are workspaces; codes
// [B, Sq, H * D] int8 and scales [B * Sq] f32 the result. H * D % 4 == 0.
extern "C" int hirest_attention_f32_quant(
    const void* q, const void* k, const void* v, const void* mask,
    const void* qbias, const void* vbias, void* ws, void* rowmax, void* codes,
    void* scales, int B, int H, int Sq, int Sk, int D,
    const long long* strides, float scale, void* stream) {
  const long long hd = (long long)H * D;
  const long long all[12] = {strides[0], strides[1], strides[2], strides[3],
                             strides[4], strides[5], strides[6], strides[7],
                             strides[8], Sq * hd,    D,          hd};
  const cudaStream_t st = (cudaStream_t)stream;
  const int rows = B * Sq;
  if (B <= 0 || Sq <= 0 || hd % 4 || reinterpret_cast<uintptr_t>(ws) % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaMemsetAsync(rowmax, 0, sizeof(unsigned int) * rows, st);
  if (err != cudaSuccess) return (int)err;
  Args a = {};
  a.rowmax = static_cast<unsigned int*>(rowmax);
  err = (cudaError_t)launch_f32(q, k, v, mask, qbias, vbias, ws, B, H, Sq, Sk,
                                D, all, scale, st, a);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_quant_rows(static_cast<const float*>(ws),
                                static_cast<const unsigned int*>(rowmax),
                                codes, scales, rows, (int)hd, st);
}

extern "C" const char* hirest_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
