// Pieces shared by the attention kernels (attention_split.cu,
// attention_qkv3.cu): mma.sync m16n8k16 bf16 with f32 accumulation, the
// tile geometry and 16x8 QK^T tiles of attention_split.cu's streamed body,
// the bf16 bias adds of K8 as q is loaded and as a V tile lands, cp.async,
// ldmatrix, bf16 packing and the SFU's 2^x.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"  // smem_u32

template <int D>
struct Tile {
  static_assert(D % 8 == 0, "head width must be a multiple of 8");
  static constexpr int kChunks = (D + 15) / 16;  // k-steps of QK^T over d
  static constexpr int kDPad = kChunks * 16;     // d zero-padded for QK^T
  static constexpr int kKStride = kDPad + 8;     // bank-conflict-free rows
  static constexpr int kOTiles = D / 8;          // n-tiles of the PV product
  static constexpr int kVecs = D / 8;            // 16-byte vectors per slice
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 pairs added as PyTorch adds bf16 tensors: the f32 sum of each
// pair, rounded once to bf16.
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162 y = *reinterpret_cast<const __nv_bfloat162*>(&b);
  const __nv_bfloat162 r =
      __floats2bfloat162_rn(__fadd_rn(__low2float(x), __low2float(y)),
                            __fadd_rn(__high2float(x), __high2float(y)));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// One pair of q values (row r, columns c and c + 1), plus the pair of the
// bias when there is one; zero past `rows` and past D.
template <int D>
__device__ __forceinline__ uint32_t q_pair(const __nv_bfloat16* qg,
                                           long long rs, int r, int c,
                                           int rows,
                                           const __nv_bfloat16* bias) {
  if (r >= rows || c >= D) return 0u;
  const uint32_t x = ld_u32(qg + r * rs + c);
  return bias == nullptr ? x : add_bf16x2(x, ld_u32(bias + c));
}

// Load the A fragments of a 16-row query tile (rows r0 and r0 + 8 of this
// lane, row stride `rs`), zero past `rows` and past D. With `bias` (the
// head's D values) each q value gets its bias added in bf16.
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&qa)[Tile<D>::kChunks][4],
                                       const __nv_bfloat16* qg, long long rs,
                                       int r0, int rows, int t,
                                       const __nv_bfloat16* bias = nullptr) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int kc = 0; kc < Tile<D>::kChunks; ++kc) {
    const int c0 = kc * 16 + 2 * t, c1 = c0 + 8;
    qa[kc][0] = q_pair<D>(qg, rs, r0, c0, rows, bias);
    qa[kc][1] = q_pair<D>(qg, rs, r1, c0, rows, bias);
    qa[kc][2] = q_pair<D>(qg, rs, r0, c1, rows, bias);
    qa[kc][3] = q_pair<D>(qg, rs, r1, c1, rows, bias);
  }
}

// --- Asynchronous copies and ldmatrix (attention_split.cu's streamed body) --

// 16 bytes global -> shared without a register round trip; zero-filled
// (nothing read from src) when !in.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

// 4 bytes, zero-filled when !in.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + kRows) of a [n, D] bf16 tensor (row stride rs elements,
// 16-byte aligned rows) into shared memory with row stride Tile<D>::kKStride,
// rows >= n zero-filled, by `nthreads` threads.
template <int D, int kRows>
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                long long rs, int row0, int n,
                                                int tid, int nthreads) {
  using T = Tile<D>;
  for (int i = tid; i < kRows * T::kVecs; i += nthreads) {
    const int r = i / T::kVecs, c = i % T::kVecs;
    const bool in = row0 + r < n;
    cp_async16(dst + r * T::kKStride + c * 8,
               src + (in ? row0 + r : 0) * rs + c * 8, in);
  }
}

// K8's v bias on a tile that load_rows_async<D, kRows> brought in: each
// thread adds `bias` (the head's D values, 16-byte aligned) in bf16 to the
// 16-byte chunks it copied itself (i = tid + k nthreads), in place, rows
// >= n left zero. A thread's own cp.async copies are complete and visible
// to it once its cp.async.wait_group returns, so this needs no barrier of
// its own: the one that publishes the tile publishes the sums.
template <int D, int kRows>
__device__ __forceinline__ void add_bias_rows(__nv_bfloat16* dst,
                                              const __nv_bfloat16* bias,
                                              int row0, int n, int tid,
                                              int nthreads) {
  using T = Tile<D>;
  for (int i = tid; i < kRows * T::kVecs; i += nthreads) {
    const int r = i / T::kVecs, c = i % T::kVecs;
    if (row0 + r >= n) break;  // r only grows with i
    uint4* p = reinterpret_cast<uint4*>(dst + r * T::kKStride + c * 8);
    const uint4 x = *p;
    const uint4 bv = *reinterpret_cast<const uint4*>(bias + c * 8);
    *p = make_uint4(add_bf16x2(x.x, bv.x), add_bf16x2(x.y, bv.y),
                    add_bf16x2(x.z, bv.z), add_bf16x2(x.w, bv.w));
  }
}

// Four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and lane (g, t) gets row g, columns 2t and 2t+1 of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The same, transposed: lane (g, t) gets rows 2t and 2t+1 of column g.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// Two matrices, transposed; lanes 0..15 give the row addresses.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// Two floats rounded to bf16 in one conversion, lo in the low half.
__device__ __forceinline__ uint32_t pack_f32_bf16(float lo, float hi) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// qk_tile with k's B fragments read by ldmatrix.x4, two d-chunks a load,
// from a tile staged row-major with row stride Tile<D>::kKStride.
template <int D>
__device__ __forceinline__ void qk_tile_ldm(
    float (&s)[4], const uint32_t (&qa)[Tile<D>::kChunks][4],
    const __nv_bfloat16* ks, int nt, int lane) {
  static_assert(Tile<D>::kChunks % 2 == 0, "d-chunks are loaded in pairs");
  s[0] = s[1] = s[2] = s[3] = 0.f;
  const __nv_bfloat16* row =
      ks + (nt * 8 + (lane & 7)) * Tile<D>::kKStride + (lane >> 3) * 8;
#pragma unroll
  for (int kc = 0; kc < Tile<D>::kChunks; kc += 2) {
    uint32_t b[4];
    ldmatrix_x4(b, row + kc * 16);
    mma_bf16(s, qa[kc], b[0], b[1]);
    mma_bf16(s, qa[kc + 1], b[2], b[3]);
  }
}

// 2^x on the SFU's ex2: exp2f's instruction without its fix-ups for
// results below 2^-126, which it flushes to 0 (a p that small is 0 at the
// bar).
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
