// G1: the int8 projections of the int8 towers, whole: an s8 x s8 -> s32
// product on wgmma fed by TMA, with E3's dequant, bias and residual in its
// epilogue. The int32 accumulator never leaves the SM.
//
// It replaces no Pallas kernel. On the TPU the JAX package leaves each int8
// projection to XLA as one dot_general into int32 with the dequant fused
// into its epilogue: hirest_tpu/models/eva_scan.py:92-101 (_int8_mm, with
// the residual sum that follows it at :320, :334, :338 and :345) and
// hirest_tpu/ops/quant.py:41-55 (int8_matmul). With x_q [M, K] int8 and row
// scales xs [M], w_q [N, K] int8 (nn.Linear's layout) and channel scales ws
// [N], a bias b [N] or none, and a residual x [M, N] of dt or none:
//
//   out = dt((f32(x_q w_q^T) * xs) * ws + b)            dt bf16 or f32
//   out = dt(x + dt((f32(x_q w_q^T) * xs) * ws + b))    with the residual
//
// The product is exact in int32; the epilogue is int8_dequant.cuh's, E3's
// arithmetic rounding for rounding, so the output is the plain version's
// (ops/quant.py::int8_mm_ref: torch._int_mm, then int8_epilogue_ref) bit
// for bit.
//
// Bound on an H100 SXM (EVA-g, M = 128 * 257 = 32896, K = 1408). The qkv
// projection, N = 4224: 391.3 G int8 operations, 0.198 ms at 1979 TOP/s,
// against 330 MB (x_q, w_q, a bf16 out), 0.099 ms at 3.35 TB/s: bound by
// operations. fc1 (N = 6144) and fc2 (K = 6144, N = 1408): 569.2 G, 0.288
// ms. out with its residual (N = 1408): 130.4 G operations, 0.066 ms,
// against 233 MB, 0.070 ms: bound by bytes. The head (128 class-token rows
// into 1024) is a few microseconds of work on 4 to 8 tiles.
//
// What bounds it on the card (tools/g1_probe.py, chip_smoke.py
// --time-int8-gemm; PERF.md). The first design's block (a 128 x 256 tile,
// its epilogue in series with its products) stored its tile and read the
// residual between two main loops: without those stores qkv took 0.328
// ms instead of 0.364, fc2 0.401 instead of 0.534, out 0.138 instead of
// 0.213. With each stage's products issued twice qkv took 0.529: the main
// loop gains the full time of the added products, so it is not hidden
// behind its feed, yet it runs at about 60 % of the int8 rate. Every K
// step lands in the block's shared memory from L2, 48 KB a 128 x 256
// tile; at this design's qkv time the SMs together take in about 7 TB/s
// of tiles, and neither halving w_q's draw from L2 (the clusters below)
// nor a ring twice as deep in stages half as large (a build not kept)
// moved that much. Beside the products, each tile's dequant (an int ->
// f32 conversion a value on the conversion unit, 16 a clock an SM, two
// multiplies, the bf16 rounding) runs on the consumers between two main
// loops.
//
// Design. A block computes 128 x 256 output tiles: a producer warp whose
// one thread keeps a ring of 128-byte-deep K tiles full by TMA (128-byte
// swizzle, one full and one empty mbarrier a stage), two consumer
// warpgroups of 64 rows each running wgmma.mma_async (m64n256k32, s8 x s8
// -> s32) with both operands K-major in shared memory, the only layout
// 8-bit wgmma takes, and an epilogue warp; setmaxnreg moves the producer
// warpgroup's registers to the accumulators. TMA zero-fills rows past M or
// N and columns past K (K % 16 == 0, for TMA's 16-byte row pitch), so G1
// takes any M >= 1.
// - The epilogue is off the products' path. The epilogue warp loads each
//   tile's xs, ws and bias into a double buffer while its main loop runs;
//   in bf16 it also loads the residual tile by TMA into the staging tile
//   (128-byte swizzled boxes of 128 rows x 64 columns, conflict-free for
//   wgmma's accumulator layout) once the last tile's store has read it.
//   The consumers dequantize into the staging tile (adding the residual in
//   place), fence the async proxy, arrive, and go straight on to the next
//   tile's products; the epilogue warp stores the tile by TMA. In f32 the
//   tile leaves from registers (a thread's two adjacent values are one
//   8-byte store; a quad fills a 32-byte sector).
// - Persistent clusters of two blocks along M share w_q's tile: each
//   block loads half of it and multicasts it to both, so a tile draws
//   0.67x the bytes from L2; a stage's empty barrier counts both blocks'
//   consumer warps (one arrival a warp on each block). Clusters of two
//   hold all 132 SMs (66 clusters); against the same kernel without them
//   (a build not kept) they gained a few per cent in bf16 and up to 15 %
//   in f32: the tiles' intake, not L2's output, is what bounds it.
// - Products whose tiles leave SMs idle (the head, a row, a frame's fc2)
//   split K across a cluster of up to 8 blocks (int8_gemm_split_kernel):
//   each block sums its K range into int32 and puts it in its shared
//   memory, and after a cluster barrier each block adds the partials of a
//   slice of the tile's columns through distributed shared memory,
//   exactly, and runs the dequant once.
// - f32 with a residual keeps the first design's 128-wide tiles, two
//   blocks an SM, whose epilogues (8 bytes a value out, 8 in) overlap each
//   other's products: there the cluster kernel, one block an SM, lost.
//
// ops/quant.py::int8_gemm_config picks the variant for each shape.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "int8_dequant.cuh"

namespace {

constexpr int kBM = 128;         // rows a tile: two consumer warpgroups
constexpr int kBN = 256;         // the cluster kernel's tile width
constexpr int kBK = 128;         // K bytes a ring stage: one swizzle row
constexpr int kKStep = 32;       // K bytes a wgmma
constexpr int kConsumers = 256;  // two consumer warpgroups
constexpr int kConsumerWarps = kConsumers / 32;
// warp 8 issues the TMA loads, warp 9 runs the cluster kernel's epilogue
// loads and stores; warps 10 and 11 make these a warpgroup, so that
// setmaxnreg can move its registers to the consumers: 12 warps hold 168
// registers each at launch (three share a sub-partition's 16K), then the
// producer warpgroup 40 and the consumers 232 (at 168 the 256-wide
// accumulators spilled)
constexpr int kProducerWarp = kConsumerWarps;
constexpr int kEpilogueWarp = kConsumerWarps + 1;
constexpr int kThreads = kConsumers + 128;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kBox = 64;         // bf16 columns a store box: 128 bytes
constexpr int kBoxBytes = kBM * kBox * 2;
constexpr int kBoxes = kBN / kBox;
constexpr int kMaxSplits = 8;    // blocks of a split-K cluster (portable)
constexpr int kSplitBN = 128;    // the split-K and f32-residual tiles' width
// shared memory a block may take with one or two blocks an SM (each
// block's 1 KB of reserved shared memory left out)
constexpr int kSmemOne = 232448;
constexpr int kSmemTwo = 115712;

// The cluster kernel's shared memory for output T: the ring takes what the
// staging tile (bf16), the two buffers of a tile's ws, bias and xs, and
// the barriers leave.
template <typename T>
struct Plan {
  static constexpr int kATile = kBM * kBK;
  static constexpr int kBTile = kBN * kBK;
  static constexpr int kStage = kATile + kBTile;
  static constexpr bool kStaged = sizeof(T) == 2;  // bf16 leaves by TMA
  static constexpr int kStaging = kStaged ? kBoxes * kBoxBytes : 0;
  static constexpr int kRowFloats = 2 * kBN + kBM;  // ws, bias, xs
  static constexpr int kRows = 2 * kRowFloats * 4;
  static constexpr int kMaxStages = 8;
  static constexpr int kBudget = kSmemOne - 1024 - kStaging - kRows -
                                 8 * (2 * kMaxStages + 6);
  static constexpr int kStages =
      kBudget / kStage < kMaxStages ? kBudget / kStage : kMaxStages;
  static constexpr size_t kSmem = 1024 + (size_t)kStages * kStage +
                                  kStaging + kRows + 8 * (2 * kStages + 6);
  static_assert(kStages >= 2, "a ring of at least two stages");
};

// The split-K kernel's: a ring of 128-wide stages whose space then holds
// the block's int32 partial tile.
struct SplitPlan {
  static constexpr int kATile = kBM * kBK;
  static constexpr int kBTile = kSplitBN * kBK;
  static constexpr int kStage = kATile + kBTile;
  static constexpr int kStages = 4;
  static constexpr size_t kSmem =
      1024 + (size_t)kStages * kStage + 8 * 2 * kStages;
  static_assert(kStages * kStage >= kSplitBN / 2 * kConsumers * 4,
                "the partial tile fits in the ring");
};

#define G1_R8(d, i)                                                      \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),            \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// D[64 x 128] (+)= A[64 x 32] * B[128 x 32]^T, s8 x s8 -> s32; both operands
// K-major in shared memory (128-byte swizzle), D in 64 registers a thread.
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : G1_R8(d, 0), G1_R8(d, 8), G1_R8(d, 16), G1_R8(d, 24), G1_R8(d, 32),
        G1_R8(d, 40), G1_R8(d, 48), G1_R8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 256] (+)= A[64 x 32] * B[256 x 32]^T, as above; D in 128 registers.
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : G1_R8(d, 0), G1_R8(d, 8), G1_R8(d, 16), G1_R8(d, 24), G1_R8(d, 32),
        G1_R8(d, 40), G1_R8(d, 48), G1_R8(d, 56), G1_R8(d, 64),
        G1_R8(d, 72), G1_R8(d, 80), G1_R8(d, 88), G1_R8(d, 96),
        G1_R8(d, 104), G1_R8(d, 112), G1_R8(d, 120)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef G1_R8

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (BN == 128) {
    wgmma_s8_n128(d, da, db, accumulate);
  } else {
    wgmma_s8_n256(d, da, db, accumulate);
  }
}

// two bf16 values packed in a word, widened
__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ uint32_t bf16_pack(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// Accumulator layout of a consumer thread (wgmma's D fragment): register
// 4i + e holds row r0 + 8 * (e / 2) and column 8i + 2 * (lane % 4) + e % 2
// of its warpgroup's 64-row tile, r0 = 16 * (warp % 4) + lane / 4.

// out[at], out[at + 1] = v0, v1 (+ the residual there), in T, from
// registers: 4 bytes in bf16, 8 in f32.
__device__ __forceinline__ void store_pair(__nv_bfloat16* out,
                                           const __nv_bfloat16* res,
                                           size_t at, float v0, float v1) {
  if (res != nullptr) {
    const uint32_t x = __ldg(reinterpret_cast<const unsigned int*>(res + at));
    v0 = int8_residual_sum<__nv_bfloat16>(bf16_lo(x), v0);
    v1 = int8_residual_sum<__nv_bfloat16>(bf16_hi(x), v1);
  }
  *reinterpret_cast<uint32_t*>(out + at) = bf16_pack(v0, v1);
}

__device__ __forceinline__ void store_pair(float* out, const float* res,
                                           size_t at, float v0, float v1) {
  if (res != nullptr) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(res + at));
    v0 = int8_residual_sum<float>(x.x, v0);
    v1 = int8_residual_sum<float>(x.y, v1);
  }
  *reinterpret_cast<float2*>(out + at) = make_float2(v0, v1);
}

// The byte offset of (row r, column c) in a staged bf16 tile: boxes of 128
// rows x 64 columns, each as TMA's 128-byte swizzle lays it (the 16-byte
// chunk of a 128-byte row XORed with the row's index mod 8).
__device__ __forceinline__ uint32_t staged_at(int r, int c) {
  return (c >> 6) * kBoxBytes + r * 128 +
         ((((c & 63) >> 3) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

// The staged tile of rows m0.., columns n0.. out by TMA (its boxes that
// start inside the matrix; the map clips the rest), in one bulk group.
__device__ __forceinline__ void store_staged(const CUtensorMap* map,
                                             const uint8_t* staging, int m0,
                                             int n0, int M, int N) {
  if (m0 < M)
    for (int x = 0; x < kBoxes && n0 + x * kBox < N; ++x)
      tma_store(map, staging + x * kBoxBytes, n0 + x * kBox, m0);
  bulk_commit();
}

// One arrival a warp on a ring stage's empty barrier, on this block and on
// its peer, whose producer multicasts into the stage too. (The peer's
// arrival orders nothing but this warp's wgmma reads of the stage, which
// have retired: it releases at the CTA's scope, as a local arrival does;
// a cluster-scope release each warp and K tile stalled the products.)
__device__ __forceinline__ void release_stage(uint64_t* bar, int lane,
                                              uint32_t peer) {
  if (lane == 0) {
    mbar_arrive(bar);
    mbar_arrive_remote(bar, peer);
  }
}

// The cluster kernel: persistent clusters of two blocks, one an SM, each
// cluster a unit of two 128 x 256 tiles stacked along M (block r the r-th)
// that share w_q's tile. tm_out and tm_res (bf16 only) map out and the
// residual in boxes of 128 rows x 64 columns.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w,
                     const __grid_constant__ CUtensorMap tm_out,
                     const __grid_constant__ CUtensorMap tm_res,
                     const float* __restrict__ xs,
                     const float* __restrict__ ws,
                     const float* __restrict__ bias,
                     const T* __restrict__ res, T* __restrict__ out, int M,
                     int N, int K) {
  using P = Plan<T>;
  constexpr int kS = P::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* a_s = smem;                               // [stage][128][128]
  uint8_t* b_s = a_s + kS * P::kATile;               // [stage][256][128]
  uint8_t* staging = b_s + kS * P::kBTile;           // [box][128][128 B]
  float* rows = reinterpret_cast<float*>(staging + P::kStaging);
  uint64_t* full = reinterpret_cast<uint64_t*>(rows + 2 * P::kRowFloats);
  uint64_t* empty = full + kS;
  uint64_t* rows_full = empty + kS;     // [2]: a tile's ws, bias, xs loaded
  uint64_t* rows_free = rows_full + 2;  // [2]: and read
  uint64_t* staged = rows_free + 2;     // the consumers' tile is staged
  uint64_t* ready = staged + 1;         // staging free (and the residual in)

  const int n_tiles = (N + kBN - 1) / kBN;
  const int units = ((M + kBM - 1) / kBM + 1) / 2 * n_tiles;
  const int k_tiles = (K + kBK - 1) / kBK;
  const int rank = (int)cluster_rank();
  const int first = blockIdx.x / 2, stride = gridDim.x / 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * kConsumerWarps);  // both blocks' warps
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&rows_full[b], 32);
      mbar_init(&rows_free[b], kConsumerWarps);
    }
    mbar_init(staged, kConsumerWarps);
    mbar_init(ready, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_arrive();  // the peer's barriers are initialised
  cluster_wait();

  if (warp >= kConsumerWarps) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kProducerWarp && lane == 0) {
      // each block loads its rows of x_q and half of w_q's tile, which it
      // multicasts to both; a row or column block wholly past the matrix
      // is read from its last rows instead (what it adds lands only in
      // rows or columns that are never stored)
      int it = 0;
      for (int u = first; u < units; u += stride) {
        const int m0 = min((u / n_tiles * 2 + rank) * kBM, M - 1);
        const int n0 = min(u % n_tiles * kBN + rank * (kBN / 2), N - 1);
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int s = it % kS;
          if (it >= kS) mbar_wait(&empty[s], (it / kS - 1) & 1);
          mbar_expect_tx(&full[s], P::kStage);
          tma_load(a_s + s * P::kATile, &tm_x, &full[s], kt * kBK, m0);
          tma_load_multicast(b_s + s * P::kBTile + rank * (kBN / 2) * kBK,
                             &tm_w, &full[s], kt * kBK, n0, 0x3);
        }
      }
    } else if (warp == kEpilogueWarp) {
      // each tile's ws, bias and xs into a double buffer during its main
      // loop; in bf16 the last tile's store, then the residual into the
      // staging tile (without one, only the word that it is free)
      int j = 0, m_last = 0, n_last = 0;
      for (int u = first; u < units; u += stride, ++j) {
        const int m0 = (u / n_tiles * 2 + rank) * kBM;
        const int n0 = u % n_tiles * kBN;
        const int b = j & 1;
        if (j >= 2) mbar_wait(&rows_free[b], ((j >> 1) - 1) & 1);
        float* r = rows + b * P::kRowFloats;
        for (int c = lane; c < kBN; c += 32) {
          const bool in = n0 + c < N;
          r[c] = in ? ws[n0 + c] : 0.f;
          r[kBN + c] = in && bias != nullptr ? bias[n0 + c] : 0.f;
        }
        for (int c = lane; c < kBM; c += 32)
          r[2 * kBN + c] = m0 + c < M ? xs[m0 + c] : 0.f;
        mbar_arrive(&rows_full[b]);
        if constexpr (P::kStaged) {
          if (j >= 1) mbar_wait(staged, (j - 1) & 1);
          if (lane == 0) {
            if (j >= 1) {
              store_staged(&tm_out, staging, m_last, n_last, M, N);
              bulk_wait_read<0>();
            }
            int boxes = 0;
            if (res != nullptr && m0 < M)
              boxes = min(kBoxes, (N - n0 + kBox - 1) / kBox);
            if (boxes > 0) {
              mbar_expect_tx(ready, boxes * kBoxBytes);
              for (int x = 0; x < boxes; ++x)
                tma_load(staging + x * kBoxBytes, &tm_res, ready,
                         n0 + x * kBox, m0);
            } else {
              mbar_arrive(ready);
            }
          }
        }
        m_last = m0;
        n_last = n0;
      }
      if constexpr (P::kStaged) {
        if (j >= 1) {
          mbar_wait(staged, (j - 1) & 1);
          if (lane == 0) {
            store_staged(&tm_out, staging, m_last, n_last, M, N);
            bulk_wait<0>();
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128, q = lane % 4;
    const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4;  // and r0 + 8
    const uint32_t peer = (uint32_t)rank ^ 1u;
    const bool has_bias = bias != nullptr;
    int acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;
    const uint32_t a0 = smem_u32(a_s) + wg * 64 * kBK, b0 = smem_u32(b_s);
    int it = 0, j = 0;
    for (int u = first; u < units; u += stride, ++j) {
      const int m0 = (u / n_tiles * 2 + rank) * kBM;
      const int n0 = u % n_tiles * kBN;
      // the main loop: a stage is released once the group after it has
      // been issued and its own has retired
      for (int kt = 0; kt < k_tiles; ++kt, ++it) {
        const int s = it % kS;
        mbar_wait(&full[s], (it / kS) & 1);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kBK / kKStep; ++k)
          wgmma_s8<kBN>(acc, smem_desc(a0 + s * P::kATile + k * kKStep),
                        smem_desc(b0 + s * P::kBTile + k * kKStep), kt | k);
        wgmma_commit();
        if (kt > 0) {
          wgmma_wait<1>();
          release_stage(&empty[(it - 1) % kS], lane, peer);
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release_stage(&empty[(it - 1) % kS], lane, peer);

      const int b = j & 1;
      mbar_wait(&rows_full[b], (j >> 1) & 1);
      const float* r = rows + b * P::kRowFloats;
      const float xs0 = r[2 * kBN + r0], xs1 = r[2 * kBN + r0 + 8];
      if constexpr (P::kStaged) {
        // bf16: dequantize into the staging tile, the residual (loaded
        // there by the epilogue warp) added in place
        mbar_wait(ready, j & 1);
        const bool has_res = res != nullptr;
#pragma unroll
        for (int i = 0; i < kBN / 8; ++i) {
          const int c = 8 * i + 2 * q;
          const float2 w = *reinterpret_cast<const float2*>(r + c);
          float v00 = int8_dequant(acc[4 * i], xs0, w.x);
          float v01 = int8_dequant(acc[4 * i + 1], xs0, w.y);
          float v10 = int8_dequant(acc[4 * i + 2], xs1, w.x);
          float v11 = int8_dequant(acc[4 * i + 3], xs1, w.y);
          if (has_bias) {
            const float2 bb = *reinterpret_cast<const float2*>(r + kBN + c);
            v00 = int8_dequant_bias(v00, bb.x);
            v01 = int8_dequant_bias(v01, bb.y);
            v10 = int8_dequant_bias(v10, bb.x);
            v11 = int8_dequant_bias(v11, bb.y);
          }
          uint32_t* p0 =
              reinterpret_cast<uint32_t*>(staging + staged_at(r0, c));
          uint32_t* p1 =
              reinterpret_cast<uint32_t*>(staging + staged_at(r0 + 8, c));
          if (has_res) {
            const uint32_t x0 = *p0, x1 = *p1;
            v00 = int8_residual_sum<__nv_bfloat16>(bf16_lo(x0), v00);
            v01 = int8_residual_sum<__nv_bfloat16>(bf16_hi(x0), v01);
            v10 = int8_residual_sum<__nv_bfloat16>(bf16_lo(x1), v10);
            v11 = int8_residual_sum<__nv_bfloat16>(bf16_hi(x1), v11);
          }
          *p0 = bf16_pack(v00, v01);
          *p1 = bf16_pack(v10, v11);
        }
        fence_proxy_async();  // the TMA store reads what was written
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(staged);
          mbar_arrive(&rows_free[b]);
        }
      } else {
        // f32: each thread's two adjacent values, 8 bytes, from registers
        const int row0 = m0 + r0, row1 = row0 + 8;
#pragma unroll
        for (int i = 0; i < kBN / 8; ++i) {
          const int c = 8 * i + 2 * q, col = n0 + c;
          const float2 w = *reinterpret_cast<const float2*>(r + c);
          float v00 = int8_dequant(acc[4 * i], xs0, w.x);
          float v01 = int8_dequant(acc[4 * i + 1], xs0, w.y);
          float v10 = int8_dequant(acc[4 * i + 2], xs1, w.x);
          float v11 = int8_dequant(acc[4 * i + 3], xs1, w.y);
          if (has_bias) {
            const float2 bb = *reinterpret_cast<const float2*>(r + kBN + c);
            v00 = int8_dequant_bias(v00, bb.x);
            v01 = int8_dequant_bias(v01, bb.y);
            v10 = int8_dequant_bias(v10, bb.x);
            v11 = int8_dequant_bias(v11, bb.y);
          }
          if (col >= N) continue;
          if (row0 < M) store_pair(out, res, (size_t)row0 * N + col, v00, v01);
          if (row1 < M) store_pair(out, res, (size_t)row1 * N + col, v10, v11);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&rows_free[b]);
      }
    }
  }
  __syncwarp();
  cluster_arrive();  // no block leaves while its peer may still reach it
  cluster_wait();
}

// Split K: a cluster of `cluster_size()` blocks (at most kMaxSplits) takes
// one 128 x 128 tile, block r the r-th share of K's tiles. Each block's
// int32 partial goes into its ring's space ([i][thread] 16-byte groups of
// a thread's registers 4i..4i+3); after a cluster barrier block r adds up,
// through distributed shared memory, the partials of its share of the
// column groups i, in int32 (exact, in any order), dequantizes once and
// stores from registers.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    int8_gemm_split_kernel(const __grid_constant__ CUtensorMap tm_x,
                           const __grid_constant__ CUtensorMap tm_w,
                           const float* __restrict__ xs,
                           const float* __restrict__ ws,
                           const float* __restrict__ bias,
                           const T* __restrict__ res, T* __restrict__ out,
                           int M, int N, int K) {
  constexpr int BN = kSplitBN;
  constexpr int kS = SplitPlan::kStages;
  constexpr int kGroups = BN / 8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* a_s = smem;
  uint8_t* b_s = a_s + kS * SplitPlan::kATile;
  uint64_t* full = reinterpret_cast<uint64_t*>(b_s + kS * SplitPlan::kBTile);
  uint64_t* empty = full + kS;
  uint4* partial = reinterpret_cast<uint4*>(smem);  // after the products

  const int splits = (int)cluster_size(), rank = (int)cluster_rank();
  const int tile = blockIdx.x / splits;
  const int n_tiles = (N + BN - 1) / BN;
  const int m0 = tile / n_tiles * kBM, n0 = tile % n_tiles * BN;
  const int k_tiles = (K + kBK - 1) / kBK;
  const int kt0 = rank * k_tiles / splits;
  const int kt1 = (rank + 1) * k_tiles / splits;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kProducerWarp) {
    if (lane == 0) {
      for (int kt = kt0; kt < kt1; ++kt) {
        const int it = kt - kt0, s = it % kS;
        if (it >= kS) mbar_wait(&empty[s], (it / kS - 1) & 1);
        mbar_expect_tx(&full[s], SplitPlan::kStage);
        tma_load(a_s + s * SplitPlan::kATile, &tm_x, &full[s], kt * kBK, m0);
        tma_load(b_s + s * SplitPlan::kBTile, &tm_w, &full[s], kt * kBK, n0);
      }
    }
  } else if (warp < kConsumerWarps) {
    const int wg = threadIdx.x / 128;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    const uint32_t a0 = smem_u32(a_s) + wg * 64 * kBK, b0 = smem_u32(b_s);
    for (int kt = kt0; kt < kt1; ++kt) {
      const int it = kt - kt0, s = it % kS;
      mbar_wait(&full[s], (it / kS) & 1);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBK / kKStep; ++k)
        wgmma_s8<BN>(acc, smem_desc(a0 + s * SplitPlan::kATile + k * kKStep),
                     smem_desc(b0 + s * SplitPlan::kBTile + k * kKStep),
                     it | k);
      wgmma_commit();
      if (it > 0) {
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty[(it - 1) % kS]);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    named_barrier_sync(1, kConsumers);  // both warpgroups are off the ring
#pragma unroll
    for (int i = 0; i < kGroups; ++i)
      partial[i * kConsumers + threadIdx.x] =
          make_uint4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                     acc[4 * i + 3]);
  }
  __syncwarp();
  cluster_arrive();  // every block's partial is in its shared memory
  cluster_wait();
  if (warp < kConsumerWarps) {
    const int wg = threadIdx.x / 128, q = lane % 4;
    const int row0 = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
    const int row1 = row0 + 8;
    const float xs0 = row0 < M ? xs[row0] : 0.f;
    const float xs1 = row1 < M ? xs[row1] : 0.f;
    const int i0 = rank * kGroups / splits, i1 = (rank + 1) * kGroups / splits;
    for (int i = i0; i < i1; ++i) {
      const int col = n0 + 8 * i + 2 * q;
      if (col >= N) continue;
      int sum[4] = {0, 0, 0, 0};
      for (int p = 0; p < splits; ++p) {
        const uint4 v =
            ld_cluster_v4(partial + i * kConsumers + threadIdx.x, (uint32_t)p);
        sum[0] += (int)v.x;
        sum[1] += (int)v.y;
        sum[2] += (int)v.z;
        sum[3] += (int)v.w;
      }
      const float w0 = ws[col], w1 = ws[col + 1];
      float v00 = int8_dequant(sum[0], xs0, w0);
      float v01 = int8_dequant(sum[1], xs0, w1);
      float v10 = int8_dequant(sum[2], xs1, w0);
      float v11 = int8_dequant(sum[3], xs1, w1);
      if (bias != nullptr) {
        const float b0v = bias[col], b1v = bias[col + 1];
        v00 = int8_dequant_bias(v00, b0v);
        v01 = int8_dequant_bias(v01, b1v);
        v10 = int8_dequant_bias(v10, b0v);
        v11 = int8_dequant_bias(v11, b1v);
      }
      if (row0 < M) store_pair(out, res, (size_t)row0 * N + col, v00, v01);
      if (row1 < M) store_pair(out, res, (size_t)row1 * N + col, v10, v11);
    }
  }
  __syncwarp();
  cluster_arrive();  // no block leaves while another reads its partial
  cluster_wait();
}

// f32 with a residual: the first design's 128-wide tiles, two blocks an
// SM, which overlap one block's epilogue (8 bytes a value out, 8 in) with
// the other's products. Each tile's ws and bias are loaded by the
// consumers before its main loop; the tile leaves from registers.
constexpr int kSerialThreads = kConsumers + 32;

struct SerialPlan {
  static constexpr int kATile = kBM * kBK;
  static constexpr int kBTile = kSplitBN * kBK;
  static constexpr int kStage = kATile + kBTile;
  static constexpr int kRows = 2 * kSplitBN * 4;  // ws and bias
  static constexpr int kStages = (kSmemTwo - 1024 - kRows - 16 * 8) / kStage;
  static constexpr size_t kSmem =
      1024 + (size_t)kStages * kStage + kRows + 2 * kStages * 8;
};

__global__ void __launch_bounds__(kSerialThreads, 2)
    int8_gemm_serial_kernel(const __grid_constant__ CUtensorMap tm_x,
                            const __grid_constant__ CUtensorMap tm_w,
                            const float* __restrict__ xs,
                            const float* __restrict__ ws,
                            const float* __restrict__ bias,
                            const float* __restrict__ res,
                            float* __restrict__ out, int M, int N, int K) {
  constexpr int BN = kSplitBN;
  constexpr int kS = SerialPlan::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* a_s = smem;
  uint8_t* b_s = a_s + kS * SerialPlan::kATile;
  float* ws_s = reinterpret_cast<float*>(b_s + kS * SerialPlan::kBTile);
  float* bias_s = ws_s + BN;
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_s + BN);
  uint64_t* empty = full + kS;

  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = (M + kBM - 1) / kBM * n_tiles;
  const int k_tiles = (K + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * kBM, n0 = tile % n_tiles * BN;
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int s = it % kS;
          if (it >= kS) mbar_wait(&empty[s], (it / kS - 1) & 1);
          mbar_expect_tx(&full[s], SerialPlan::kStage);
          tma_load(a_s + s * SerialPlan::kATile, &tm_x, &full[s], kt * kBK,
                   m0);
          tma_load(b_s + s * SerialPlan::kBTile, &tm_w, &full[s], kt * kBK,
                   n0);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4;
  const bool has_bias = bias != nullptr;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  const uint32_t a0 = smem_u32(a_s) + wg * 64 * kBK, b0 = smem_u32(b_s);
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / n_tiles * kBM, n0 = tile % n_tiles * BN;
    // the tile's ws and bias, once the last tile's epilogue has read them
    named_barrier_sync(1, kConsumers);
    for (int c = threadIdx.x; c < BN; c += kConsumers) {
      const bool in = n0 + c < N;
      ws_s[c] = in ? ws[n0 + c] : 0.f;
      bias_s[c] = in && has_bias ? bias[n0 + c] : 0.f;
    }
    const int row0 = m0 + r0, row1 = row0 + 8;
    const float xs0 = row0 < M ? xs[row0] : 0.f;
    const float xs1 = row1 < M ? xs[row1] : 0.f;

    for (int kt = 0; kt < k_tiles; ++kt, ++it) {
      const int s = it % kS;
      mbar_wait(&full[s], (it / kS) & 1);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBK / kKStep; ++k)
        wgmma_s8<BN>(acc,
                     smem_desc(a0 + s * SerialPlan::kATile + k * kKStep),
                     smem_desc(b0 + s * SerialPlan::kBTile + k * kKStep),
                     kt | k);
      wgmma_commit();
      if (kt > 0) {
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty[(it - 1) % kS]);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % kS]);
    named_barrier_sync(1, kConsumers);  // ws_s and bias_s are written

#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int c = 8 * i + 2 * (lane % 4), col = n0 + c;
      const float2 w = *reinterpret_cast<const float2*>(ws_s + c);
      float v00 = int8_dequant(acc[4 * i], xs0, w.x);
      float v01 = int8_dequant(acc[4 * i + 1], xs0, w.y);
      float v10 = int8_dequant(acc[4 * i + 2], xs1, w.x);
      float v11 = int8_dequant(acc[4 * i + 3], xs1, w.y);
      if (has_bias) {
        const float2 b = *reinterpret_cast<const float2*>(bias_s + c);
        v00 = int8_dequant_bias(v00, b.x);
        v01 = int8_dequant_bias(v01, b.y);
        v10 = int8_dequant_bias(v10, b.x);
        v11 = int8_dequant_bias(v11, b.y);
      }
      if (col >= N) continue;
      if (row0 < M) store_pair(out, res, (size_t)row0 * N + col, v00, v01);
      if (row1 < M) store_pair(out, res, (size_t)row1 * N + col, v10, v11);
    }
  }
}

// --- host ----------------------------------------------------------------

// The tensor map of an int8 [rows, cols] matrix whose rows are `ld` bytes
// apart, read in boxes of 128 bytes by box_rows rows, 128-byte swizzled;
// rows past `rows` and columns past `cols` read as zeros.
cudaError_t s8_map(CUtensorMap* map, const void* base, int rows, int cols,
                   long long ld, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorInitializationError;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor map of a contiguous bf16 [rows, cols] matrix in boxes of 128
// rows x 64 columns, 128-byte swizzled: the staged tile's layout.
cudaError_t bf16_map(CUtensorMap* map, const void* base, int rows,
                     int cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorInitializationError;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBox, (cuuint32_t)kBM};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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

// A launch of `clusters` clusters of the cluster kernel, or of `blocks`
// blocks in clusters of `size` (the split-K kernel).
cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int blocks,
                                  int size, size_t smem, cudaStream_t st) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = size;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The clusters of the cluster kernel the card holds at once
// (cudaOccupancyMaxActiveClusters), after its shared memory opt-in; read
// once. A CUDA error comes back negated.
template <typename T>
int max_clusters() {
  static const int n = [] {
    const auto kernel = int8_gemm_kernel<T>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Plan<T>::kSmem);
    if (err != cudaSuccess) return -(int)err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config(&attr, 2, 2, Plan<T>::kSmem, nullptr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
    return err == cudaSuccess ? clusters : -(int)err;
  }();
  return n;
}

template <typename T>
cudaError_t launch_pair(const void* xq, long long ldx, const void* xs,
                        const void* wq, long long ldw, const void* ws,
                        const void* bias, const void* res, void* out, int M,
                        int N, int K, cudaStream_t st) {
  const int most = max_clusters<T>();
  if (most < 0) return (cudaError_t)-most;
  if (most == 0) return cudaErrorInvalidConfiguration;
  CUtensorMap tm_x, tm_w, tm_out = {}, tm_res = {};
  cudaError_t err = s8_map(&tm_x, xq, M, K, ldx, kBM);
  if (err == cudaSuccess) err = s8_map(&tm_w, wq, N, K, ldw, kBN / 2);
  if (err == cudaSuccess && Plan<T>::kStaged) {
    err = bf16_map(&tm_out, out, M, N);
    if (err == cudaSuccess && res != nullptr)
      err = bf16_map(&tm_res, res, M, N);
  }
  if (err != cudaSuccess) return err;
  const long long units =
      (long long)(((M + kBM - 1) / kBM + 1) / 2) * ((N + kBN - 1) / kBN);
  const int clusters = (int)(most < units ? most : units);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(&attr, 2 * clusters, 2, Plan<T>::kSmem, st);
  err = cudaLaunchKernelEx(&cfg, int8_gemm_kernel<T>, tm_x, tm_w,
                           tm_out, tm_res, static_cast<const float*>(xs),
                           static_cast<const float*>(ws),
                           static_cast<const float*>(bias),
                           static_cast<const T*>(res), static_cast<T*>(out),
                           M, N, K);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t launch_split(const void* xq, long long ldx, const void* xs,
                         const void* wq, long long ldw, const void* ws,
                         const void* bias, const void* res, void* out, int M,
                         int N, int K, int splits, cudaStream_t st) {
  const auto kernel = int8_gemm_split_kernel<T>;
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SplitPlan::kSmem);
  if (opt_in != cudaSuccess) return opt_in;
  if (splits < 1 || splits > kMaxSplits || splits > (K + kBK - 1) / kBK)
    return cudaErrorInvalidValue;
  CUtensorMap tm_x, tm_w;
  cudaError_t err = s8_map(&tm_x, xq, M, K, ldx, kBM);
  if (err == cudaSuccess) err = s8_map(&tm_w, wq, N, K, ldw, kSplitBN);
  if (err != cudaSuccess) return err;
  const long long tiles =
      (long long)((M + kBM - 1) / kBM) * ((N + kSplitBN - 1) / kSplitBN);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      &attr, (int)(tiles * splits), splits, SplitPlan::kSmem, st);
  err = cudaLaunchKernelEx(&cfg, kernel, tm_x, tm_w,
                           static_cast<const float*>(xs),
                           static_cast<const float*>(ws),
                           static_cast<const float*>(bias),
                           static_cast<const T*>(res), static_cast<T*>(out),
                           M, N, K);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The blocks of the f32-residual kernel the card holds at once, after its
// shared memory opt-in; read once. A CUDA error comes back negated.
int serial_blocks() {
  static const int n = [] {
    cudaError_t err = cudaFuncSetAttribute(
        int8_gemm_serial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SerialPlan::kSmem);
    int per_sm = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, int8_gemm_serial_kernel, kSerialThreads,
          SerialPlan::kSmem);
    return err == cudaSuccess ? per_sm * sm_count() : -(int)err;
  }();
  return n;
}

cudaError_t launch_serial(const void* xq, long long ldx, const void* xs,
                          const void* wq, long long ldw, const void* ws,
                          const void* bias, const void* res, void* out,
                          int M, int N, int K, cudaStream_t st) {
  const int most = serial_blocks();
  if (most < 0) return (cudaError_t)-most;
  if (most == 0) return cudaErrorInvalidConfiguration;
  CUtensorMap tm_x, tm_w;
  cudaError_t err = s8_map(&tm_x, xq, M, K, ldx, kBM);
  if (err == cudaSuccess) err = s8_map(&tm_w, wq, N, K, ldw, kSplitBN);
  if (err != cudaSuccess) return err;
  const long long tiles =
      (long long)((M + kBM - 1) / kBM) * ((N + kSplitBN - 1) / kSplitBN);
  const unsigned grid = (unsigned)(most < tiles ? most : tiles);
  int8_gemm_serial_kernel<<<grid, kSerialThreads, SerialPlan::kSmem, st>>>(
      tm_x, tm_w, static_cast<const float*>(xs),
      static_cast<const float*>(ws), static_cast<const float*>(bias),
      static_cast<const float*>(res), static_cast<float*>(out), M, N, K);
  return cudaGetLastError();
}

// The variants, by number (ops/quant.py::INT8_GEMM_VARIANTS):
//   0  the cluster kernel: clusters of two 128 x 256 tiles sharing w_q's
//   1  split K: 128 x 128 tiles, clusters of `splits` blocks along K
//   2  f32 only: 128-wide tiles, two blocks an SM, the epilogue in series
template <typename T>
cudaError_t gemm(const void* xq, long long ldx, const void* xs,
                 const void* wq, long long ldw, const void* ws,
                 const void* bias, const void* res, void* out, int M, int N,
                 int K, int variant, int splits, cudaStream_t st) {
  if (M <= 0 || N <= 0 || N % 8 || K <= 0 || K % 16 || ldx < K ||
      ldx % 16 || ldw < K || ldw % 16 || !xq || !xs || !wq || !ws || !out ||
      !aligned(xq, 16) || !aligned(wq, 16) || !aligned(out, 16) ||
      (res && !aligned(res, 16)))
    return cudaErrorInvalidValue;
  switch (variant) {
    case 0:
      return launch_pair<T>(xq, ldx, xs, wq, ldw, ws, bias, res, out, M, N,
                            K, st);
    case 1:
      return launch_split<T>(xq, ldx, xs, wq, ldw, ws, bias, res, out, M, N,
                             K, splits, st);
    case 2:
      if constexpr (sizeof(T) == 4)
        return launch_serial(xq, ldx, xs, wq, ldw, ws, bias, res, out, M, N,
                             K, st);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

// info[0] the dynamic shared memory a block asks for, info[1] the ring's
// stages, info[2] the blocks of a cluster (1: none; the split kernel's
// most), info[3] the blocks the card holds at once (a CUDA error negated;
// 0 for the split kernel, which is not persistent).
template <typename T>
int gemm_info(int variant, int* info) {
  switch (variant) {
    case 0: {
      info[0] = (int)Plan<T>::kSmem;
      info[1] = Plan<T>::kStages;
      info[2] = 2;
      const int n = max_clusters<T>();
      info[3] = n < 0 ? n : 2 * n;
      return 0;
    }
    case 1:
      info[0] = (int)SplitPlan::kSmem;
      info[1] = SplitPlan::kStages;
      info[2] = kMaxSplits;
      info[3] = 0;
      return 0;
    case 2:
      if (sizeof(T) != 4) return (int)cudaErrorInvalidValue;
      info[0] = (int)SerialPlan::kSmem;
      info[1] = SerialPlan::kStages;
      info[2] = 1;
      info[3] = serial_blocks();
      return 0;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// G1. x_q [M, K] int8 with rows ldx bytes apart, xs [M] f32, w_q [N, K]
// int8 with rows ldw bytes apart, ws [N] f32, bias [N] f32 or null, res
// [M, N] of the output's dtype or null, out [M, N] contiguous; x_q, w_q,
// res and out 16-byte aligned; K % 16 == 0, ldx and ldw multiples of 16 at
// least K, N % 8 == 0. f32 selects f32 res and out (else bf16); variant as
// above, splits the split-K variant's blocks a tile (1..8, at most K's
// 128-byte tiles). Launches on `stream`; returns a CUDA error code (0 on
// success).
extern "C" int hirest_int8_gemm(const void* xq, long long ldx, const void* xs,
                                const void* wq, long long ldw, const void* ws,
                                const void* bias, const void* res, void* out,
                                int M, int N, int K, int f32, int variant,
                                int splits, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(f32 ? gemm<float>(xq, ldx, xs, wq, ldw, ws, bias, res, out, M,
                                 N, K, variant, splits, st)
                   : gemm<__nv_bfloat16>(xq, ldx, xs, wq, ldw, ws, bias, res,
                                         out, M, N, K, variant, splits, st));
}

// A variant's shared memory, stages, cluster and resident blocks (bf16 or
// f32 out) into info[0..3], as gemm_info says; returns a CUDA error code
// (cudaErrorInvalidValue for a variant without that output dtype).
extern "C" int hirest_int8_gemm_info(int variant, int f32, int* info) {
  const int err = f32 ? gemm_info<float>(variant, info)
                      : gemm_info<__nv_bfloat16>(variant, info);
  return err != 0 ? err : (int)cudaGetLastError();
}

extern "C" const char* hirest_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
