// G1: the int8 projections of the int8 towers, whole: an s8 x s8 -> s32
// product on wgmma fed by TMA, with E3's dequant, bias and residual in its
// epilogue. The int32 accumulator never leaves registers.
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
// against 233 MB, 0.070 ms: bound by bytes. Before G1 the port wrote the
// int32 product to device memory (556 MB at qkv's shape) and E3 read it
// back.
//
// Design. A block computes 128 x BN output tiles, BN = 256 or 128 (every N
// of the towers is a multiple of 128; a ragged N is masked): one producer
// warp whose one thread keeps a ring of 128-byte-deep K tiles full by TMA
// (128-byte swizzle, one full and one empty mbarrier a stage), and two
// consumer warpgroups of 64 rows each running wgmma.mma_async (m64n128k32
// or m64n256k32, s8 x s8 -> s32) with both operands K-major in shared
// memory, the only layout 8-bit wgmma takes, as x_q and w_q already are.
// TMA zero-fills rows past M or N and columns past K (K % 16 == 0, for
// TMA's 16-byte row pitch), so G1 takes any M >= 1; stores past M or N are
// masked. Persistent blocks walk the output tiles gridDim.x apart, the N
// tiles of a row tile adjacent (the row tile's x_q comes from L2 after its
// first read, w_q stays in L2); a block's producer loads the next tile's
// K tiles while its consumers run this one's epilogue (on an H100 this
// beat one block a tile by 5-12 % on the bf16 products). The epilogue:
// each tile's ws and bias in shared memory, loaded before its main loop;
// in bf16 the dequantized tile is staged in shared memory (rows 16 bytes
// longer than the tile: conflict-free) and leaves in 16-byte coalesced
// stores, the residual read the same way; in f32 a thread's two adjacent
// values are one 8-byte store and a quad of threads fills a 32-byte
// sector, so the tile leaves from registers. Two variants: 256-wide tiles, one block an
// SM (the deep products, whose wgmma work outweighs the epilogue), and
// 128-wide tiles, two blocks an SM (the shallow ones whose epilogue reads
// a residual: one block's epilogue runs beside the other's products);
// ops/quant.py::int8_gemm_config picks one as chip_smoke.py
// --time-int8-gemm measured them.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "int8_dequant.cuh"

namespace {

constexpr int kBM = 128;           // rows a tile: two consumer warpgroups
constexpr int kBK = 128;           // K bytes a ring stage: one swizzle row
constexpr int kKStep = 32;         // K bytes a wgmma
constexpr int kConsumers = 256;    // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kATile = kBM * kBK;  // 16 KB of x_q a stage
// shared memory a block may take with one or two blocks an SM (each
// block's 1 KB of reserved shared memory left out)
constexpr int kSmemOne = 232448;
constexpr int kSmemTwo = 115712;

// The layout of a block's shared memory for tile width BN, output T and
// kBlocks blocks an SM: the ring takes what the staging tile, the ws and
// bias rows and the barriers leave.
template <int BN, typename T, int kBlocks>
struct Layout {
  static constexpr int kBTile = BN * kBK;  // w_q a stage
  static constexpr int kStage = kATile + kBTile;
  static constexpr bool kStaged = sizeof(T) == 2;  // bf16 leaves staged
  static constexpr int kRow = BN + 8;  // bf16 values a staged row
  static constexpr int kStaging = kStaged ? kBM * kRow * 2 : 0;
  static constexpr int kRows = 2 * BN * 4;  // ws and bias, f32
  static constexpr int kBudget = (kBlocks == 1 ? kSmemOne : kSmemTwo) -
                                 1024 - kStaging - kRows - 16 * 8;
  static constexpr int kStages = kBudget / kStage < 8 ? kBudget / kStage : 8;
  static constexpr size_t kSmem = 1024 + (size_t)kStages * kStage +
                                  kStaging + kRows +
                                  2 * kStages * sizeof(uint64_t);
  static_assert(kStages >= 2, "a ring of at least two stages");
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

template <int BN, typename T, int kBlocks>
__global__ void __launch_bounds__(kThreads, kBlocks)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w,
                     const float* __restrict__ xs,
                     const float* __restrict__ ws,
                     const float* __restrict__ bias,
                     const T* __restrict__ res, T* __restrict__ out, int M,
                     int N, int K) {
  using L = Layout<BN, T, kBlocks>;
  constexpr int kS = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* a_s = smem;                               // [stage][128][128]
  uint8_t* b_s = a_s + kS * kATile;                  // [stage][BN][128]
  uint8_t* staging = b_s + kS * L::kBTile;           // [128][kRow] bf16
  float* ws_s = reinterpret_cast<float*>(staging + L::kStaging);  // [BN]
  float* bias_s = ws_s + BN;                                      // [BN]
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
    // producer: one thread keeps the ring full, tile after tile
    if (threadIdx.x == kConsumers) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * kBM, n0 = tile % n_tiles * BN;
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int s = it % kS;
          if (it >= kS) mbar_wait(&empty[s], (it / kS - 1) & 1);
          mbar_expect_tx(&full[s], L::kStage);
          tma_load(a_s + s * kATile, &tm_x, &full[s], kt * kBK, m0);
          tma_load(b_s + s * L::kBTile, &tm_w, &full[s], kt * kBK, n0);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4;  // and r0 + 8
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

    // the main loop: a stage is released once the group after it has been
    // issued and its own has retired
    for (int kt = 0; kt < k_tiles; ++kt, ++it) {
      const int s = it % kS;
      mbar_wait(&full[s], (it / kS) & 1);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBK / kKStep; ++k)
        wgmma_s8<BN>(acc, smem_desc(a0 + s * kATile + k * kKStep),
                     smem_desc(b0 + s * L::kBTile + k * kKStep), kt | k);
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

    if constexpr (L::kStaged) {
      // bf16: dequantize into the staging tile, then 16-byte stores
      __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(staging);
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int c = 8 * i + 2 * (lane % 4);
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
        *reinterpret_cast<uint32_t*>(st + r0 * L::kRow + c) =
            bf16_pack(v00, v01);
        *reinterpret_cast<uint32_t*>(st + (r0 + 8) * L::kRow + c) =
            bf16_pack(v10, v11);
      }
      named_barrier_sync(2 + wg, 128);  // this warpgroup's 64 rows staged
      constexpr int kChunks = BN / 8;   // 16-byte chunks a row
      for (int v = threadIdx.x % 128; v < 64 * kChunks; v += 128) {
        const int r = wg * 64 + v / kChunks, ch = v % kChunks;
        const int row = m0 + r, col = n0 + ch * 8;
        if (row >= M || col >= N) continue;
        uint4 y = *reinterpret_cast<const uint4*>(st + r * L::kRow + ch * 8);
        const size_t at = (size_t)row * N + col;
        if (res != nullptr) {
          const uint4 x = __ldg(reinterpret_cast<const uint4*>(res + at));
          const uint32_t xv[4] = {x.x, x.y, x.z, x.w};
          uint32_t yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            yv[e] = bf16_pack(
                int8_residual_sum<__nv_bfloat16>(bf16_lo(xv[e]),
                                                 bf16_lo(yv[e])),
                int8_residual_sum<__nv_bfloat16>(bf16_hi(xv[e]),
                                                 bf16_hi(yv[e])));
          y = make_uint4(yv[0], yv[1], yv[2], yv[3]);
        }
        *reinterpret_cast<uint4*>(out + at) = y;
      }
    } else {
      // f32: each thread's two adjacent values, 8 bytes, from registers
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
        if (row0 < M) {
          const size_t at = (size_t)row0 * N + col;
          if (res != nullptr) {
            const float2 x = __ldg(reinterpret_cast<const float2*>(res + at));
            v00 = int8_residual_sum<float>(x.x, v00);
            v01 = int8_residual_sum<float>(x.y, v01);
          }
          *reinterpret_cast<float2*>(out + at) = make_float2(v00, v01);
        }
        if (row1 < M) {
          const size_t at = (size_t)row1 * N + col;
          if (res != nullptr) {
            const float2 x = __ldg(reinterpret_cast<const float2*>(res + at));
            v10 = int8_residual_sum<float>(x.x, v10);
            v11 = int8_residual_sum<float>(x.y, v11);
          }
          *reinterpret_cast<float2*>(out + at) = make_float2(v10, v11);
        }
      }
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

template <int BN, typename T, int kBlocks>
cudaError_t launch(const void* xq, long long ldx, const void* xs,
                   const void* wq, long long ldw, const void* ws,
                   const void* bias, const void* res, void* out, int M, int N,
                   int K, cudaStream_t st) {
  using L = Layout<BN, T, kBlocks>;
  const auto kernel = int8_gemm_kernel<BN, T, kBlocks>;
  // the shared-memory opt-in and the blocks an SM, once an instantiation
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem);
  if (opt_in != cudaSuccess) return opt_in;
  static int per_sm = -1;
  if (per_sm < 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, L::kSmem);
    if (err != cudaSuccess) return err;
  }
  const int sms = sm_count();
  if (sms <= 0 || per_sm <= 0) return cudaErrorInvalidConfiguration;
  CUtensorMap tm_x, tm_w;
  cudaError_t err = s8_map(&tm_x, xq, M, K, ldx, kBM);
  if (err == cudaSuccess) err = s8_map(&tm_w, wq, N, K, ldw, BN);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((M + kBM - 1) / kBM) * ((N + BN - 1) / BN);
  const long long most = (long long)sms * per_sm;
  const unsigned grid = (unsigned)(most < tiles ? most : tiles);
  kernel<<<grid, kThreads, L::kSmem, st>>>(
      tm_x, tm_w, static_cast<const float*>(xs),
      static_cast<const float*>(ws), static_cast<const float*>(bias),
      static_cast<const T*>(res), static_cast<T*>(out), M, N, K);
  return cudaGetLastError();
}

// The variants, by number: 0 tiles 256 wide, one block an SM; 1 tiles 128
// wide, two blocks an SM.
template <typename T>
cudaError_t gemm(const void* xq, long long ldx, const void* xs,
                 const void* wq, long long ldw, const void* ws,
                 const void* bias, const void* res, void* out, int M, int N,
                 int K, int variant, cudaStream_t st) {
  if (M <= 0 || N <= 0 || N % 8 || K <= 0 || K % 16 || ldx < K ||
      ldx % 16 || ldw < K || ldw % 16 || !xq || !xs || !wq || !ws || !out ||
      !aligned(xq, 16) || !aligned(wq, 16) || !aligned(out, 16) ||
      (res && !aligned(res, 16)))
    return cudaErrorInvalidValue;
  switch (variant) {
    case 0:
      return launch<256, T, 1>(xq, ldx, xs, wq, ldw, ws, bias, res, out, M,
                               N, K, st);
    case 1:
      return launch<128, T, 2>(xq, ldx, xs, wq, ldw, ws, bias, res, out, M,
                               N, K, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
size_t smem_bytes(int variant) {
  switch (variant) {
    case 0:
      return Layout<256, T, 1>::kSmem;
    case 1:
      return Layout<128, T, 2>::kSmem;
    default:
      return 0;
  }
}

}  // namespace

// G1. x_q [M, K] int8 with rows ldx bytes apart, xs [M] f32, w_q [N, K]
// int8 with rows ldw bytes apart, ws [N] f32, bias [N] f32 or null, res
// [M, N] of the output's dtype or null, out [M, N] contiguous; x_q, w_q,
// res and out 16-byte aligned; K % 16 == 0, ldx and ldw multiples of 16 at
// least K, N % 8 == 0. f32 selects f32 res and out (else bf16); variant
// as above. Launches on `stream`; returns a CUDA error code (0 on
// success).
extern "C" int hirest_int8_gemm(const void* xq, long long ldx, const void* xs,
                                const void* wq, long long ldw, const void* ws,
                                const void* bias, const void* res, void* out,
                                int M, int N, int K, int f32, int variant,
                                void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(f32 ? gemm<float>(xq, ldx, xs, wq, ldw, ws, bias, res, out, M,
                                 N, K, variant, st)
                   : gemm<__nv_bfloat16>(xq, ldx, xs, wq, ldw, ws, bias, res,
                                         out, M, N, K, variant, st));
}

// Dynamic shared memory a block of a variant asks for (bf16 or f32 out).
extern "C" int hirest_int8_gemm_smem_bytes(int variant, int f32) {
  return (int)(f32 ? smem_bytes<float>(variant)
                   : smem_bytes<__nv_bfloat16>(variant));
}

extern "C" const char* hirest_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
