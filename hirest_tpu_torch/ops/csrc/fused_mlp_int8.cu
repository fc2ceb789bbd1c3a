// K4: the int8 MLP of the EVA trunk: fc1 -> activation -> per-(row, chunk)
// int8 requant -> fc2 -> + bias + residual, as two warp-specialised wgmma
// kernels fed by TMA.
//
// Replaces hirest_tpu/ops/quant.py::fused_mlp_int8 (kernel body
// _fused_mlp_kernel). With h_q [M, C] int8 and row scales h_s, w1 [F, C] and
// w2 [C, F] int8 (nn.Linear's [out, in] layout, contiguous along the reduced
// axis) with channel scales s1 [F], s2 [C], biases b1, b2 and the residual
// x [M, C] bf16, for each 1024-unit chunk j of the F hidden units:
//   y    = act(((f32(h_q w1^T) * h_s) * s1) + b1)                (f32)
//   sc_j = max(max|y| / 127, 1e-8) per (row, chunk)
//   q2   = clamp(round_half_even(y / sc_j), -127, 127)
//   t_j  = (f32(q2 w2^T) * sc_j) * s2
//   out  = bf16(((x + b2) + t_0) + t_1 + ...)         (in chunk order)
// Products are exact in int32; every f32 step is rounded where the
// reference rounds it (__fmul_rn / __fadd_rn keep nvcc from contracting
// them into FMAs), so the codes, the scales and the output match the plain
// version bit for bit.
//
// Bound on an H100 SXM (EVA-g, M = 128 * 257 = 32896, C = 1408, F = 6144):
// 1.138 TOP of int8 products, 0.575 ms at 1979 TOP/s dense int8, against
// 249 MB that the function must move (h_q, x, out and 17.3 MB of weights),
// 0.074 ms at 3.35 TB/s. It is bound by operations.
//
// Why two kernels. The requant scale of a row needs all 1024 fc1 values of
// its chunk before the first code, and fc2's running sum of a 128-row tile
// is 128 x 1408 f32 (720 KB): more than an SM's registers or shared memory.
// The TPU kept both in VMEM; one Hopper block cannot, and a single launch
// would carry the sum through an f32 [M, C] workspace (1.85 GB of traffic a
// call). Splitting at the hidden codes costs an int8 [M, F] tensor and
// [M, F/1024] f32 scales, written once and read once (404 MB), and makes
// each half an ordinary GEMM with its own epilogue:
//
// - mlp_hidden (K4a): codes = requant(act(fc1)), scales. A block computes
//   128 rows x 128 hidden units; a cluster of 8 blocks along the hidden
//   axis covers one 1024-unit chunk and exchanges its rows' partial maxima
//   through distributed shared memory, so each block has the exact row max
//   of the chunk before it writes its codes (staged in shared memory, then
//   16-byte coalesced stores). The cluster's rank-0 block writes the scale.
//   The epilogue (the GELU polynomial and an IEEE division a value, ~45
//   instructions) takes about as long as the main loop, so the block is
//   small enough (101 KB of shared memory, 112 registers a thread) that two
//   run on an SM and one's epilogue overlaps the other's products.
// - mlp_out (K4b): out = fold(codes w2^T). A block computes 128 rows x 176
//   columns over all F; after every 1024 of K (8 tiles) the int32 partial
//   is folded into an f32 running sum in registers, started at x + b2, in
//   the reference's order, and rounded to bf16 at the end.
//
// Both: one producer (one thread issues the TMA loads into a ring of
// 128-byte-deep K tiles with 128-byte swizzle, one full and one empty
// mbarrier a stage) and two consumer warpgroups of 64 rows each, running
// wgmma.mma_async (m64n128k32 / m64n176k32, s8 x s8 -> s32) with both
// operands K-major in shared memory. TMA zero-fills rows past M; stores
// past M are masked. The column tiles of a row tile are adjacent in launch
// order, so its h_q or codes rows come from L2 after the first block, and
// the weights (8.65 MB each) stay in L2. (Multicasting the A tiles across
// a cluster cut the L2 reads by a quarter and made both kernels slower:
// the main loops are not bound by L2.)

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gelu.cuh"
#include "hopper.cuh"

namespace {

constexpr int kC = 1408;    // trunk width: fc1's depth, fc2's width
constexpr int kNC = 1024;   // hidden units per chunk (one requant scale a row)
constexpr int kBM = 128;    // rows per block: two consumer warpgroups of 64
constexpr int kBK = 128;    // K bytes per tile: one 128-byte swizzle row
constexpr int kKStep = 32;  // K bytes per wgmma
constexpr int kConsumerWarps = 8;  // two consumer warpgroups
constexpr int kATile = kBM * kBK;  // 16 KB of h_q or codes a stage

// mlp_hidden: two blocks an SM, so that one block's epilogue runs beside
// the other's main loop
constexpr int kThreads1 = 256 + 32;       // consumers and one producer warp
constexpr int kBN1 = 128;                 // hidden units a block
constexpr int kCluster = kNC / kBN1;      // blocks a chunk: 8
constexpr int kStages1 = 3;
constexpr int kB1Tile = kBN1 * kBK;       // 16 KB of w1 a stage
constexpr int kCodeStride = kBN1 + 16;    // bytes a staged row of codes
constexpr size_t kSmem1 = 1024 + (size_t)kStages1 * (kATile + kB1Tile) +
                          2 * kStages1 * sizeof(uint64_t) +
                          (size_t)kCluster * kBM * sizeof(float);
static_assert(kC % kBK == 0, "fc1 K tiles");
static_assert(kBM * kCodeStride <= kStages1 * (kATile + kB1Tile),
              "the staged codes reuse the ring");

// mlp_out: one block an SM; setmaxnreg gives the producer warpgroup's
// registers to the consumers, which hold 88 int32 and 88 f32 values each
constexpr int kThreads2 = 3 * 128;  // two consumer warpgroups, one producer
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kBN2 = 176;                 // output columns a block: 1408 / 8
constexpr int kStages2 = 5;
constexpr int kB2Tile = kBN2 * kBK;       // 22 KB of w2 a stage
constexpr int kChunkTiles = kNC / kBK;    // K tiles a chunk: 8
constexpr size_t kSmem2 = 1024 + (size_t)kStages2 * (kATile + kB2Tile) +
                          2 * kStages2 * sizeof(uint64_t);
static_assert(kC % kBN2 == 0 && kB2Tile % 1024 == 0, "fc2 column tiles");

// D[64 x 128] (+)= A[64 x 32] * B[128 x 32]^T, s8 x s8 -> s32; both operands
// K-major in shared memory (128-byte swizzle), D in 64 registers a thread.
__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da,
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
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 176] (+)= A[64 x 32] * B[176 x 32]^T, s8 x s8 -> s32; both operands
// K-major in shared memory (128-byte swizzle), D in 88 registers a thread.
__device__ __forceinline__ void wgmma_n176(int (&d)[88], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %90, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n176k32.s32.s8.s8 {"
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
      "%80, %81, %82, %83, %84, %85, %86, %87"
      "}, %88, %89, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87])
      : "l"(da), "l"(db), "r"(accumulate));
}


template <int kAct>
__device__ __forceinline__ float fc1_value(int acc, float hs, float s1,
                                           float b1) {
  const float y = __fadd_rn(__fmul_rn(__fmul_rn((float)acc, hs), s1), b1);
  if constexpr (kAct == 0) {
    return gelu_poly(y);
  } else {
    return gelu_erf(y);
  }
}

__device__ __forceinline__ int code(float y, float sc) {
  return max(-127, min(127, __float2int_rn(__fdiv_rn(y, sc))));
}

// Accumulator layout of a consumer thread (wgmma's D fragment): register
// 4i + e holds row r0 + 8 * (e / 2) and column 8i + 2 * (lane % 4) + e % 2
// of its warpgroup's 64-row tile, r0 = 16 * (warp % 4) + lane / 4.

// --- K4a: codes and scales of the hidden units ---------------------------

template <int kAct>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads1, 2)
    fused_mlp_int8_hidden_kernel(const __grid_constant__ CUtensorMap tm_hq,
                                 const __grid_constant__ CUtensorMap tm_w1,
                                 const float* __restrict__ hs,
                                 const float* __restrict__ s1,
                                 const float* __restrict__ b1,
                                 int8_t* __restrict__ codes,
                                 float* __restrict__ scales, int M, int F) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* a_s = smem;                                 // [stage][128][128]
  uint8_t* b_s = smem + kStages1 * kATile;             // [stage][128][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(b_s + kStages1 * kB1Tile);
  uint64_t* empty = full + kStages1;
  float* red = reinterpret_cast<float*>(empty + kStages1);  // [rank][128]

  const int n0 = blockIdx.x * kBN1, m0 = blockIdx.y * kBM;
  constexpr int kTiles = kC / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages1; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_arrive_relaxed();  // waited on before the first remote store

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread keeps the ring full
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < kTiles; ++kt) {
        const int s = kt % kStages1;
        if (kt >= kStages1) mbar_wait(&empty[s], (kt / kStages1 - 1) & 1);
        mbar_expect_tx(&full[s], kATile + kB1Tile);
        tma_load(a_s + s * kATile, &tm_hq, &full[s], kt * kBK, m0);
        tma_load(b_s + s * kB1Tile, &tm_w1, &full[s], kt * kBK, n0);
      }
    }
    __syncwarp();
    cluster_wait();
    cluster_arrive();
    cluster_wait();
  } else {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    int acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    const uint32_t a0 = smem_u32(a_s) + wg * 64 * kBK, b0 = smem_u32(b_s);
    for (int kt = 0; kt < kTiles; ++kt) {
      const int s = kt % kStages1;
      mbar_wait(&full[s], (kt / kStages1) & 1);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBK / kKStep; ++k)
        wgmma_n128(acc, smem_desc(a0 + s * kATile + k * kKStep),
                   smem_desc(b0 + s * kB1Tile + k * kKStep), kt | k);
      wgmma_commit();
      wgmma_wait<1>();
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % kStages1]);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // dequantize, activate, and take each row's partial max
    const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4;  // and r0 + 8
    const float hs0 = m0 + r0 < M ? hs[m0 + r0] : 0.f;
    const float hs1 = m0 + r0 + 8 < M ? hs[m0 + r0 + 8] : 0.f;
    float mx0 = 0.f, mx1 = 0.f;
#pragma unroll
    for (int i = 0; i < kBN1 / 8; ++i) {
      const int n = n0 + 8 * i + 2 * (lane % 4);
      const float2 sv = __ldg(reinterpret_cast<const float2*>(s1 + n));
      const float2 bv = __ldg(reinterpret_cast<const float2*>(b1 + n));
      const float y0 = fc1_value<kAct>(acc[4 * i], hs0, sv.x, bv.x);
      const float y1 = fc1_value<kAct>(acc[4 * i + 1], hs0, sv.y, bv.y);
      const float y2 = fc1_value<kAct>(acc[4 * i + 2], hs1, sv.x, bv.x);
      const float y3 = fc1_value<kAct>(acc[4 * i + 3], hs1, sv.y, bv.y);
      mx0 = fmaxf(mx0, fmaxf(fabsf(y0), fabsf(y1)));
      mx1 = fmaxf(mx1, fmaxf(fabsf(y2), fabsf(y3)));
      acc[4 * i] = __float_as_int(y0);
      acc[4 * i + 1] = __float_as_int(y1);
      acc[4 * i + 2] = __float_as_int(y2);
      acc[4 * i + 3] = __float_as_int(y3);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }

    // every block of the cluster gets every block's partial maxima
    const uint32_t rank = cluster_rank();
    cluster_wait();  // the cluster's blocks have all started
    if (lane % 4 == 0) {
#pragma unroll
      for (uint32_t dst = 0; dst < kCluster; ++dst) {
        st_cluster(&red[rank * kBM + r0], dst, mx0);
        st_cluster(&red[rank * kBM + r0 + 8], dst, mx1);
      }
    }
    cluster_arrive();
    cluster_wait();
    float amax0 = red[r0], amax1 = red[r0 + 8];
#pragma unroll
    for (int q = 1; q < kCluster; ++q) {
      amax0 = fmaxf(amax0, red[q * kBM + r0]);
      amax1 = fmaxf(amax1, red[q * kBM + r0 + 8]);
    }
    const float sc0 = fmaxf(__fdiv_rn(amax0, 127.f), 1e-8f);
    const float sc1 = fmaxf(__fdiv_rn(amax1, 127.f), 1e-8f);
    const int n_chunks = F / kNC;
    if (rank == 0 && lane % 4 == 0) {
      const int chunk = blockIdx.x / kCluster;
      if (m0 + r0 < M) scales[(size_t)(m0 + r0) * n_chunks + chunk] = sc0;
      if (m0 + r0 + 8 < M)
        scales[(size_t)(m0 + r0 + 8) * n_chunks + chunk] = sc1;
    }

    // codes: staged in the (now idle) ring, then 16-byte stores
    uint8_t* cs = smem;
#pragma unroll
    for (int i = 0; i < kBN1 / 8; ++i) {
      const int c = 8 * i + 2 * (lane % 4);
      const uint32_t lo =
          (uint32_t)(uint8_t)code(__int_as_float(acc[4 * i]), sc0) |
          (uint32_t)(uint8_t)code(__int_as_float(acc[4 * i + 1]), sc0) << 8;
      const uint32_t hi =
          (uint32_t)(uint8_t)code(__int_as_float(acc[4 * i + 2]), sc1) |
          (uint32_t)(uint8_t)code(__int_as_float(acc[4 * i + 3]), sc1) << 8;
      *reinterpret_cast<uint16_t*>(cs + r0 * kCodeStride + c) = (uint16_t)lo;
      *reinterpret_cast<uint16_t*>(cs + (r0 + 8) * kCodeStride + c) =
          (uint16_t)hi;
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");  // consumers only
    constexpr int kRowVecs = kBN1 / 16;
    for (int v = threadIdx.x; v < kBM * kRowVecs; v += 256) {
      const int r = v / kRowVecs, part = v % kRowVecs;
      if (m0 + r < M)
        *reinterpret_cast<uint4*>(codes + (size_t)(m0 + r) * F + n0 +
                                  part * 16) =
            *reinterpret_cast<const uint4*>(cs + r * kCodeStride + part * 16);
    }
  }
}

// --- K4b: fc2 over the codes, folded chunk by chunk ----------------------

// The residual x and the output in bf16 (the int8 trunk) or f32 (the f32
// int8 factory, whose JAX kernel computes in the dtype it is given).
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads2, 1)
    fused_mlp_int8_out_kernel(const __grid_constant__ CUtensorMap tm_codes,
                              const __grid_constant__ CUtensorMap tm_w2,
                              const float* __restrict__ scales,
                              const float* __restrict__ s2,
                              const float* __restrict__ b2,
                              const T* __restrict__ x,
                              T* __restrict__ out, int M, int F) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* a_s = smem;                                 // [stage][128][128]
  uint8_t* b_s = smem + kStages2 * kATile;             // [stage][176][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(b_s + kStages2 * kB2Tile);
  uint64_t* empty = full + kStages2;

  const int n0 = blockIdx.x * kBN2, m0 = blockIdx.y * kBM;
  const int tiles = F / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages2; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < tiles; ++kt) {
        const int s = kt % kStages2;
        if (kt >= kStages2) mbar_wait(&empty[s], (kt / kStages2 - 1) & 1);
        mbar_expect_tx(&full[s], kATile + kB2Tile);
        tma_load(a_s + s * kATile, &tm_codes, &full[s], kt * kBK, m0);
        tma_load(b_s + s * kB2Tile, &tm_w2, &full[s], kt * kBK, n0);
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4;  // and r0 + 8
    const bool ok0 = m0 + r0 < M, ok1 = m0 + r0 + 8 < M;
    const int n_chunks = F / kNC;

    // the running sum starts at x + b2
    float run[88];
#pragma unroll
    for (int i = 0; i < 22; ++i) {
      const int n = n0 + 8 * i + 2 * (lane % 4);
      const float2 bv = __ldg(reinterpret_cast<const float2*>(b2 + n));
      float2 x0 = make_float2(0.f, 0.f), x1 = x0;
      if (ok0) x0 = load2(x + (size_t)(m0 + r0) * kC + n);
      if (ok1) x1 = load2(x + (size_t)(m0 + r0 + 8) * kC + n);
      run[4 * i] = __fadd_rn(x0.x, bv.x);
      run[4 * i + 1] = __fadd_rn(x0.y, bv.y);
      run[4 * i + 2] = __fadd_rn(x1.x, bv.x);
      run[4 * i + 3] = __fadd_rn(x1.y, bv.y);
    }

    int acc[88];
#pragma unroll
    for (int i = 0; i < 88; ++i) acc[i] = 0;
    const uint32_t a0 = smem_u32(a_s) + wg * 64 * kBK, b0 = smem_u32(b_s);
    for (int chunk = 0; chunk < n_chunks; ++chunk) {
      // the chunk's 8 K tiles, one wgmma group each; a stage is released
      // once the group after it has been issued and its own has retired
#pragma unroll
      for (int t = 0; t < kChunkTiles; ++t) {
        const int kt = chunk * kChunkTiles + t, s = kt % kStages2;
        mbar_wait(&full[s], (kt / kStages2) & 1);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kBK / kKStep; ++k)
          wgmma_n176(acc, smem_desc(a0 + s * kATile + k * kKStep),
                     smem_desc(b0 + s * kB2Tile + k * kKStep), t | k);
        wgmma_commit();
        if (t > 0) {
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(&empty[(kt - 1) % kStages2]);
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0)
        mbar_arrive(&empty[((chunk + 1) * kChunkTiles - 1) % kStages2]);

      // the chunk's partial is complete: fold it into the running sum
      const float sc0 =
          ok0 ? scales[(size_t)(m0 + r0) * n_chunks + chunk] : 0.f;
      const float sc1 =
          ok1 ? scales[(size_t)(m0 + r0 + 8) * n_chunks + chunk] : 0.f;
#pragma unroll
      for (int i = 0; i < 22; ++i) {
        const int n = n0 + 8 * i + 2 * (lane % 4);
        const float2 sv = __ldg(reinterpret_cast<const float2*>(s2 + n));
        run[4 * i] = __fadd_rn(
            run[4 * i], __fmul_rn(__fmul_rn((float)acc[4 * i], sc0), sv.x));
        run[4 * i + 1] =
            __fadd_rn(run[4 * i + 1],
                      __fmul_rn(__fmul_rn((float)acc[4 * i + 1], sc0), sv.y));
        run[4 * i + 2] =
            __fadd_rn(run[4 * i + 2],
                      __fmul_rn(__fmul_rn((float)acc[4 * i + 2], sc1), sv.x));
        run[4 * i + 3] =
            __fadd_rn(run[4 * i + 3],
                      __fmul_rn(__fmul_rn((float)acc[4 * i + 3], sc1), sv.y));
      }
    }

#pragma unroll
    for (int i = 0; i < 22; ++i) {
      const int n = n0 + 8 * i + 2 * (lane % 4);
      if (ok0)
        store2(out + (size_t)(m0 + r0) * kC + n, run[4 * i], run[4 * i + 1]);
      if (ok1)
        store2(out + (size_t)(m0 + r0 + 8) * kC + n, run[4 * i + 2],
               run[4 * i + 3]);
    }
  }
}

// --- host ----------------------------------------------------------------

// The tensor map of a row-major int8 [rows, cols] matrix read in boxes of
// 128 bytes by box_rows rows, 128-byte swizzled; rows past the end read
// as zeros.
cudaError_t int8_map(CUtensorMap* map, const void* base, int rows, int cols,
                     int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorInitializationError;
  if (reinterpret_cast<uintptr_t>(base) % 16) return cudaErrorMisalignedAddress;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int kAct>
cudaError_t launch_hidden(const CUtensorMap& hq, const CUtensorMap& w1,
                          const void* hs, const void* s1, const void* b1,
                          void* codes, void* scales, int M, int F,
                          cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_int8_hidden_kernel<kAct>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem1);
  if (err != cudaSuccess) return err;
  const dim3 grid(F / kBN1, (M + kBM - 1) / kBM);
  fused_mlp_int8_hidden_kernel<kAct><<<grid, kThreads1, kSmem1, stream>>>(
      hq, w1, static_cast<const float*>(hs), static_cast<const float*>(s1),
      static_cast<const float*>(b1), static_cast<int8_t*>(codes),
      static_cast<float*>(scales), M, F);
  return cudaGetLastError();
}

}  // namespace

// K4a. h_q [M, 1408] int8, h_s [M] f32, w1 [F, 1408] int8, s1/b1 [F] f32
// -> codes [M, F] int8 and scales [M, F / 1024] f32, all contiguous and
// 16-byte aligned; F a multiple of 1024. act 0 is gelu_bf16_poly, 1 exact
// GELU. Launches on `stream`; returns a CUDA error code (0 on success).
extern "C" int hirest_mlp_int8_hidden(const void* hq, const void* hs,
                                      const void* w1, const void* s1,
                                      const void* b1, void* codes,
                                      void* scales, int M, int F, int act,
                                      void* stream) {
  if (M <= 0 || F <= 0 || F % kNC || (act != 0 && act != 1))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_hq, tm_w1;
  cudaError_t err = int8_map(&tm_hq, hq, M, kC, kBM);
  if (err == cudaSuccess) err = int8_map(&tm_w1, w1, F, kC, kBN1);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(act == 0 ? launch_hidden<0>(tm_hq, tm_w1, hs, s1, b1, codes,
                                           scales, M, F, st)
                        : launch_hidden<1>(tm_hq, tm_w1, hs, s1, b1, codes,
                                           scales, M, F, st));
}

namespace {

template <typename T>
int launch_out(const void* codes, const void* scales, const void* w2,
               const void* s2, const void* b2, const void* x, void* out, int M,
               int F, void* stream) {
  if (M <= 0 || F <= 0 || F % kNC) return (int)cudaErrorInvalidValue;
  CUtensorMap tm_codes, tm_w2;
  cudaError_t err = int8_map(&tm_codes, codes, M, F, kBM);
  if (err == cudaSuccess) err = int8_map(&tm_w2, w2, kC, F, kBN2);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fused_mlp_int8_out_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmem2);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(kC / kBN2, (M + kBM - 1) / kBM);
  fused_mlp_int8_out_kernel<T><<<grid, kThreads2, kSmem2,
                                 (cudaStream_t)stream>>>(
      tm_codes, tm_w2, static_cast<const float*>(scales),
      static_cast<const float*>(s2), static_cast<const float*>(b2),
      static_cast<const T*>(x), static_cast<T*>(out), M, F);
  return (int)cudaGetLastError();
}

}  // namespace

// K4b. codes [M, F] int8 and scales [M, F / 1024] f32 from K4a, w2
// [1408, F] int8, s2/b2 [1408] f32, x and out [M, 1408] bf16, all
// contiguous and 16-byte aligned; F a multiple of 1024. Launches on
// `stream`; returns a CUDA error code (0 on success).
extern "C" int hirest_mlp_int8_out(const void* codes, const void* scales,
                                   const void* w2, const void* s2,
                                   const void* b2, const void* x, void* out,
                                   int M, int F, void* stream) {
  return launch_out<__nv_bfloat16>(codes, scales, w2, s2, b2, x, out, M, F,
                                   stream);
}

// As above with x and out [M, 1408] f32.
extern "C" int hirest_mlp_int8_out_f32(const void* codes, const void* scales,
                                       const void* w2, const void* s2,
                                       const void* b2, const void* x,
                                       void* out, int M, int F,
                                       void* stream) {
  return launch_out<float>(codes, scales, w2, s2, b2, x, out, M, F, stream);
}

// Dynamic shared memory a block asks for: K4a (kernel 0) or K4b (1).
extern "C" int hirest_mlp_int8_smem_bytes(int kernel) {
  return (int)(kernel == 0 ? kSmem1 : kSmem2);
}

extern "C" const char* hirest_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
