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
// them into FMAs), and the quotients are __fdiv_rn's (rowquant.cuh), so the
// codes, the scales and the output match the plain version bit for bit.
//
// Bound on an H100 SXM (EVA-g, M = 128 * 257 = 32896, C = 1408, F = 6144):
// 1.138 TOP of int8 products, 0.575 ms at 1979 TOP/s dense int8, against
// 249 MB that the function must move (h_q, x, out and 17.3 MB of weights),
// 0.074 ms at 3.35 TB/s. It is bound by operations; each kernel does half
// of them (0.288 ms).
//
// Why two kernels. The requant scale of a row needs all 1024 fc1 values of
// its chunk before the first code, and fc2's running sum of a 128-row tile
// is 128 x 1408 f32 (720 KB): more than an SM's registers or shared memory.
// The TPU kept both in VMEM; one Hopper block cannot, and a single launch
// would carry the sum through an f32 [M, C] workspace (1.85 GB of traffic a
// call). Splitting at the hidden codes costs an int8 [M, F] tensor and
// [M, F/1024] f32 scales, written once and read once (404 MB), and makes
// each half an ordinary GEMM with its own epilogue.
//
// mlp_hidden (K4a): codes = requant(act(fc1)), scales. Its epilogue (the
// dequant, the GELU polynomial, the row max, a quotient and a code a
// value: ~37 instructions, one dependent chain of ~28 a value) is as heavy
// as a GEMM's epilogue gets, so the design is built around running it
// beside the products.
// - Ping-pong. A block has two consumer warpgroups, each owning whole
//   128 x 128 tiles (two wgmma.mma_async m64n128k32, s8 x s8 -> s32, a K
//   step, both operands K-major in shared memory; 128 accumulators a
//   thread), and a producer warpgroup: one thread keeps a
//   ring of 6 stages (128-byte-deep K tiles of 128 rows of h_q and 128 of
//   w1, 32 KB, 128-byte swizzle, one full and one empty mbarrier a stage)
//   full by TMA, and one warp a consumer stores its codes. The block's work
//   items go to its warpgroups in turns and the producer loads their stages
//   in that order. A warpgroup starts a main loop once the other has
//   waited on the last stage of its tile (an mbarrier, turn[wg]: a stage's
//   full barrier must be waited on one phase at a time), so one warpgroup's
//   products run while the other runs its epilogue. setmaxnreg gives the
//   producer warpgroup's registers to the consumers (40 / 232).
// - Persistent clusters of 8 blocks along the hidden axis, one block an
//   SM: a work item is (128-row tile, 1024-unit chunk), block r of the
//   cluster takes the chunk's r-th 128 units. The grid is min(work items,
//   clusters the card holds) clusters (cudaOccupancyMaxActiveClusters:
//   15 clusters of 8 = 120 SMs on an H100, the same SMs as clusters of 4;
//   clusters of 2 hold 132 but cannot cover a chunk).
// - The chunk maximum. After its main loop a warpgroup stages its tile's
//   s1 and b1 in shared memory, then, a 64-row half at a time, dequantizes
//   and activates the half in registers, takes its rows' partial maxima,
//   puts them in red[wg][tile parity] in its own shared memory and, after a
//   warpgroup barrier, its threads r < 8 arrive on block r's xfull[wg]
//   [parity][half] mbarrier (release at cluster scope). The second half's
//   work hides the first half's exchange. Once its own xfull has the
//   cluster's eight arrivals (acquire) it reads the eight blocks' maxima of
//   its rows (ld.shared::cluster). No barrier.cluster stalls a warp in its
//   main loop. A warpgroup writes a parity again only after the next tile's
//   exchange, which every sibling joins after reading.
// - Quotients by rowquant.cuh's code2_rint: row_quotient (__fdiv_rn's fast
//   path with the row's reciprocal hoisted; exact, as K2's, K5's and K3's)
//   rounded by an f32 addition, without the clamp: sc >= max|y| / 127, so
//   every quotient rounds into +-127.
// - Codes leave off the products' path: written, a 64-row half at a time,
//   into the warpgroup's 8 KB box (64 rows x 128 codes, 128-byte swizzled,
//   conflict-free for the accumulator layout) and stored by TMA by the
//   warpgroup's store warp, which hands the box back once the store has
//   read it. The cluster's rank-0 block writes the scales.
// - Registers: a half's codes are formed into registers before its box is
//   free, and each accumulator is zeroed once read (the next tile's first
//   wgmma ignores it), so the epilogue fits the registers setmaxnreg gives:
//   ptxas -v reports no spills (168 registers at launch).
// TMA zero-fills rows past M; the store map clips them, so any M >= 1.
//
// Why this shape, and what bounds it on the card (tools/k4_probe.py: p1 as
// is, p2 without the epilogue's arithmetic and code stores, p3 p2 with each
// stage's products issued twice; a clock64 trace a phase; PERF.md §6;
// H100 SXM at its 700 W cap). The first design lost 0.34 ms to an
// epilogue its products did not hide (p1 0.835-0.852, p2 0.504 ms) in a
// main loop that was not bound by the tensor cores (p3 0.69). Handing a
// tile to other warps, as G1's epilogue warp takes its staged tile, would
// need the int32 tile (64 KB at 128 x 128) in the shared memory the ring
// uses, so the accumulators stay with the warpgroup that computed them.
// 64 x 256 tiles a warpgroup (m64n256k32, clusters of 4) drew 9.5 KB of
// tiles a Mop into shared memory against 7.6 for 128 x 128, and their main
// loop was bound by that feed (p2 0.714, p3 0.699 ms); 128 x 128 tiles
// bring p2, the products and the exchange, to 0.466 ms, and that is where
// the gain over the first design lies: the epilogue not hidden, p1 - p2,
// is 0.32 ms against 0.34. Ping-pong still earns its barriers: the same
// kernel with both warpgroups on one tile, 64 rows each and no turns, takes
// 0.923 ms against 0.78-0.79, since a tile's products and its epilogue then
// run one after the other. Two pairs of such warpgroups taking tiles in
// turns (640 threads, 112 registers, a 5-stage ring) take 0.806-0.839 ms,
// and three ping-pong warpgroups at 160 registers spill and take 0.76-0.78
// ms: neither beats this form by more than the card's spread. The epilogue
// is what bounds it: alone, without the products, it takes 0.677 ms (about
// 0.35 instructions a cycle per scheduler with one or two epilogue warps
// on it), ~14k cycles a tile against ~10k for the tile's products, which
// slow from ~7.4k while an epilogue runs beside them. K4a takes 0.78-0.79
// ms against 0.84-0.85 for the first design. Each block asks for 218,320
// bytes of shared memory.
//
// mlp_out (K4b): out = fold(codes w2^T). A block computes 128 rows x 176
// columns over all F; after every 1024 of K (8 tiles) the int32 partial is
// folded into an f32 running sum in registers, started at x + b2, in the
// reference's order, and rounded to bf16 at the end. One producer
// warpgroup (setmaxnreg 24 / 240) and two consumer warpgroups of 64 rows,
// wgmma m64n176k32, a 5-stage ring; one block an SM. Its fold is a few
// operations a value once a chunk, not an epilogue to hide, and it holds 88
// accumulators and 88 sums a thread, so it keeps its design: at 1.9x its
// bound against K4a's 2.9x before this design, K4a was the larger loss.
// (Multicasting the A tiles across a cluster cut the L2 reads by a quarter
// and made the first design of both kernels slower: their main loops were
// not bound by L2.)

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gelu.cuh"
#include "hopper.cuh"
#include "rowquant.cuh"

namespace {

constexpr int kC = 1408;    // trunk width: fc1's depth, fc2's width
constexpr int kNC = 1024;   // hidden units per chunk (one requant scale a row)
constexpr int kBK = 128;    // K bytes per stage: one 128-byte swizzle row
constexpr int kKStep = 32;  // K bytes per wgmma
constexpr int kConsumerWarps = 8;  // two consumer warpgroups

// mlp_hidden: one block an SM: two consumer warpgroups taking tiles in
// turns, and a producer warpgroup whose first warp issues the loads and
// whose next two store each consumer's codes
constexpr int kThreads1 = 3 * 128;
constexpr int kProducerRegs1 = 40;
constexpr int kConsumerRegs1 = 232;
constexpr int kLoadWarp = kConsumerWarps;   // then a store warp a consumer
constexpr int kBM1 = 128;                 // rows a tile: one warpgroup's
constexpr int kBN1 = 128;                 // hidden units a tile (a block's)
constexpr int kCluster = kNC / kBN1;      // blocks a chunk: 8
constexpr int kTiles1 = kC / kBK;         // K stages a tile: 11
constexpr int kStages1 = 6;
constexpr int kA1Tile = kBM1 * kBK;       // 16 KB of h_q a stage
constexpr int kB1Tile = kBN1 * kBK;       // 16 KB of w1 a stage
constexpr int kCodeBox = 64 * kBN1;       // a half tile's codes: 64 rows
constexpr size_t kSmem1 = 1024 + (size_t)kStages1 * (kA1Tile + kB1Tile) +
                          2 * kCodeBox + 2 * 2 * (kBM1 + kBN1) * sizeof(float) +
                          (2 * kStages1 + 14) * sizeof(uint64_t);
static_assert(kC % kBK == 0 && kNC % kBN1 == 0 && kBN1 == 128,
              "fc1 tiles; a code box is one 128-byte swizzle row wide");
static_assert(kCluster <= 32, "one arrival a block from the first warp");

// mlp_out: one block an SM; setmaxnreg gives the producer warpgroup's
// registers to the consumers, which hold 88 int32 and 88 f32 values each
constexpr int kBM = 128;    // rows per block: two consumer warpgroups of 64
constexpr int kATile = kBM * kBK;  // 16 KB of codes a stage
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

#define K4_R8(d, i)                                                      \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),            \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

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
      : K4_R8(d, 0), K4_R8(d, 8), K4_R8(d, 16), K4_R8(d, 24), K4_R8(d, 32),
        K4_R8(d, 40), K4_R8(d, 48), K4_R8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 176] (+)= A[64 x 32] * B[176 x 32]^T, as above; D in 88 registers.
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
      : K4_R8(d, 0), K4_R8(d, 8), K4_R8(d, 16), K4_R8(d, 24), K4_R8(d, 32),
        K4_R8(d, 40), K4_R8(d, 48), K4_R8(d, 56), K4_R8(d, 64),
        K4_R8(d, 72), K4_R8(d, 80)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef K4_R8

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

// Accumulator layout of a consumer thread (wgmma's D fragment): register
// 4i + e holds row r0 + 8 * (e / 2) and column 8i + 2 * (lane % 4) + e % 2
// of its warpgroup's 64-row tile, r0 = 16 * (warp % 4) + lane / 4.

// --- K4a: codes and scales of the hidden units ---------------------------

// The low 16 bits of v at the shared-memory address addr.
__device__ __forceinline__ void st_shared_u16(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr), "h"((uint16_t)v)
               : "memory");
}

template <int kAct>
__global__ void __launch_bounds__(kThreads1, 1)
    fused_mlp_int8_hidden_kernel(const __grid_constant__ CUtensorMap tm_hq,
                                 const __grid_constant__ CUtensorMap tm_w1,
                                 const __grid_constant__ CUtensorMap tm_codes,
                                 const float* __restrict__ hs,
                                 const float* __restrict__ s1,
                                 const float* __restrict__ b1,
                                 float* __restrict__ scales, int M, int F) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* a_s = smem;                              // [stage][128][128]
  uint8_t* b_s = a_s + kStages1 * kA1Tile;          // [stage][128][128]
  uint8_t* boxes = b_s + kStages1 * kB1Tile;        // [wg][64][128] codes
  float* red = reinterpret_cast<float*>(boxes + 2 * kCodeBox);  // [wg][2][128]
  float* cols = red + 2 * 2 * kBM1;  // [wg][s1, b1][128]: a tile's columns
  uint64_t* full = reinterpret_cast<uint64_t*>(cols + 2 * 2 * kBN1);
  uint64_t* empty = full + kStages1;
  uint64_t* xfull = empty + kStages1;  // [wg][parity][half]: the maxima
  uint64_t* turn = xfull + 8;    // [wg]: its next main loop may start
  uint64_t* staged = turn + 2;   // [wg]: its code box is written
  uint64_t* stored = staged + 2;  // [wg]: and read by the store

  const int n_chunks = F / kNC;
  const int units = (M + kBM1 - 1) / kBM1 * n_chunks;
  const int rank = (int)cluster_rank();
  const int first = blockIdx.x / kCluster, stride = gridDim.x / kCluster;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages1; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // the consuming warpgroup's warps
    }
    for (int x = 0; x < 8; ++x) mbar_init(&xfull[x], kCluster);
    for (int x = 0; x < 2; ++x) {
      mbar_init(&turn[x], 4);  // a warpgroup's warps
      mbar_init(&staged[x], 4);
      mbar_init(&stored[x], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_arrive();  // the siblings' barriers are initialised
  cluster_wait();

  if (warp >= kConsumerWarps) {
    setmaxnreg_dec<kProducerRegs1>();
    if (warp == kLoadWarp && lane == 0) {
      // the block's work items in order, each one's K stages in order:
      // its warpgroups take the items in turns
      int it = 0;
      for (int u = first; u < units; u += stride) {
        const int m0 = u / n_chunks * kBM1;
        const int n0 = u % n_chunks * kNC + rank * kBN1;
        for (int kt = 0; kt < kTiles1; ++kt, ++it) {
          const int s = it % kStages1;
          if (it >= kStages1) mbar_wait(&empty[s], (it / kStages1 - 1) & 1);
          mbar_expect_tx(&full[s], kA1Tile + kB1Tile);
          tma_load(a_s + s * kA1Tile, &tm_hq, &full[s], kt * kBK, m0);
          tma_load(b_s + s * kB1Tile, &tm_w1, &full[s], kt * kBK, n0);
        }
      }
    } else if (warp <= kLoadWarp + 2 && lane == 0) {
      // consumer w's code boxes out by TMA, half a tile at a time, each
      // box's space handed back once the store has read it
      const int w = warp - kLoadWarp - 1;
      int k = 0;
      for (int u = first + w * stride; u < units; u += 2 * stride) {
        const int m0 = u / n_chunks * kBM1;
        const int n0 = u % n_chunks * kNC + rank * kBN1;
        for (int h = 0; h < 2; ++h, ++k) {
          mbar_wait(&staged[w], k & 1);
          // k4_probe: begin store
          if (m0 + 64 * h < M)
            tma_store(&tm_codes, boxes + w * kCodeBox, n0, m0 + 64 * h);
          // k4_probe: end store
          bulk_commit();
          bulk_wait_read<0>();
          mbar_arrive(&stored[w]);
        }
      }
      bulk_wait<0>();
    }
  } else {
    setmaxnreg_inc<kConsumerRegs1>();
    const int wg = warp / 4, q = lane % 4;
    // this thread's rows of a tile: r0 and r0 + 8 of each 64-row half
    const int r0 = (warp % 4) * 16 + lane / 4;
    const int c = threadIdx.x % 128;  // a column of the tile's
    float* my_red = red + wg * 2 * kBM1;
    float* my_cols = cols + wg * 2 * kBN1;
    uint64_t* my_xfull = xfull + wg * 4;
    const uint32_t a0 = smem_u32(a_s), b0 = smem_u32(b_s);
    const uint32_t box = smem_u32(boxes + wg * kCodeBox) + r0 * 128 + 2 * q;
    int acc[2][64];  // the two 64-row halves
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0;
    // this warpgroup's items: the block's t-th item for t = wg, wg + 2, ...
    int j = 0;
    for (int t = wg, u = first + wg * stride; u < units;
         t += 2, u += 2 * stride, ++j) {
      const int m0 = u / n_chunks * kBM1, chunk = u % n_chunks;
      const int n0 = chunk * kNC + rank * kBN1;
      float hsv[4];  // rows r0, r0 + 8, 64 + r0, 72 + r0
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int row = m0 + 64 * (x / 2) + 8 * (x % 2) + r0;
        hsv[x] = row < M ? hs[row] : 0.f;
      }
      const float s1c = s1[n0 + c], b1c = b1[n0 + c];
      // the main loop: a stage is released once the group after it has
      // been issued and its own has retired. The main loops wait on the
      // ring in the block's order of tiles: a stage's full barrier must not
      // be waited on while the phase before the awaited one is pending, so
      // a warpgroup starts only once the other has waited on the last stage
      // of the tile before (turn[wg]); its epilogue runs meanwhile.
      if (t > 0) mbar_wait(&turn[wg], (j - (wg == 0)) & 1);
      int it = t * kTiles1;
      for (int kt = 0; kt < kTiles1; ++kt, ++it) {
        const int s = it % kStages1;
        mbar_wait(&full[s], (it / kStages1) & 1);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kBK / kKStep; ++k) {
          const uint64_t db = smem_desc(b0 + s * kB1Tile + k * kKStep);
          // k4_probe: begin products
          wgmma_n128(acc[0], smem_desc(a0 + s * kA1Tile + k * kKStep), db,
                     kt | k);
          wgmma_n128(acc[1], smem_desc(a0 + s * kA1Tile + 64 * kBK +
                                       k * kKStep), db, kt | k);
          // k4_probe: end products
        }
        wgmma_commit();
        if (kt > 0) {
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages1]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&turn[wg ^ 1]);
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages1]);

      // the tile's s1 and b1 into shared memory
      my_cols[c] = s1c;
      my_cols[kBN1 + c] = b1c;
      named_barrier_sync(1 + wg, 128);

      // A 64-row half at a time: dequantize, activate, take each row's
      // partial max, and post it: this block's maxima into red[wg][j % 2],
      // a warpgroup barrier, one arrival on each block's xfull[wg][j % 2]
      // [half]. The second half's work hides the first's exchange.
      const int p = j & 1;
      float* rd = my_red + p * kBM1;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float hs0 = hsv[2 * h], hs1 = hsv[2 * h + 1];
        float mx0 = 0.f, mx1 = 0.f;
#pragma unroll
        for (int i = 0; i < kBN1 / 8; ++i) {
          const float2 sv =
              *reinterpret_cast<const float2*>(my_cols + 8 * i + 2 * q);
          const float2 bv =
              *reinterpret_cast<const float2*>(my_cols + kBN1 + 8 * i + 2 * q);
          // k4_probe: begin value
          const float y0 = fc1_value<kAct>(acc[h][4 * i], hs0, sv.x, bv.x);
          const float y1 = fc1_value<kAct>(acc[h][4 * i + 1], hs0, sv.y, bv.y);
          const float y2 = fc1_value<kAct>(acc[h][4 * i + 2], hs1, sv.x, bv.x);
          const float y3 = fc1_value<kAct>(acc[h][4 * i + 3], hs1, sv.y, bv.y);
          // k4_probe: end value
          mx0 = fmaxf(mx0, fmaxf(fabsf(y0), fabsf(y1)));
          mx1 = fmaxf(mx1, fmaxf(fabsf(y2), fabsf(y3)));
          acc[h][4 * i] = __float_as_int(y0);
          acc[h][4 * i + 1] = __float_as_int(y1);
          acc[h][4 * i + 2] = __float_as_int(y2);
          acc[h][4 * i + 3] = __float_as_int(y3);
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        if (q == 0) {
          rd[64 * h + r0] = mx0;
          rd[64 * h + 8 + r0] = mx1;
        }
        named_barrier_sync(1 + wg, 128);
        if (threadIdx.x % 128 < kCluster)
          mbar_arrive_cluster(&my_xfull[2 * p + h], threadIdx.x % 128);
      }

      // A half at a time again: every block's maxima of its rows, their
      // scales, and the codes, formed into registers (the accumulators
      // zeroed as they are read, since the next tile's first wgmma ignores
      // them: that keeps the codes within the registers setmaxnreg gives)
      // and, once the store warp has read the last box, written two a row
      // and column group into the box as TMA's 128-byte swizzle lays it
      // out (code (r, c) at r * 128 + 16 * ((c / 16) ^ (r % 8)) + c % 16,
      // conflict-free for the accumulator layout)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mbar_wait_cluster(&my_xfull[2 * p + h], (j >> 1) & 1);
        float am0 = 0.f, am1 = 0.f;
#pragma unroll
        for (int r = q; r < kCluster; r += 4) {
          am0 = fmaxf(am0, ld_cluster(rd + 64 * h + r0, r));
          am1 = fmaxf(am1, ld_cluster(rd + 64 * h + 8 + r0, r));
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          am0 = fmaxf(am0, __shfl_xor_sync(0xffffffffu, am0, off));
          am1 = fmaxf(am1, __shfl_xor_sync(0xffffffffu, am1, off));
        }
        const float sc0 = row_scale(am0), sc1 = row_scale(am1);
        const float rc0 = row_recip(sc0), rc1 = row_recip(sc1);
        const int row = m0 + 64 * h + r0;
        if (rank == 0 && q == 0) {
          if (row < M) scales[(size_t)row * n_chunks + chunk] = sc0;
          if (row + 8 < M) scales[(size_t)(row + 8) * n_chunks + chunk] = sc1;
        }
        uint32_t code[kBN1 / 8][2];
#pragma unroll
        for (int i = 0; i < kBN1 / 8; ++i) {
          // k4_probe: begin codes
          code[i][0] = code2_rint(__int_as_float(acc[h][4 * i]),
                                  __int_as_float(acc[h][4 * i + 1]), sc0, rc0);
          code[i][1] = code2_rint(__int_as_float(acc[h][4 * i + 2]),
                                  __int_as_float(acc[h][4 * i + 3]), sc1, rc1);
          // k4_probe: end codes
          acc[h][4 * i] = acc[h][4 * i + 1] = 0;
          acc[h][4 * i + 2] = acc[h][4 * i + 3] = 0;
        }
        const int k = 2 * j + h;
        if (k > 0) mbar_wait(&stored[wg], (k - 1) & 1);
#pragma unroll
        for (int i = 0; i < kBN1 / 8; ++i) {
          // k4_probe: begin codes
          const uint32_t at = box + ((((i >> 1) & 7) ^ (r0 & 7)) << 4) +
                              (i & 1) * 8;
          st_shared_u16(at, code[i][0]);
          st_shared_u16(at + 8 * 128, code[i][1]);
          // k4_probe: end codes
        }
        fence_proxy_async();  // the TMA store reads what was written
        __syncwarp();
        if (lane == 0) mbar_arrive(&staged[wg]);
      }
    }
  }
  __syncwarp();
  cluster_arrive();  // no block leaves while a sibling may still reach it
  cluster_wait();
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

// The tensor map of a row-major int8 [rows, cols] matrix in boxes of 128
// bytes by box_rows rows, 128-byte swizzled; rows past the end read as
// zeros and are not written.
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

// A launch of `clusters` clusters of K4a.
cudaLaunchConfig_t hidden_config(cudaLaunchAttribute* attr, int clusters,
                                 cudaStream_t st) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * kCluster, 1, 1);
  cfg.blockDim = dim3(kThreads1, 1, 1);
  cfg.dynamicSmemBytes = kSmem1;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The clusters of K4a the card holds at once
// (cudaOccupancyMaxActiveClusters), after its shared memory opt-in; read
// once. A CUDA error comes back negated.
template <int kAct>
int hidden_clusters() {
  static const int n = [] {
    const auto kernel = fused_mlp_int8_hidden_kernel<kAct>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem1);
    if (err != cudaSuccess) return -(int)err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = hidden_config(&attr, 1, nullptr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
    return err == cudaSuccess ? clusters : -(int)err;
  }();
  return n;
}

// K4a's persistent grid: a cluster for each work item (128-row tile, chunk)
// up to the clusters the card holds.
template <int kAct>
cudaError_t launch_hidden(const void* hq, const void* hs, const void* w1,
                          const void* s1, const void* b1, void* codes,
                          void* scales, int M, int F, cudaStream_t st) {
  const int most = hidden_clusters<kAct>();
  if (most < 0) return (cudaError_t)-most;
  if (most == 0) return cudaErrorInvalidConfiguration;
  CUtensorMap tm_hq, tm_w1, tm_codes;
  cudaError_t err = int8_map(&tm_hq, hq, M, kC, kBM1);
  if (err == cudaSuccess) err = int8_map(&tm_w1, w1, F, kC, kBN1);
  if (err == cudaSuccess) err = int8_map(&tm_codes, codes, M, F, 64);
  if (err != cudaSuccess) return err;
  const long long units = (long long)((M + kBM1 - 1) / kBM1) * (F / kNC);
  const int clusters = (int)(most < units ? most : units);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = hidden_config(&attr, clusters, st);
  err = cudaLaunchKernelEx(&cfg, fused_mlp_int8_hidden_kernel<kAct>, tm_hq,
                           tm_w1, tm_codes, static_cast<const float*>(hs),
                           static_cast<const float*>(s1),
                           static_cast<const float*>(b1),
                           static_cast<float*>(scales), M, F);
  return err != cudaSuccess ? err : cudaGetLastError();
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
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(act == 0 ? launch_hidden<0>(hq, hs, w1, s1, b1, codes, scales,
                                           M, F, st)
                        : launch_hidden<1>(hq, hs, w1, s1, b1, codes, scales,
                                           M, F, st));
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
