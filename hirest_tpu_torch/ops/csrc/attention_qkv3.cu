// K1 and K3: batched-heads softmax attention over fused, bias-complete qkv
// rows, with bf16 output (K1) or an int8 row-quantization epilogue (K3).
// K9 launches the same entry points.
//
// Replaces hirest_tpu/ops/attention.py::fused_attention_qkv3 (kernel bodies
// _attn_heads_batched via _attn_kernel_qkv3, and _attn_kernel_qkv3_quant
// with the pad-key mask _mask_pad_keys), and fused_attention_qkv2 (K9,
// bodies _attn_kernel_qkv2 and _attn_kernel_qkv2_quant), which computes the
// same function one head at a time: the loop over heads is TPU scheduling.
// For each (b, h), with q/k/v the head-h column slices of qkv[b] and
// n_keys = min(n_real, S) (S when n_real is 0):
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
// (93 MB; K3: 46 MB of int8 and 0.13 MB of scales): 0.1106 ms (K3: 0.0968)
// at 3.35 TB/s, against 0.048 ms for its 47.6 GFLOP of QK^T and PV at the
// 989 TFLOP/s dense bf16 rate. It is bound by memory. At the padded head
// width (models/eva_pad.py: H=16, D=128) it reads 404 MB and writes 135 MB
// (K3: 67 MB of int8): 0.1609 ms (K3: 0.1408), against 0.070 ms for 69.3
// GFLOP.
//
// Design: one warp-specialised body for both head widths and both outputs.
// - Work items are (b, query tile, h), heads fastest. A persistent grid
//   (one block an SM) walks them with a static stride (the cluster
//   epilogue's grid: by group, below).
// - A block is three consumer warpgroups of 64 query rows each (a query
//   tile is kRows = 192 rows; 160 registers a thread after setmaxnreg)
//   and a producer warpgroup (24 registers), whose one thread issues every
//   TMA load: each consumer's Q tile into its own buffer (a full and an
//   empty mbarrier each; the next item's Q lands while this one computes),
//   and K and V tiles into a ring of kStages stages (a full and an empty
//   mbarrier each). Every consumer reads every stage, so a head's K and V
//   pass through L2 once for 192 query rows, and the next tile's loads,
//   and the next item's, overlap this tile's math. A consumer whose rows
//   all lie past S only keeps the ring's count: at S = 257 a head's
//   second item has 65 rows, one consumer's 64, one's 1 and none for the
//   third. The consumers share the SM's math, so the idle one costs no
//   time, but the 1-row tile costs a full one (wgmma's M is 64).
// - qkv is mapped as the 4-d tensor [B, S, 3H, D] (D innermost), so a box
//   never crosses a head or an image: keys >= S and head columns >= D read
//   as zeros. A box is 64 rows by 32 columns (64 bytes, 64-byte swizzle); a
//   tile of 64 rows is 3 boxes at D=88 (columns 88..95 zero, so QK^T runs
//   over 96 = 6 x 16 columns with nothing but zeros past the head) and 4 at
//   D=128.
// - Each consumer reads its q fragments out of its Q tile once (ldmatrix,
//   de-swizzled) into registers, as wgmma's A operand. QK^T is wgmma
//   m64n64k16 (bf16 -> f32) against the K-major K tile. PV is wgmma
//   m64n96k16 / m64n128k16 with p from registers (the score accumulator's
//   layout is the A fragment's) and V as the MN-major B operand straight
//   from its TMA tile: no V^T is ever stored. PV at D=88 runs 96 wide over
//   the zero columns, whose outputs are dropped.
// - Two passes, because the reference rounds p against the exact final
//   row max: pass 1 takes the row max over QK^T, pass 2 recomputes QK^T
//   and forms p = bf16(2^(s c - m c)), m c rounded once a row, by
//   ex2.approx.ftz on one FFMA, with no branch a score except on the last
//   key tile, whose keys past n_keys are left out by the tile's bound. The
//   f32 row sum is of the rounded p; o is multiplied by the correctly
//   rounded reciprocal of the sum after PV. Each tile's PV runs while the
//   next tile is awaited and its scores issued. Any S and n_keys: keys
//   stream through the ring.
// - Every wgmma sequence is straight-line (the last key tile is computed
//   whole, its keys past n_keys masked), which keeps ptxas from
//   serialising the wgmma pipeline around branches. At D=128 it still
//   serialises it for lack of registers (a consumer thread's 160 hold 64
//   PV accumulators, 32 scores and 32 q fragment registers).
// - K3's row scale needs all H heads of a row. At H = 16 (EVA-g's heads,
//   and the padded heads of models/eva_pad.py) the heads of one group
//   (b, query tile) run at once on the blocks of one thread-block cluster,
//   which exchange their rows' partial maxima through distributed shared
//   memory: no f32 workspace, no atomics, no memset, no second launch. A
//   cluster must sit in one GPC, and the kernel runs one block an SM, so
//   the cluster's size sets how many SMs it can use: on an H100 SXM
//   (cudaOccupancyMaxActiveClusters, chip_smoke.py --time-attention)
//   clusters of 16 held 7 x 16 = 112 SMs and clusters of 8 held 15 x 8 =
//   120. The launch asks the card (heads_per_block): clusters of 16, one
//   head a block, where they hold at least kClusterSms SMs; else clusters
//   of 8 with two heads a block, the first head's scaled f32 output parked
//   in the block's shared memory in place of two K/V ring stages, where
//   the ring keeps kMinStages (d = 88: 5 of 7); else (d = 128, whose ring
//   would keep 2 of 5) clusters of 16. The persistent grid walks the
//   groups by cluster.
//   After a group's last head each consumer warpgroup writes its rows'
//   max |o| over the block's heads into red[group parity] in its own
//   shared memory, and after a warpgroup barrier its first warp's lane r
//   arrives on block r's xfull[parity] mbarrier (release at cluster scope;
//   the kBlocks arrivals side by side: one thread's one after another
//   made K3 0.70 ms in clusters of 16 on an H100, chip_smoke.py
//   --time-attention). One head a block, it keeps that head's output in
//   registers and runs the next item's first pass first, which hides the
//   wait; then, once its own xfull has all the cluster's arrivals
//   (acquire), it reads the other blocks' maxima of its rows
//   (ld.shared::cluster), forms the scale (row_scale) and the codes (and,
//   two heads a block, the parked head's), code2_recip's quotients (bit
//   for bit __fdiv_rn's, as K2's and K5's), stages them in shared memory
//   and stores them 16 bytes at a time (8 at one 88-wide head a block,
//   whose slice of a row is 8-byte aligned). The cluster's rank-0 block
//   writes the scales. Two parities, each with its own mbarrier, keep a
//   block from overwriting maxima a sibling has not read: it writes parity
//   p again only after the next group's exchange, which every sibling
//   joins after reading. The two-step route (below) stays for other head
//   counts, and under -DHIREST_QKV3_TWO_STEP=1 for every call, so that
//   chip_smoke.py holds the cluster epilogue bit for bit against it.
// - Any other H: each warp parks its f32 rows of its head in a [B, S, H*D]
//   workspace and folds its per-row max |o| into a zeroed [B, S] buffer
//   with atomicMax (rowquant.cuh's park_f32_tile); a second kernel
//   quantizes the workspace rows (launch_quant_rows, shared with K8's
//   epilogue). This moves 370 MB more than the bound counts at EVA-g's
//   shape.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "hopper.cuh"
#include "rowquant.cuh"

namespace {

constexpr int kKeys = 64;        // keys (or query rows) a tile holds
constexpr int kBoxCols = 32;     // head columns a TMA box holds: 64 bytes
constexpr int kBoxBytes = kKeys * kBoxCols * 2;  // 64 rows by 64 bytes
constexpr int kSmemMax = 232448;   // dynamic shared memory a block may use
// Three consumer warpgroups of 64 query rows and one producer warpgroup;
// setmaxnreg gives the producer's registers to the consumers
constexpr int kGroups = 3;
constexpr int kRows = 64 * kGroups;  // query rows an item
constexpr int kThreads = 128 * (kGroups + 1);
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 160;

// What the kernel writes: bf16 o (K1), the two-step int8 epilogue's
// workspace and row maxima (K3 at any H), or codes and scales by the
// cluster epilogue (K3 at H = kClusterHeads)
enum Mode { kBf16Out = 0, kTwoStep = 1, kCluster = 2 };
constexpr int kClusterHeads = 16;  // the head count the cluster epilogue takes
// clusters of one head a block where the card holds this many SMs in them,
// else two heads a block where the K/V ring keeps this many stages
constexpr int kClusterSms = 128;
constexpr int kMinStages = 4;

template <int D, int kMode = kBf16Out, int kHPC = 1>
struct Geo {
  static_assert(D == 88 || D == 128, "head widths the kernel is built for");
  static_assert(kHPC == 1 || (kHPC == 2 && kMode == kCluster),
                "two heads a block only in the cluster epilogue");
  static constexpr int kBoxes = (D + kBoxCols - 1) / kBoxCols;  // 3 or 4
  static constexpr int kChunks = kBoxes * kBoxCols / 16;  // QK^T k-steps
  static constexpr int kSlot = kBoxes * kBoxBytes;  // one Q, K or V tile
  static constexpr int kStage = 2 * kSlot;  // a K and a V tile
  static constexpr int kBarriers = 1024;    // room for the mbarriers
  static constexpr int kBlocks = kClusterHeads / kHPC;  // a cluster's
  // the cluster epilogue's bytes a consumer: the first head's f32 output,
  // which the codes then reuse (two heads a block), or the codes
  static constexpr int kEpi =
      kMode != kCluster ? 0 : kHPC == 2 ? 64 * D * 4 : 64 * D;
  static constexpr int kRed = kMode == kCluster ? 2 * kRows * 4 : 0;
  static constexpr int kStages = (kSmemMax - 1024 - kBarriers -
                                  kGroups * kSlot - kGroups * kEpi - kRed) /
                                 kStage;  // 7 or 5; cluster: 7, 4 / 5, 2
  static_assert(kStages >= 2, "a K/V ring of two stages at least");
  static constexpr size_t kSmem = 1024 + (size_t)kGroups * kSlot +
                                  (size_t)kStages * kStage +
                                  (size_t)kGroups * kEpi + kRed + kBarriers;
  // two blocks' shared memory (and 1 KB each the runtime keeps) exceed an
  // SM's 228 KB, so the persistent grid is one block an SM
  static_assert(2 * (kSmem + 1024) > 228 * 1024, "one block an SM");
  static constexpr int kAcc = kBoxes * kBoxCols / 2;  // PV accumulators
  static constexpr int kOTiles = D / 8;  // 8-column slices written out
  // the cluster epilogue's codes: a row's bytes, and a store's
  static constexpr int kCodeRow = kHPC * D;
  static constexpr int kCodeVec = kCodeRow % 16 == 0 ? 16 : 8;
};

// PV over one 16-key step: o += p v, V's tile MN-major (its 32-column
// boxes kBoxBytes apart).
template <int D>
__device__ __forceinline__ void pv_step(float (&o)[Geo<D>::kAcc],
                                        const uint32_t (&p)[4],
                                        uint32_t v_addr) {
  const uint64_t db = smem_desc_mn64(v_addr, kBoxBytes);
  if constexpr (D == 88)
    wgmma_bf16_n96(o, p, db, 1);
  else
    wgmma_bf16_n128(o, p, db, 1);
}

// Scores of the consumer's 64 query rows against the 64 keys of the K
// tile at k_addr (zero rows past S; the caller leaves out keys past
// n_keys). Waits for every wgmma in flight.
template <int D>
__device__ __forceinline__ void scores(float (&s)[32],
                                       const uint32_t (&qa)[Geo<D>::kChunks][4],
                                       uint32_t k_addr) {
  using G = Geo<D>;
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < G::kChunks; ++kc)
    wgmma_bf16_n64(
        s, qa[kc], smem_desc_k64(k_addr + (kc / 2) * kBoxBytes + (kc % 2) * 32),
        kc);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
}

// The rounded p of one score pair, its f32 sum added to l.
__device__ __forceinline__ uint32_t prob_pair(float x0, float x1, float c,
                                              float mc, float& l) {
  const uint32_t p =
      pack_f32_bf16(ex2_ftz(fmaf(x0, c, -mc)), ex2_ftz(fmaf(x1, c, -mc)));
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&p);
  l += __low2float(b) + __high2float(b);
  return p;
}

// The largest |y| of a 16-row tile's rows r0 and r0 + 8 over this head, in
// every lane of each row's quad.
template <int kOTiles>
__device__ __forceinline__ void tile_amax(const float (&y)[kOTiles][4],
                                          float& a0, float& a1) {
  a0 = 0.f;
  a1 = 0.f;
#pragma unroll
  for (int i = 0; i < kOTiles; ++i) {
    a0 = fmaxf(a0, fmaxf(fabsf(y[i][0]), fabsf(y[i][1])));
    a1 = fmaxf(a1, fmaxf(fabsf(y[i][2]), fabsf(y[i][3])));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    a0 = fmaxf(a0, __shfl_xor_sync(0xffffffffu, a0, off));
    a1 = fmaxf(a1, __shfl_xor_sync(0xffffffffu, a1, off));
  }
}

// out: bf16 o [B, S, H*D] (kBf16Out) or int8 codes [B, S, H*D]
// (kCluster); ws, rowmax: the two-step epilogue's workspace and row maxima
// (kTwoStep); scales [B, S] (kCluster). items: (b, query tile, h) work
// items, or with kCluster the (b, query tile) groups.
template <int D, int kMode, int kHPC>
__global__ void __launch_bounds__(kThreads, 1)
    attention_qkv3_kernel(const __grid_constant__ CUtensorMap tm,
                          void* __restrict__ out, float* __restrict__ ws,
                          unsigned int* __restrict__ rowmax,
                          float* __restrict__ scales, int S, int H,
                          int n_keys, float c, int items) {
  using G = Geo<D, kMode, kHPC>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qbuf = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* ring = qbuf + kGroups * G::kSlot;
  uint8_t* epi = ring + G::kStages * G::kStage;  // [kGroups][kEpi]
  float* red = reinterpret_cast<float*>(epi + kGroups * G::kEpi);
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + kGroups * G::kEpi +
                                               G::kRed);
  uint64_t* empty = full + G::kStages;
  uint64_t* qfull = empty + G::kStages;
  uint64_t* qempty = qfull + kGroups;
  uint64_t* xfull = qempty + kGroups;  // [2]: the cluster's row maxima
  const int q_tiles = (S + kRows - 1) / kRows;
  const int key_tiles = (n_keys + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kGroups);
    }
    for (int w = 0; w < kGroups; ++w) {
      mbar_init(&qfull[w], 1);
      mbar_init(&qempty[w], 4);
    }
    if constexpr (kMode == kCluster) {
      mbar_init(&xfull[0], G::kBlocks * kGroups);
      mbar_init(&xfull[1], G::kBlocks * kGroups);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the cluster's block rank and cluster index, and how many clusters
  int rank = 0, cid = 0, ncl = 1;
  if constexpr (kMode == kCluster) {
    rank = (int)cluster_rank();
    cid = blockIdx.x / G::kBlocks;
    ncl = gridDim.x / G::kBlocks;
    // every block's barriers are set before any block arrives on them
    cluster_arrive();
    cluster_wait();
  }
  // the block's k-th item: false past its last
  auto item = [&](int k, int& b, int& qt, int& h) {
    if constexpr (kMode == kCluster) {
      const int grp = cid + (k / kHPC) * ncl;
      h = rank * kHPC + k % kHPC;
      qt = grp % q_tiles;
      b = grp / q_tiles;
      return grp < items;
    } else {
      const int it = blockIdx.x + k * gridDim.x;
      h = it % H;
      qt = (it / H) % q_tiles;
      b = it / (H * q_tiles);
      return it < items;
    }
  };

  const int wg = threadIdx.x / 128;
  if (wg == kGroups) {
    // producer warpgroup: one thread walks the block's items, loads each
    // consumer's Q tile into its buffer and keeps the K/V ring full
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kGroups * 128) {
      // one 64-row tile from row0 of head column block part * H + h
      auto load_tile = [&](uint8_t* dst, uint64_t* bar, int part, int h,
                           int row0, int b) {
#pragma unroll
        for (int bx = 0; bx < G::kBoxes; ++bx)
          tma_load_4d(dst + bx * kBoxBytes, &tm, bar, bx * kBoxCols,
                      part * H + h, row0, b);
      };
      int step = 0;
      int q_loads[kGroups] = {};
      int b, qt, h;
      for (int k = 0; item(k, b, qt, h); ++k) {
#pragma unroll
        for (int w = 0; w < kGroups; ++w) {
          const int row0 = qt * kRows + 64 * w;
          if (row0 >= S) continue;  // no rows for consumer w
          if (q_loads[w] > 0) mbar_wait(&qempty[w], (q_loads[w] - 1) & 1);
          ++q_loads[w];
          mbar_expect_tx(&qfull[w], G::kSlot);
          load_tile(qbuf + w * G::kSlot, &qfull[w], 0, h, row0, b);
        }
        for (int i = 0; i < 2 * key_tiles; ++i, ++step) {
          const bool pass2 = i >= key_tiles;
          const int key0 = (pass2 ? i - key_tiles : i) * kKeys;
          const int s = step % G::kStages;
          if (step >= G::kStages)
            mbar_wait(&empty[s], (step / G::kStages - 1) & 1);
          mbar_expect_tx(&full[s], pass2 ? G::kStage : G::kSlot);
          load_tile(ring + s * G::kStage, &full[s], 1, h, key0, b);
          if (pass2)
            load_tile(ring + s * G::kStage + G::kSlot, &full[s], 2, h, key0,
                      b);
        }
      }
    }
    __syncwarp();
  } else {
    // consumer warpgroup wg: rows 64 wg .. 64 wg + 63 of each item's tile
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t ring_addr = smem_u32(ring);
    const int hd = H * D;
    int step = 0, q_loads = 0;
    auto wait_full = [&]() {
      const int s = step % G::kStages;
      mbar_wait(&full[s], (step / G::kStages) & 1);
      return s;
    };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // The cluster epilogue, in two halves a group so that (one head a
    // block) the exchange's latency hides behind the next item's first
    // pass. post(n): this
    // consumer's rows' partial maxima over the block's heads (rows lr and
    // lr + 8 of the tile, lr = 64 wg + 16 warp + g) into red[n % 2], a
    // warpgroup barrier, then lane r of the first warp arrives on block
    // r's xfull[n % 2]. finish(): once xfull[n % 2] has the cluster's
    // arrivals, the maxima of every block, the scales, and the codes of
    // the pending group (the last head's y kept in py, two heads a block
    // the first head's from the stage), staged and stored. A consumer
    // without rows in a group only keeps the barriers' count.
    // With two heads a block the parked head's codes need the registers
    // that would hold py through the next first pass (overlapped, ptxas
    // spilled), so each group finishes at once.
    constexpr bool kOverlap = kHPC == 1;
    const int lr = 64 * wg + 16 * warp + g;
    float pm0 = 0.f, pm1 = 0.f;  // partial maxima over the block's heads
    float py[G::kOTiles][4];
    int pend_n = -1, pend_b = 0, pend_row = 0;
    bool pend_active = false;
    uint8_t* stage = epi + wg * G::kEpi;  // [64][D] f32, then codes
    auto post = [&](int n, bool active) {
      float* rd = red + (n & 1) * kRows;
      if (active && t == 0) {
        rd[lr] = pm0;
        rd[lr + 8] = pm1;
      }
      named_barrier_sync(1 + wg, 128);
      // the arrivals' releases side by side, not one after another
      if (threadIdx.x % 128 < G::kBlocks)
        mbar_arrive_cluster(&xfull[n & 1], threadIdx.x % 128);
    };
    auto finish = [&]() {
      const int n = pend_n;
      pend_n = -1;
      mbar_wait_cluster(&xfull[n & 1], (n >> 1) & 1);
      if (!pend_active) return;
      const float* rd = red + (n & 1) * kRows;
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int r = t; r < G::kBlocks; r += 4) {
        a0 = fmaxf(a0, ld_cluster(rd + lr, r));
        a1 = fmaxf(a1, ld_cluster(rd + lr + 8, r));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        a0 = fmaxf(a0, __shfl_xor_sync(0xffffffffu, a0, off));
        a1 = fmaxf(a1, __shfl_xor_sync(0xffffffffu, a1, off));
      }
      const float s0 = row_scale(a0), s1 = row_scale(a1);
      const float rc0 = row_recip(s0), rc1 = row_recip(s1);
      const int row0 = pend_row + 16 * warp + g, row1 = row0 + 8;
      if (rank == 0 && t == 0) {
        if (row0 < S) scales[(size_t)pend_b * S + row0] = s0;
        if (row1 < S) scales[(size_t)pend_b * S + row1] = s1;
      }
      // codes of rows g and g + 8, columns 8 i + 2 t and + 1: two heads a
      // block, the first head's from the stage, held two rows to a
      // register until the whole stage is read; then the last head's from
      // py, each written as it is formed
      uint8_t* cs = stage + (16 * warp + g) * G::kCodeRow + 2 * t;
      if constexpr (kHPC == 2) {
        const float* ys = reinterpret_cast<const float*>(stage) +
                          (16 * warp + g) * D + 2 * t;
        uint32_t ca[G::kOTiles];
#pragma unroll
        for (int i = 0; i < G::kOTiles; ++i) {
          const float2 u = *reinterpret_cast<const float2*>(ys + 8 * i);
          const float2 v =
              *reinterpret_cast<const float2*>(ys + 8 * D + 8 * i);
          ca[i] = code2_recip(u.x, u.y, s0, rc0) |
                  code2_recip(v.x, v.y, s1, rc1) << 16;
        }
        named_barrier_sync(1 + wg, 128);  // the stage's y is read
#pragma unroll
        for (int i = 0; i < G::kOTiles; ++i) {
          *reinterpret_cast<uint16_t*>(cs + 8 * i) = (uint16_t)ca[i];
          *reinterpret_cast<uint16_t*>(cs + 8 * G::kCodeRow + 8 * i) =
              (uint16_t)(ca[i] >> 16);
        }
      }
#pragma unroll
      for (int i = 0; i < G::kOTiles; ++i) {
        *reinterpret_cast<uint16_t*>(cs + (kHPC - 1) * D + 8 * i) =
            (uint16_t)code2_recip(py[i][0], py[i][1], s0, rc0);
        *reinterpret_cast<uint16_t*>(cs + 8 * G::kCodeRow + (kHPC - 1) * D +
                                     8 * i) =
            (uint16_t)code2_recip(py[i][2], py[i][3], s1, rc1);
      }
      named_barrier_sync(1 + wg, 128);  // the codes are staged
      // the tile's rows of the block's heads' slice, kCodeVec bytes a store
      constexpr int kVecs = G::kCodeRow / G::kCodeVec;  // a row's
      int8_t* q = static_cast<int8_t*>(out) + (size_t)rank * G::kCodeRow;
      for (int v = threadIdx.x % 128; v < 64 * kVecs; v += 128) {
        const int r = v / kVecs, part = v % kVecs;
        if (pend_row + r >= S) break;
        int8_t* dst = q + ((size_t)pend_b * S + pend_row + r) * hd +
                      part * G::kCodeVec;
        const uint8_t* src = stage + r * G::kCodeRow + part * G::kCodeVec;
        if constexpr (G::kCodeVec == 16)
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        else
          *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
      }
      named_barrier_sync(1 + wg, 128);  // the stage is free again
    };

    // a group's kHPC items at a time, hb the block's head; one copy of the
    // item's code (a copy for each head made the kernel slower)
    int b, qt, h;
    bool more = true;
    for (int k0 = 0; more; k0 += kHPC) {
#pragma unroll 1
      for (int hb = 0; hb < kHPC; ++hb) {
        const int k = k0 + hb;
        if (!item(k, b, qt, h)) {
          more = false;
          break;
        }
        const int first_row = qt * kRows + 64 * wg;
        const bool active = first_row < S;
        // the cluster epilogue: the block's last head of the group
        const bool last_head = hb == kHPC - 1;

        // q fragments of this warp's 16 rows: ldmatrix.x4 of 16 x 16 chunks
        // out of the 64-byte-swizzled Q tile (16-byte chunk j of row r lies
        // at chunk j ^ ((r >> 1) & 3)). The buffer is released once the
        // first product has read the fragments.
        uint32_t qa[G::kChunks][4];
        if (active) {
          mbar_wait(&qfull[wg], q_loads++ & 1);
          const uint8_t* qs = qbuf + wg * G::kSlot;
          const int r = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int kc = 0; kc < G::kChunks; ++kc) {
            const int chunk = (kc % 2) * 2 + (lane >> 4);
            ldmatrix_x4(qa[kc], qs + (kc / 2) * kBoxBytes + r * 64 +
                                    ((chunk ^ ((r >> 1) & 3)) << 4));
          }
        }
        if (!active) {
          // no rows of this item here (the last tile of a head): keep the
          // ring's count, and the cluster's exchange
          for (int i = 0; i < 2 * key_tiles; ++i, ++step)
            release(&empty[wait_full()]);
          if constexpr (kMode == kCluster) {
            if (kOverlap && hb == 0 && pend_n >= 0) finish();
            if (last_head) {
              post(k / kHPC, false);
              pend_n = k / kHPC;
              pend_active = false;
              if (!kOverlap) finish();
            }
          }
          continue;
        }

        // Pass 1: the exact row max over the real keys.
        float sc[32];
        float m0 = -INFINITY, m1 = -INFINITY;
        for (int kt = 0; kt < key_tiles; ++kt, ++step) {
          const int s = wait_full();
          const int n = n_keys - kt * kKeys;
          scores<D>(sc, qa, ring_addr + s * G::kStage);
          release(&empty[s]);
          if (kt == 0) release(&qempty[wg]);
          if (n >= kKeys) {
#pragma unroll
            for (int i = 0; i < kKeys / 8; ++i) {
              m0 = fmaxf(m0, fmaxf(sc[4 * i], sc[4 * i + 1]));
              m1 = fmaxf(m1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
            }
          } else {
#pragma unroll
            for (int i = 0; i < kKeys / 8; ++i) {
              const int key = 8 * i + 2 * t;
              if (key < n) {
                m0 = fmaxf(m0, sc[4 * i]);
                m1 = fmaxf(m1, sc[4 * i + 2]);
              }
              if (key + 1 < n) {
                m0 = fmaxf(m0, sc[4 * i + 1]);
                m1 = fmaxf(m1, sc[4 * i + 3]);
              }
            }
          }
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
          m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
        }
        const float mc0 = m0 * c, mc1 = m1 * c;
        if constexpr (kMode == kCluster) {
          // the last group's codes, meanwhile
          if (kOverlap && hb == 0 && pend_n >= 0) finish();
        }

        // Pass 2: p = bf16(2^(s c - m c)), l += p, o += p v. Each tile's PV
        // runs while the next tile's K and V are awaited and its scores
        // issued.
        float o[G::kAcc];
#pragma unroll
        for (int i = 0; i < G::kAcc; ++i) o[i] = 0.f;
        float l0 = 0.f, l1 = 0.f;
        int prev = -1;  // the stage whose PV is in flight
        for (int kt = 0; kt < key_tiles; ++kt, ++step) {
          const int s = wait_full();
          const int n = n_keys - kt * kKeys;
          const uint32_t k_addr = ring_addr + s * G::kStage;
          scores<D>(sc, qa, k_addr);  // also retires the previous PV
          if (prev >= 0) release(&empty[prev]);
          // p for 16-key step j: the A fragment {row g keys 2t.., row g + 8,
          // row g keys 2t + 8.., row g + 8}, i.e. score slices 2j and 2j + 1
          uint32_t pa[kKeys / 16][4];
          if (n >= kKeys) {
#pragma unroll
            for (int i = 0; i < kKeys / 8; ++i) {
              pa[i / 2][2 * (i % 2)] =
                  prob_pair(sc[4 * i], sc[4 * i + 1], c, mc0, l0);
              pa[i / 2][2 * (i % 2) + 1] =
                  prob_pair(sc[4 * i + 2], sc[4 * i + 3], c, mc1, l1);
            }
          } else {
            // the last tile: keys at or past n are left out (p = 0)
#pragma unroll
            for (int i = 0; i < kKeys / 8; ++i) {
              const int key = 8 * i + 2 * t;
              const float x0 = key < n ? sc[4 * i] : -INFINITY;
              const float x1 = key + 1 < n ? sc[4 * i + 1] : -INFINITY;
              const float x2 = key < n ? sc[4 * i + 2] : -INFINITY;
              const float x3 = key + 1 < n ? sc[4 * i + 3] : -INFINITY;
              pa[i / 2][2 * (i % 2)] = prob_pair(x0, x1, c, mc0, l0);
              pa[i / 2][2 * (i % 2) + 1] = prob_pair(x2, x3, c, mc1, l1);
            }
          }
          const uint32_t v_addr = k_addr + G::kSlot;
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < kKeys / 16; ++j)
            pv_step<D>(o, pa[j], v_addr + j * 16 * 64);
          wgmma_commit();
          prev = s;
        }
        wgmma_wait<0>();
        fence_regs(o);
        release(&empty[prev]);

#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          l0 += __shfl_xor_sync(0xffffffffu, l0, off);
          l1 += __shfl_xor_sync(0xffffffffu, l1, off);
        }
        const float r0 = __frcp_rn(l0), r1 = __frcp_rn(l1);
        const int row0 = first_row + 16 * warp + g, row1 = row0 + 8;
        if constexpr (kMode == kBf16Out) {
          __nv_bfloat16* o0 = static_cast<__nv_bfloat16*>(out) +
                              ((size_t)b * S + row0) * hd + h * D + 2 * t;
          __nv_bfloat16* o1 = o0 + 8 * (size_t)hd;
#pragma unroll
          for (int i = 0; i < G::kOTiles; ++i) {
            if (row0 < S)
              *reinterpret_cast<uint32_t*>(o0 + 8 * i) =
                  pack_f32_bf16(o[4 * i] * r0, o[4 * i + 1] * r0);
            if (row1 < S)
              *reinterpret_cast<uint32_t*>(o1 + 8 * i) =
                  pack_f32_bf16(o[4 * i + 2] * r1, o[4 * i + 3] * r1);
          }
        } else {
          float y[G::kOTiles][4];
#pragma unroll
          for (int i = 0; i < G::kOTiles; ++i) {
            y[i][0] = o[4 * i] * r0;
            y[i][1] = o[4 * i + 1] * r0;
            y[i][2] = o[4 * i + 2] * r1;
            y[i][3] = o[4 * i + 3] * r1;
          }
          if constexpr (kMode == kTwoStep) {
            float* w0 = ws + ((size_t)b * S + row0) * hd + h * D + 2 * t;
            unsigned int* mx = rowmax + (size_t)b * S + row0;
            park_f32_tile<G::kOTiles>(y, w0, w0 + 8 * (size_t)hd, row0 < S,
                                      row1 < S, mx, mx + 8, t);
          } else {
            float a0, a1;
            tile_amax<G::kOTiles>(y, a0, a1);
            pm0 = hb == 0 ? a0 : fmaxf(pm0, a0);
            pm1 = hb == 0 ? a1 : fmaxf(pm1, a1);
            if (last_head) {
              // post the group's exchange; its codes wait in py until the
              // next item's first pass is done
              post(k / kHPC, true);
#pragma unroll
              for (int i = 0; i < G::kOTiles; ++i)
#pragma unroll
                for (int e = 0; e < 4; ++e) py[i][e] = y[i][e];
              pend_n = k / kHPC;
              pend_b = b;
              pend_row = first_row;
              pend_active = true;
              if (!kOverlap) finish();
            } else {
              // the block's first head: its y waits in the stage
              float* ys = reinterpret_cast<float*>(stage) +
                          (16 * warp + g) * D + 2 * t;
#pragma unroll
              for (int i = 0; i < G::kOTiles; ++i) {
                *reinterpret_cast<float2*>(ys + 8 * i) =
                    make_float2(y[i][0], y[i][1]);
                *reinterpret_cast<float2*>(ys + 8 * D + 8 * i) =
                    make_float2(y[i][2], y[i][3]);
              }
            }
          }
        }
      }
    }
    if constexpr (kMode == kCluster) {
      if (pend_n >= 0) finish();
    }
  }
  if constexpr (kMode == kCluster) {
    // no block leaves while a sibling may still read its maxima
    cluster_arrive();
    cluster_wait();
  }
}

// qkv [B, S, 3*H*D] bf16 as the 4-d tensor [B, S, 3H, D], read in boxes of
// 64 rows by 32 columns, 64-byte swizzled; rows >= S and columns >= D read
// as zeros.
cudaError_t qkv_map(CUtensorMap* map, const void* qkv, int B, int S, int H,
                    int D) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorInitializationError;
  if (reinterpret_cast<uintptr_t>(qkv) % 16) return cudaErrorMisalignedAddress;
  const cuuint64_t row = (cuuint64_t)3 * H * D * 2;  // bytes a token
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)3 * H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, row, row * S};
  const cuuint32_t box[4] = {(cuuint32_t)kBoxCols, 1, (cuuint32_t)kKeys, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(qkv), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The card's SMs, read once: the persistent grid is one block an SM.
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

template <int D, int kMode>
cudaError_t launch_attention(const void* qkv, void* out, float* ws,
                             unsigned int* rowmax, int B, int S, int H,
                             int n_keys, float c, cudaStream_t stream) {
  using G = Geo<D, kMode>;
  CUtensorMap tm;
  cudaError_t err = qkv_map(&tm, qkv, B, S, H, D);
  if (err != cudaSuccess) return err;
  const auto kernel = attention_qkv3_kernel<D, kMode, 1>;
  // the shared-memory opt-in, once an instantiation
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kSmem);
  if (opt_in != cudaSuccess) return opt_in;
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  const long long items = (long long)B * H * ((S + kRows - 1) / kRows);
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = (int)(items < sms ? items : sms);
  kernel<<<grid, kThreads, G::kSmem, stream>>>(
      tm, out, ws, rowmax, nullptr, S, H, n_keys, c, (int)items);
  return cudaGetLastError();
}

// The head widths the kernel is built for: EVA-g's 88, and 128 for the
// padded heads of models/eva_pad.py.
template <int kMode>
cudaError_t launch_attention(const void* qkv, void* out, float* ws,
                             unsigned int* rowmax, int B, int S, int H, int D,
                             int n_keys, float c, cudaStream_t stream) {
  if (D == 88)
    return launch_attention<88, kMode>(qkv, out, ws, rowmax, B, S, H, n_keys,
                                       c, stream);
  return launch_attention<128, kMode>(qkv, out, ws, rowmax, B, S, H, n_keys,
                                      c, stream);
}

// The cluster epilogue's launch configuration: clusters of kBlocks blocks
// along x.
template <int D, int kHPC>
cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int clusters,
                                  cudaStream_t stream) {
  using G = Geo<D, kCluster, kHPC>;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = G::kBlocks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * G::kBlocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = G::kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The clusters of the cluster epilogue's instantiation that the card holds
// at once (cudaOccupancyMaxActiveClusters), after its opt-ins (the shared
// memory, and clusters of 16, which are past the portable 8); read once. A
// CUDA error comes back negated.
template <int D, int kHPC>
int max_clusters() {
  static const int n = [] {
    const auto kernel = attention_qkv3_kernel<D, kCluster, kHPC>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Geo<D, kCluster, kHPC>::kSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return -(int)err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config<D, kHPC>(&attr, 1, nullptr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
    return err == cudaSuccess ? clusters : -(int)err;
  }();
  return n;
}

// Heads a block of the cluster epilogue: 1 (clusters of 16) where the card
// holds at least kClusterSms SMs in them; else 2 (clusters of 8) where the
// first head's parked output leaves the K/V ring kMinStages stages (d = 88:
// 5); else 1 (d = 128, whose ring would fall to 2 stages: 0.56 ms against
// one head a block's 0.51 on an H100, chip_smoke.py --time-attention).
template <int D>
int heads_per_block() {
  if (max_clusters<D, 1>() * kClusterHeads >= kClusterSms) return 1;
  return Geo<D, kCluster, 2>::kStages >= kMinStages ? 2 : 1;
}

template <int D, int kHPC>
cudaError_t launch_cluster(const void* qkv, void* q, float* s, int B, int S,
                           int n_keys, float c, cudaStream_t stream) {
  CUtensorMap tm;
  cudaError_t err = qkv_map(&tm, qkv, B, S, kClusterHeads, D);
  if (err != cudaSuccess) return err;
  const int most = max_clusters<D, kHPC>();
  if (most < 0) return (cudaError_t)-most;
  if (most == 0) return cudaErrorInvalidConfiguration;
  const long long groups = (long long)B * ((S + kRows - 1) / kRows);
  if (groups > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<D, kHPC>(
      &attr, (int)(groups < most ? groups : most), stream);
  void* out = q;
  float* ws = nullptr;
  unsigned int* rowmax = nullptr;
  int H = kClusterHeads, items = (int)groups;
  void* args[] = {&tm, &out, &ws, &rowmax, &s, &S, &H, &n_keys, &c, &items};
  err = cudaLaunchKernelExC(
      &cfg, (const void*)attention_qkv3_kernel<D, kCluster, kHPC>, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int D>
cudaError_t launch_cluster(int hpc, const void* qkv, void* q, float* s,
                           int B, int S, int n_keys, float c,
                           cudaStream_t stream) {
  if (hpc == 0) hpc = heads_per_block<D>();
  if (hpc == 1)
    return launch_cluster<D, 1>(qkv, q, s, B, S, n_keys, c, stream);
  if (hpc == 2)
    return launch_cluster<D, 2>(qkv, q, s, B, S, n_keys, c, stream);
  return cudaErrorInvalidValue;
}

bool bad_shape(int B, int S, int H, int D, int n_keys) {
  return (D != 88 && D != 128) || B <= 0 || S <= 0 || H <= 0 || n_keys <= 0 ||
         n_keys > S;
}

#ifndef HIREST_QKV3_TWO_STEP
#define HIREST_QKV3_TWO_STEP 0
#endif

}  // namespace

// qkv [B, S, 3*H*D] bf16 contiguous, biases pre-added, D = 88 or 128;
// out [B, S, H*D] bf16.
// Keys >= n_keys (1 <= n_keys <= S) are left out. c = scale * log2(e).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int hirest_attention_qkv3_bf16(const void* qkv, void* out, int B,
                                          int S, int H, int D, int n_keys,
                                          float c, void* stream) {
  if (bad_shape(B, S, H, D, n_keys)) return (int)cudaErrorInvalidValue;
  return (int)launch_attention<kBf16Out>(qkv, out, nullptr, nullptr, B, S, H,
                                         D, n_keys, c, (cudaStream_t)stream);
}

// As above with the int8 epilogue: q [B, S, H*D] int8 (16-byte aligned) and
// s [B, S] f32 out. At H = 16 the cluster epilogue, one launch: hpc heads a
// block (1 or 2; 0: heads_per_block's choice), ws and rowmax unused. At
// any other H, or built with -DHIREST_QKV3_TWO_STEP=1, the two-step
// epilogue (hpc 0): ws [B, S, H*D] f32 and rowmax [B, S] (4 bytes each)
// are scratch; it zeroes rowmax and launches both steps on `stream`.
extern "C" int hirest_attention_qkv3_quant(const void* qkv, void* ws,
                                           void* rowmax, void* q, void* s,
                                           int B, int S, int H, int D,
                                           int n_keys, float c, int hpc,
                                           void* stream) {
  if (bad_shape(B, S, H, D, n_keys) || reinterpret_cast<uintptr_t>(q) % 16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  float* sp = static_cast<float*>(s);
  if (!HIREST_QKV3_TWO_STEP && H == kClusterHeads) {
    if (D == 88)
      return (int)launch_cluster<88>(hpc, qkv, q, sp, B, S, n_keys, c, st);
    return (int)launch_cluster<128>(hpc, qkv, q, sp, B, S, n_keys, c, st);
  }
  if (hpc != 0 || ws == nullptr || rowmax == nullptr)
    return (int)cudaErrorInvalidValue;
  const int rows = B * S;
  cudaError_t err = cudaMemsetAsync(rowmax, 0, sizeof(unsigned int) * rows, st);
  if (err != cudaSuccess) return (int)err;
  err = launch_attention<kTwoStep>(qkv, nullptr, static_cast<float*>(ws),
                                   static_cast<unsigned int*>(rowmax), B, S,
                                   H, D, n_keys, c, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_quant_rows(static_cast<const float*>(ws),
                                static_cast<const unsigned int*>(rowmax), q, s,
                                rows, H * D, st);
}

// The cluster epilogue at head width D: info[0] and info[1] the clusters
// of 16 and of 8 the card holds at once (cudaOccupancyMaxActiveClusters;
// a CUDA error negated), info[2] the heads a block the launch takes (0 in
// a two-step build).
extern "C" int hirest_attention_qkv3_cluster_info(int D, int* info) {
  if (D != 88 && D != 128) return (int)cudaErrorInvalidValue;
  info[0] = D == 88 ? max_clusters<88, 1>() : max_clusters<128, 1>();
  info[1] = D == 88 ? max_clusters<88, 2>() : max_clusters<128, 2>();
  info[2] = HIREST_QKV3_TWO_STEP ? 0
            : D == 88            ? heads_per_block<88>()
                                 : heads_per_block<128>();
  return (int)cudaGetLastError();
}

extern "C" const char* hirest_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
