// Softmax attention on one warp-specialised Hopper body, in two forms: v3
// (K1, K3; K9 launches the same entry points) over fused, bias-complete
// qkv rows, and v1 (K6, K7, K8) over split-heads, packed-heads or fused
// qkv tensors; bf16 output, or an int8 row-quantization epilogue (K3, K8).
//
// Replaces hirest_tpu/ops/attention.py::fused_attention_qkv3 (kernel bodies
// _attn_heads_batched via _attn_kernel_qkv3, and _attn_kernel_qkv3_quant
// with the pad-key mask _mask_pad_keys), fused_attention_qkv2 (K9, bodies
// _attn_kernel_qkv2 and _attn_kernel_qkv2_quant), which computes v3's
// function one head at a time (the loop over heads is TPU scheduling),
// _pallas_attention (K6, bodies _attn_kernel and _attn_kernel_masked),
// _pallas_attention_packed (K7, bodies _attn_kernel_packed and
// _attn_kernel_packed_masked) and fused_attention_qkv (K8, bodies
// _attn_kernel_qkvfused and _attn_kernel_qkvfused_quant).
//
// v3, for each (b, h), q/k/v the head-h column slices of qkv[b] and
// n_keys = min(n_real, S) (S when n_real is 0):
//   s   = q k^T            f32, unscaled; keys >= n_keys excluded
//   m   = rowmax(s)
//   p   = bf16(exp2((s - m) * c)),  c = scale * log2(e)
//   den = sum(float(p))     f32
//   o   = (p v accumulated in f32) / den
// The reference masks keys >= n_real to -1e30 before the row max, which
// makes their p exactly 0; leaving them out of the max and the sums gives
// the same bits.
// v1, for each (b, h), over keys j < Sk with valid(j) = (no mask, or
// mask[b, j] != 0):
//   q   = bf16(q + q_bias),  v = bf16(v + v_bias)    K8 only: bf16 adds
//   s   = (q k^T in f32) * scale;   s[:, j] = -1e30 where !valid(j)
//   m   = rowmax(s),   l = sum_j exp(s - m)          f32
//   p   = bf16(exp(s - m) / l)                       normalised, then rounded
//   o   = p v accumulated in f32
// Both write out[b, :, h*D:(h+1)*D] = bf16(o), or (K3, K8's quant_out)
// quantize each token's whole H*D row of f32 o (all heads, never rounded
// to bf16): sc = max(max|o| / 127, 1e-8), q = clamp(rint(o / sc), +-127).
//
// Bounds on an H100 SXM (EVA-g, B=128, S=257, H=16, D=88): K1 reads qkv
// [128, 257, 4224] bf16 (278 MB) and writes [128, 257, 1408] bf16 (93 MB;
// K3: 46 MB of int8 and 0.13 MB of scales): 0.1106 ms (K3: 0.0968) at 3.35
// TB/s, against 0.048 ms for its 47.6 GFLOP of QK^T and PV at the 989
// TFLOP/s dense bf16 rate. K6 and K8 move the same bytes (K8's biases are
// 5.6 KB; K8 int8 0.0968 ms). At the padded head width (models/eva_pad.py:
// H=16, D=128) K1 and K7 read 404 MB and write 135 MB (K3: 67 MB of int8):
// 0.1609 ms (K3: 0.1408), against 0.070 ms for 69.3 GFLOP. All are bound
// by memory.
//
// Design: one warp-specialised body for both forms, every head width and
// both outputs; the form, the epilogue and the head width are template
// parameters (as runtime branches, a bias branch once cost the streamed
// body that came before this one 8-12 %).
// - Work items are (b, query tile, h), heads fastest. A persistent grid
//   (one block an SM) walks them with a static stride (the cluster
//   epilogue's grid: by group, below).
// - A block is three consumer warpgroups of 64 query rows each (a query
//   tile is kRows = 192 rows; 160 registers a thread after setmaxnreg)
//   and a producer warpgroup (24 registers; 32 in K8's form), whose one
//   thread issues every TMA load: each consumer's Q tile into its own
//   buffer (a full and an empty mbarrier each; the next item's Q lands
//   while this one computes), and K and V tiles into a ring of kStages
//   stages (a full and an empty mbarrier each). Every consumer reads every
//   stage, so a head's K and V pass through L2 once for 192 query rows,
//   and the next tile's loads, and the next item's, overlap this tile's
//   math. A consumer whose rows all lie past Sq only keeps the ring's
//   count: at 257 rows a head's second item has 65 rows, one consumer's
//   64, one's 1 and none for the third. The consumers share the SM's math,
//   so the idle one costs no time, but the 1-row tile costs a full one
//   (wgmma's M is 64).
// - v1's q, k and v each have a TMA map over a 4-d view [B, S, H, D] (or
//   [B, H, S, D], S and H in the order of their strides; D innermost):
//   K6's split-heads views, K7's packed tensors and K8's thirds of its qkv
//   are all one launch with no copy; v3 maps qkv once, as [B, S, 3H, D],
//   q's heads first, then k's and v's. A box never
//   crosses a head or an image: rows past S and head columns past D read
//   as zeros. A box is 64 rows by 32 columns (64 bytes, 64-byte swizzle);
//   a tile of 64 rows is 2 boxes at D=64, 3 at D=88 (columns 88..95 zero,
//   so QK^T runs over 96 = 6 x 16 columns with nothing but zeros past the
//   head) and 4 at D=128.
// - Each consumer reads its q fragments out of its Q tile once (ldmatrix,
//   de-swizzled) into registers, as wgmma's A operand (K8: q's bias added
//   to them, add_bf16x2). QK^T is wgmma m64n64k16 (bf16 -> f32) against
//   the K-major K tile. PV is wgmma m64n64k16 / m64n96k16 / m64n128k16
//   with p from registers (the score accumulator's layout is the A
//   fragment's) and V as the MN-major B operand straight from its TMA
//   tile: no V^T is ever stored. PV at D=88 runs 96 wide over the zero
//   columns, whose outputs are dropped.
// - Two passes, because both references round p against the exact final
//   row max. v3: pass 1 takes the row max over QK^T, pass 2 recomputes
//   QK^T and forms p = bf16(2^(s c - m c)), m c rounded once a row, by
//   ex2.approx.ftz on one FFMA; the f32 row sum is of the rounded p; o is
//   multiplied by the correctly rounded reciprocal of the sum after PV.
//   v1: s = __fmul_rn(q k^T, scale) (rounded on its own, never contracted
//   into an FMA), masked keys -1e30; pass 1 folds a running (max, sum) a
//   row, one 64-key tile at a time: the tile's max first (over the row's
//   quad of lanes), the sum rescaled once a tile, then e = 2^(s log2e -
//   m log2e) by ex2.approx.ftz, m log2e rounded once a row and the rest
//   one FFMA (with a key mask (x - m) log2e, since a row whose keys are
//   all masked has x = m = -1e30, where x log2e - m log2e is not 0);
//   pass 2 forms p = bf16(e * r), r = __frcp_rn(l) once a row, and PV is
//   o, with no divide after it. Each tile's PV runs while the next tile is
//   awaited and its scores issued. Keys past n_keys are left out by the
//   last tile's bound (p = 0), with no branch a score on the other tiles:
//   any S and n_keys stream through the ring.
// - K8's v bias is added to each landed V tile in shared memory before any
//   consumer's PV reads it, rounded as the reference rounds it (the f32
//   sum, one bf16 rounding): the producer warpgroup's three idle warps
//   wait for the stage, add the head's bias to each 16-byte chunk in place
//   (swizzle-aware: chunk j of row r lies at chunk j ^ ((r >> 1) & 3)),
//   fence the async proxy (wgmma reads V as the async proxy does) and
//   arrive on the stage's vready mbarrier, which the consumers wait on
//   before PV. They arrive at every stage, pass 1's too, so that vready's
//   phases keep full's. So the biased q and v never exist in device
//   memory.
// - Every wgmma sequence is straight-line (the last key tile is computed
//   whole, its keys past n_keys masked), which keeps ptxas from
//   serialising the wgmma pipeline around branches. At D=128 it still
//   serialises it for lack of registers (a consumer thread's 160 hold 64
//   PV accumulators, 32 scores and 32 q fragment registers).
// - The int8 epilogue's row scale needs all H heads of a row. At H = 16
//   (EVA-g's heads, and the padded heads of models/eva_pad.py) the heads
//   of one group (b, query tile) run at once on the blocks of one
//   thread-block cluster, which exchange their rows' partial maxima
//   through distributed shared memory: no f32 workspace, no atomics, no
//   memset, no second launch. A cluster must sit in one GPC, and the
//   kernel runs one block an SM, so the cluster's size sets how many SMs
//   it can use: on an H100 SXM (cudaOccupancyMaxActiveClusters,
//   chip_smoke.py --time-attention) clusters of 16 held 7 x 16 = 112 SMs
//   and clusters of 8 held 15 x 8 = 120. The launch asks the card
//   (heads_per_block): clusters of 16, one head a block, where they hold
//   at least kClusterSms SMs; else clusters of 8 with two heads a block,
//   the first head's scaled f32 output parked in the block's shared memory
//   in place of two K/V ring stages, where the ring keeps kMinStages
//   (d = 88: 5 of 7); else (d = 128, whose ring would keep 2 of 5)
//   clusters of 16. The persistent grid walks the groups by cluster.
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
//   quantizes the workspace rows (launch_quant_rows). This moves 370 MB
//   more than the bound counts at EVA-g's shape.

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
constexpr int kConsumerRegs = 160;
constexpr float kLog2e = 1.4426950408889634f;

// What the kernel computes: v3 (K1, K3, K9), or v1 (K6 and K7, with or
// without their key mask; K8, with its q/v biases)
enum Form { kV3 = 0, kV1 = 1, kV1Mask = 2, kV1Bias = 3 };
// What the kernel writes: bf16 o (K1, K6, K7, K8), the two-step int8
// epilogue's workspace and row maxima (K3, K8 int8 at any H), or codes and
// scales by the cluster epilogue (K3, K8 int8 at H = kClusterHeads)
enum Mode { kBf16Out = 0, kTwoStep = 1, kCluster = 2 };
constexpr int kClusterHeads = 16;  // the head count the cluster epilogue takes
// clusters of one head a block where the card holds this many SMs in them,
// else two heads a block where the K/V ring keeps this many stages
constexpr int kClusterSms = 128;
constexpr int kMinStages = 4;

template <int D, int kMode = kBf16Out, int kHPC = 1>
struct Geo {
  static_assert(D == 64 || D == 88 || D == 128,
                "head widths the kernel is built for");
  static_assert(kHPC == 1 || (kHPC == 2 && kMode == kCluster),
                "two heads a block only in the cluster epilogue");
  static constexpr int kBoxes = (D + kBoxCols - 1) / kBoxCols;  // 2, 3 or 4
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
  static_assert(8 * (3 * kStages + 2 * kGroups + 2) <= kBarriers,
                "the mbarriers fit their room");
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

// The kernel's arguments: the three TMA maps and the rest, one parameter.
struct Params {
  CUtensorMap q, k, v;  // bf16 [B, S, H, D] views, or [B, H, S, D]; v3: q
                        // only, qkv as [B, S, 3H, D]
  void* out;            // bf16 o or int8 codes [B, S, H*D]
  float* ws;            // the two-step epilogue's workspace [B, S, H*D]
  unsigned int* rowmax;  // and its row maxima [B, S]
  float* scales;        // the cluster epilogue's scales [B, S]
  const int* mask;      // kV1Mask: [B, n_keys], nonzero marks a valid key
  const __nv_bfloat16* qbias;  // kV1Bias: [H * D] each, 16-byte aligned
  const __nv_bfloat16* vbias;
  int S, H, n_keys;  // query rows, heads, keys
  int items;         // work items, or the cluster epilogue's groups
  int heads_inner;   // bit i: map i (q, k, v) has H before S
  float c;           // v3: scale * log2(e); v1: scale
};

// PV over one 16-key step: o += p v, V's tile MN-major (its 32-column
// boxes kBoxBytes apart).
template <int D>
__device__ __forceinline__ void pv_step(float (&o)[Geo<D>::kAcc],
                                        const uint32_t (&p)[4],
                                        uint32_t v_addr) {
  const uint64_t db = smem_desc_mn64(v_addr, kBoxBytes);
  if constexpr (D == 64)
    wgmma_bf16_n64<1>(o, p, db, 1);
  else if constexpr (D == 88)
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

// The rounded p of one score pair, its f32 sum added to l (v3).
__device__ __forceinline__ uint32_t prob_pair(float x0, float x1, float c,
                                              float mc, float& l) {
  const uint32_t p =
      pack_f32_bf16(ex2_ftz(fmaf(x0, c, -mc)), ex2_ftz(fmaf(x1, c, -mc)));
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&p);
  l += __low2float(b) + __high2float(b);
  return p;
}

// v1: one tile's scores as the reference scales them, in place: x = s *
// scale rounded on its own, -1e30 where the key is masked (mk: the tile's
// key mask, kMask) and, on the last tile (kEdge), -inf at keys >= n (the
// keys left from the tile's first: left out). Score 4i + e is row g + 8
// (e / 2)'s key 8i + 2t + e % 2.
template <bool kMask, bool kEdge>
__device__ __forceinline__ void scale_scores(float (&s)[32], float scale,
                                             const int* mk, int n, int t) {
#pragma unroll
  for (int i = 0; i < kKeys / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = 8 * i + 2 * t + e;
      float x0 = __fmul_rn(s[4 * i + e], scale);
      float x1 = __fmul_rn(s[4 * i + 2 + e], scale);
      if constexpr (kMask) {
        if ((!kEdge || key < n) && mk[key] == 0) x0 = x1 = -1e30f;
      }
      if (kEdge && key >= n) x0 = x1 = -INFINITY;
      s[4 * i + e] = x0;
      s[4 * i + 2 + e] = x1;
    }
}

// v1: e = exp(x - m) as 2^(x log2e - ml), ml = m log2e rounded, the
// argument one FFMA; with a key mask 2^((x - m) log2e).
template <bool kMask>
__device__ __forceinline__ float exp_v1(float x, float m, float ml) {
  if constexpr (kMask) return ex2_ftz((x - m) * kLog2e);
  return ex2_ftz(fmaf(x, kLog2e, -ml));
}

// v1's pass 1 on one tile of scaled scores: each row's (max m, sum l)
// takes the tile's max over the row's quad first, rescales l once, then
// adds the tile's e. m starts at -inf and l at 0 (2^-inf = 0).
template <bool kMask>
__device__ __forceinline__ void fold_v1(const float (&x)[32], float& m0,
                                        float& l0, float& m1, float& l1) {
  float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < kKeys / 8; ++i) {
    t0 = fmaxf(t0, fmaxf(x[4 * i], x[4 * i + 1]));
    t1 = fmaxf(t1, fmaxf(x[4 * i + 2], x[4 * i + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, off));
    t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, off));
  }
  if (t0 > m0) {
    l0 *= ex2_ftz((m0 - t0) * kLog2e);
    m0 = t0;
  }
  if (t1 > m1) {
    l1 *= ex2_ftz((m1 - t1) * kLog2e);
    m1 = t1;
  }
  const float ml0 = m0 * kLog2e, ml1 = m1 * kLog2e;
  float e0 = 0.f, e1 = 0.f;
#pragma unroll
  for (int i = 0; i < kKeys / 8; ++i) {
    e0 += exp_v1<kMask>(x[4 * i], m0, ml0) + exp_v1<kMask>(x[4 * i + 1], m0, ml0);
    e1 += exp_v1<kMask>(x[4 * i + 2], m1, ml1) +
          exp_v1<kMask>(x[4 * i + 3], m1, ml1);
  }
  l0 += e0;
  l1 += e1;
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

// p.out: bf16 o [B, S, H*D] (kBf16Out) or int8 codes [B, S, H*D]
// (kCluster); p.ws, p.rowmax: the two-step epilogue's workspace and row
// maxima (kTwoStep); p.scales [B, S] (kCluster). p.items: (b, query tile,
// h) work items, or with kCluster the (b, query tile) groups.
template <int D, int kMode, int kHPC, int kForm>
__global__ void __launch_bounds__(kThreads, 1)
    attention_qkv3_kernel(const __grid_constant__ Params p) {
  using G = Geo<D, kMode, kHPC>;
  static_assert(kForm == kV3 || kForm == kV1Bias || kMode == kBf16Out,
                "K6 and K7 write bf16");
  constexpr bool kMask = kForm == kV1Mask;
  constexpr bool kBias = kForm == kV1Bias;
  // K8's producer warpgroup also adds v's bias: 32 registers a thread
  // (128 x (3 x 160 + 32) = 65,536, all of the SM's)
  constexpr int kProducerRegs = kBias ? 32 : 24;
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
  uint64_t* vready = xfull + 2;        // [kStages]: K8's biased V landed
  const int S = p.S, H = p.H, n_keys = p.n_keys, items = p.items;
  const float c = p.c;
  const int q_tiles = (S + kRows - 1) / kRows;
  const int key_tiles = (n_keys + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kGroups);
      if constexpr (kBias) mbar_init(&vready[s], 3);
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
      // one 64-row tile of i (q, k, v) from row0 of head h, image b: map i,
      // or v3's one map at head i H + h
      auto load_tile = [&](uint8_t* dst, uint64_t* bar, int i, int h,
                           int row0, int b) {
        const CUtensorMap* map =
            kForm == kV3 || i == 0 ? &p.q : i == 1 ? &p.k : &p.v;
        const bool hi = kForm == kV3 || ((p.heads_inner >> i) & 1);
        if (kForm == kV3) h += i * H;
#pragma unroll
        for (int bx = 0; bx < G::kBoxes; ++bx) {
          if (hi)
            tma_load_4d(dst + bx * kBoxBytes, map, bar, bx * kBoxCols, h,
                        row0, b);
          else
            tma_load_4d(dst + bx * kBoxBytes, map, bar, bx * kBoxCols, row0,
                        h, b);
        }
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
    if constexpr (kBias) {
      // warps 1..3: v's bias onto each landed V tile (columns past D, zero,
      // stay so; rows past n_keys get the bias, which their p = 0 leaves
      // out), then vready. Unit u is 16-byte chunk c of the rows r0, r0 +
      // 8, .., r0 + 56 of box u / 32, which the swizzle keeps in one place
      // in each of them (chunk j of row r lies at j ^ ((r >> 1) & 3)), so
      // one 16-byte load of the bias serves its 8 rows. Few live registers:
      // the producer warpgroup keeps 32 a thread.
      constexpr int kUnits = G::kBoxes * 32;  // (box, r0, chunk)
      const int pw = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
      if (pw > 0) {
        const int bt = threadIdx.x - kGroups * 128 - 32;  // 0..95
        int step = 0, b, qt, h;
        for (int k = 0; item(k, b, qt, h); ++k) {
          const __nv_bfloat16* vb = p.vbias + h * D;
          for (int i = 0; i < 2 * key_tiles; ++i, ++step) {
            const int s = step % G::kStages;
            mbar_wait(&full[s], (step / G::kStages) & 1);
            if (i >= key_tiles) {
#pragma unroll
              for (int u = bt; u < kUnits; u += 96) {
                const int r0 = u / 4 % 8, c = u % 4;
                const int col = (u / 32) * kBoxCols + (c ^ (r0 >> 1)) * 8;
                if (col >= D) continue;
                const uint4 bias =
                    __ldg(reinterpret_cast<const uint4*>(vb + col));
                const uint32_t a = smem_u32(ring) + s * G::kStage + G::kSlot +
                                   (u / 32) * kBoxBytes + r0 * 64 + c * 16;
                // two rows' loads in flight before their stores
#pragma unroll
                for (int r = 0; r < kKeys / 8; r += 2) {
                  const uint4 x0 = ld_shared_v4(a + r * 512);
                  const uint4 x1 = ld_shared_v4(a + r * 512 + 512);
                  st_shared_v4(a + r * 512, add_bf16x8(x0, bias));
                  st_shared_v4(a + r * 512 + 512, add_bf16x8(x1, bias));
                }
              }
              fence_proxy_async();
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(&vready[s]);
          }
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
        if (row0 < S) p.scales[(size_t)pend_b * S + row0] = s0;
        if (row1 < S) p.scales[(size_t)pend_b * S + row1] = s1;
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
      int8_t* q = static_cast<int8_t*>(p.out) + (size_t)rank * G::kCodeRow;
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
        // first product has read the fragments. K8 adds q's bias to them
        // (fragment kc holds columns 16 kc + 2t, + 1 and, in its third and
        // fourth registers, 16 kc + 8 + 2t, + 1; columns past D stay 0).
        uint32_t qa[G::kChunks][4];
        if (active) {
          // K8: the bias pairs of this thread's columns, loaded while the
          // Q tile is awaited
          uint32_t qb[G::kChunks][2];
          if constexpr (kBias) {
            const __nv_bfloat16* bias = p.qbias + h * D + 2 * t;
#pragma unroll
            for (int kc = 0; kc < G::kChunks; ++kc) {
              qb[kc][0] = kc * 16 < D ? ld_u32(bias + kc * 16) : 0u;
              qb[kc][1] = kc * 16 + 8 < D ? ld_u32(bias + kc * 16 + 8) : 0u;
            }
          }
          mbar_wait(&qfull[wg], q_loads++ & 1);
          const uint8_t* qs = qbuf + wg * G::kSlot;
          const int r = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int kc = 0; kc < G::kChunks; ++kc) {
            const int chunk = (kc % 2) * 2 + (lane >> 4);
            ldmatrix_x4(qa[kc], qs + (kc / 2) * kBoxBytes + r * 64 +
                                    ((chunk ^ ((r >> 1) & 3)) << 4));
          }
          if constexpr (kBias) {
#pragma unroll
            for (int kc = 0; kc < G::kChunks; ++kc) {
              if (kc * 16 < D) {
                qa[kc][0] = add_bf16x2(qa[kc][0], qb[kc][0]);
                qa[kc][1] = add_bf16x2(qa[kc][1], qb[kc][0]);
              }
              if (kc * 16 + 8 < D) {
                qa[kc][2] = add_bf16x2(qa[kc][2], qb[kc][1]);
                qa[kc][3] = add_bf16x2(qa[kc][3], qb[kc][1]);
              }
            }
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

        // v1's key mask of this item's image, and of key tile kt
        const int* mrow = kMask ? p.mask + (size_t)b * n_keys : nullptr;
        // Pass 1: v3 the exact row max over the real keys; v1 each row's
        // running (max, sum).
        float sc[32];
        float m0 = -INFINITY, m1 = -INFINITY;
        float l0 = 0.f, l1 = 0.f;
        for (int kt = 0; kt < key_tiles; ++kt, ++step) {
          const int s = wait_full();
          const int n = n_keys - kt * kKeys;
          scores<D>(sc, qa, ring_addr + s * G::kStage);
          release(&empty[s]);
          if (kt == 0) release(&qempty[wg]);
          if constexpr (kForm != kV3) {
            const int* mk = kMask ? mrow + kt * kKeys : nullptr;
            if (n >= kKeys)
              scale_scores<kMask, false>(sc, c, mk, n, t);
            else
              scale_scores<kMask, true>(sc, c, mk, n, t);
            fold_v1<kMask>(sc, m0, l0, m1, l1);
          } else           if (n >= kKeys) {
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
        // v3: m c a row; v1: m log2e and 1 / l a row
        float mc0, mc1, r0 = 1.f, r1 = 1.f;
        if constexpr (kForm == kV3) {
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
            m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
          }
          mc0 = m0 * c;
          mc1 = m1 * c;
        } else {
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            l0 += __shfl_xor_sync(0xffffffffu, l0, off);
            l1 += __shfl_xor_sync(0xffffffffu, l1, off);
          }
          mc0 = m0 * kLog2e;
          mc1 = m1 * kLog2e;
          r0 = __frcp_rn(l0);
          r1 = __frcp_rn(l1);
        }
        if constexpr (kMode == kCluster) {
          // the last group's codes, meanwhile
          if (kOverlap && hb == 0 && pend_n >= 0) finish();
        }

        // Pass 2: v3 p = bf16(2^(s c - m c)), l += p; v1 p = bf16(e r);
        // o += p v. Each tile's PV runs while the next tile's K and V are
        // awaited and its scores issued.
        float o[G::kAcc];
#pragma unroll
        for (int i = 0; i < G::kAcc; ++i) o[i] = 0.f;
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
          if constexpr (kForm != kV3) {
            const int* mk = kMask ? mrow + kt * kKeys : nullptr;
            if (n >= kKeys)
              scale_scores<kMask, false>(sc, c, mk, n, t);
            else
              scale_scores<kMask, true>(sc, c, mk, n, t);
#pragma unroll
            for (int i = 0; i < kKeys / 8; ++i) {
              pa[i / 2][2 * (i % 2)] =
                  pack_f32_bf16(exp_v1<kMask>(sc[4 * i], m0, mc0) * r0,
                                exp_v1<kMask>(sc[4 * i + 1], m0, mc0) * r0);
              pa[i / 2][2 * (i % 2) + 1] =
                  pack_f32_bf16(exp_v1<kMask>(sc[4 * i + 2], m1, mc1) * r1,
                                exp_v1<kMask>(sc[4 * i + 3], m1, mc1) * r1);
            }
          } else if (n >= kKeys) {
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
          // K8: the stage's V has its bias
          if constexpr (kBias) mbar_wait(&vready[s], (step / G::kStages) & 1);
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

        // y = o f: v3 f = 1 / l; v1 f = 1 (p was normalised)
        float f0 = 1.f, f1 = 1.f;
        if constexpr (kForm == kV3) {
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            l0 += __shfl_xor_sync(0xffffffffu, l0, off);
            l1 += __shfl_xor_sync(0xffffffffu, l1, off);
          }
          f0 = __frcp_rn(l0);
          f1 = __frcp_rn(l1);
        }
        const int row0 = first_row + 16 * warp + g, row1 = row0 + 8;
        if constexpr (kMode == kBf16Out) {
          __nv_bfloat16* o0 = static_cast<__nv_bfloat16*>(p.out) +
                              ((size_t)b * S + row0) * hd + h * D + 2 * t;
          __nv_bfloat16* o1 = o0 + 8 * (size_t)hd;
#pragma unroll
          for (int i = 0; i < G::kOTiles; ++i) {
            if (row0 < S)
              *reinterpret_cast<uint32_t*>(o0 + 8 * i) =
                  pack_f32_bf16(o[4 * i] * f0, o[4 * i + 1] * f0);
            if (row1 < S)
              *reinterpret_cast<uint32_t*>(o1 + 8 * i) =
                  pack_f32_bf16(o[4 * i + 2] * f1, o[4 * i + 3] * f1);
          }
        } else {
          float y[G::kOTiles][4];
#pragma unroll
          for (int i = 0; i < G::kOTiles; ++i) {
            y[i][0] = o[4 * i] * f0;
            y[i][1] = o[4 * i + 1] * f0;
            y[i][2] = o[4 * i + 2] * f1;
            y[i][3] = o[4 * i + 3] * f1;
          }
          if constexpr (kMode == kTwoStep) {
            float* w0 = p.ws + ((size_t)b * S + row0) * hd + h * D + 2 * t;
            unsigned int* mx = p.rowmax + (size_t)b * S + row0;
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

// A bf16 [B, H, S, D] view (element strides st = (batch, head, row), unit
// stride along D) as a 4-d TMA map, S and H in the order of their strides,
// read in boxes of 64 rows by 32 columns, 64-byte swizzled; rows past S
// and columns past D read as zeros. Sets *heads_inner when H comes first.
cudaError_t head_map(CUtensorMap* map, const void* base, int B, int H, int S,
                     int D, const long long* st, bool* heads_inner) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorInitializationError;
  if (reinterpret_cast<uintptr_t>(base) % 16)
    return cudaErrorMisalignedAddress;
  for (int i = 0; i < 3; ++i)
    if (st[i] <= 0 || st[i] % 8) return cudaErrorInvalidValue;
  const bool hi = st[1] < st[2];
  *heads_inner = hi;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)(hi ? H : S),
                              (cuuint64_t)(hi ? S : H), (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(hi ? st[1] : st[2]) * 2,
                                 (cuuint64_t)(hi ? st[2] : st[1]) * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBoxCols, hi ? 1u : (cuuint32_t)kKeys,
                             hi ? (cuuint32_t)kKeys : 1u, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The three maps of q [B, H, Sq, D] and k, v [B, H, Sk, D] at `bases`,
// with the (batch, head, row) element strides of each in st[0..8].
cudaError_t head_maps(Params* p, const void* const* bases, int B, int Sq,
                      int Sk, int D, const long long* st) {
  CUtensorMap* maps[3] = {&p->q, &p->k, &p->v};
  p->heads_inner = 0;
  for (int i = 0; i < 3; ++i) {
    bool hi = false;
    const cudaError_t err = head_map(maps[i], bases[i], B, p->H,
                                     i == 0 ? Sq : Sk, D, st + 3 * i, &hi);
    if (err != cudaSuccess) return err;
    p->heads_inner |= (int)hi << i;
  }
  return cudaSuccess;
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

// The work items (b, query tile, h) of p's B images, or (cluster) the
// groups (b, query tile); false past an int.
bool count_items(Params* p, int B, bool groups) {
  const long long n = (long long)B * (groups ? 1 : p->H) *
                      ((p->S + kRows - 1) / kRows);
  p->items = (int)n;
  return n <= 0x7fffffffLL;
}

template <int D, int kMode, int kForm>
cudaError_t launch_grid(Params p, int B, cudaStream_t stream) {
  using G = Geo<D, kMode>;
  const auto kernel = attention_qkv3_kernel<D, kMode, 1, kForm>;
  // the shared-memory opt-in, once an instantiation
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kSmem);
  if (opt_in != cudaSuccess) return opt_in;
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  if (!count_items(&p, B, false)) return cudaErrorInvalidValue;
  const int grid = p.items < sms ? p.items : sms;
  kernel<<<grid, kThreads, G::kSmem, stream>>>(p);
  return cudaGetLastError();
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
template <int D, int kHPC, int kForm>
int max_clusters() {
  static const int n = [] {
    const auto kernel = attention_qkv3_kernel<D, kCluster, kHPC, kForm>;
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
template <int D, int kForm>
int heads_per_block() {
  if (max_clusters<D, 1, kForm>() * kClusterHeads >= kClusterSms) return 1;
  return Geo<D, kCluster, 2>::kStages >= kMinStages ? 2 : 1;
}

template <int D, int kHPC, int kForm>
cudaError_t launch_cluster(Params p, int B, cudaStream_t stream) {
  const int most = max_clusters<D, kHPC, kForm>();
  if (most < 0) return (cudaError_t)-most;
  if (most == 0) return cudaErrorInvalidConfiguration;
  if (!count_items(&p, B, true)) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<D, kHPC>(
      &attr, p.items < most ? p.items : most, stream);
  void* args[] = {&p};
  const cudaError_t err = cudaLaunchKernelExC(
      &cfg, (const void*)attention_qkv3_kernel<D, kCluster, kHPC, kForm>,
      args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

#ifndef HIREST_QKV3_TWO_STEP
#define HIREST_QKV3_TWO_STEP 0
#endif

// Launch form kForm at head width D: bf16 out (quant false), or the int8
// epilogue, codes into p.out and scales into p.scales: at kClusterHeads
// heads the cluster epilogue with hpc heads a block (1 or 2; 0:
// heads_per_block's choice), else (or in a two-step build) the two-step
// one (hpc 0) on p.ws and p.rowmax, which it zeroes, then quant_rows.
template <int D, int kForm>
cudaError_t launch(Params& p, int B, bool quant, int hpc,
                   cudaStream_t stream) {
  if constexpr (kForm == kV1 || kForm == kV1Mask) {
    if (quant) return cudaErrorInvalidValue;
  }
  if (!quant) return launch_grid<D, kBf16Out, kForm>(p, B, stream);
  if constexpr (kForm == kV3 || kForm == kV1Bias) {
    if (!HIREST_QKV3_TWO_STEP && p.H == kClusterHeads) {
      if (hpc == 0) hpc = heads_per_block<D, kForm>();
      if (hpc == 1) return launch_cluster<D, 1, kForm>(p, B, stream);
      if (hpc == 2) return launch_cluster<D, 2, kForm>(p, B, stream);
      return cudaErrorInvalidValue;
    }
    if (hpc != 0 || p.ws == nullptr || p.rowmax == nullptr)
      return cudaErrorInvalidValue;
    const int rows = B * p.S;
    cudaError_t err = cudaMemsetAsync(p.rowmax, 0,
                                      sizeof(unsigned int) * rows, stream);
    if (err != cudaSuccess) return err;
    err = launch_grid<D, kTwoStep, kForm>(p, B, stream);
    if (err != cudaSuccess) return err;
    void* codes = p.out;
    return launch_quant_rows(p.ws, p.rowmax, codes, p.scales, rows,
                             p.H * D, stream);
  }
  return cudaErrorInvalidValue;
}

// v3 at head width 88 or 128 on qkv [B, S, 3*H*D]: one map over it as
// [B, S, 3H, D], whose heads i H + h are q's, k's and v's.
cudaError_t launch_v3(const void* qkv, Params& p, int B, int D, bool quant,
                      int hpc, cudaStream_t stream) {
  const long long hd = (long long)p.H * D;
  const long long st[3] = {p.S * 3 * hd, D, 3 * hd};
  bool hi = false;
  cudaError_t err = head_map(&p.q, qkv, B, 3 * p.H, p.S, D, st, &hi);
  if (err != cudaSuccess) return err;
  if (D == 88) return launch<88, kV3>(p, B, quant, hpc, stream);
  if (D == 128) return launch<128, kV3>(p, B, quant, hpc, stream);
  return cudaErrorInvalidValue;
}

// v1 at head width 64, 88 or 128 on q [B, H, Sq, D] and k, v [B, H, Sk, D]
// views: K6/K7 without or with the key mask, K8 with the biases.
template <int kForm>
cudaError_t launch_v1_form(Params& p, int B, int D, bool quant, int hpc,
                           cudaStream_t stream) {
  switch (D) {
    case 64: return launch<64, kForm>(p, B, quant, hpc, stream);
    case 88: return launch<88, kForm>(p, B, quant, hpc, stream);
    case 128: return launch<128, kForm>(p, B, quant, hpc, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_v1(const void* q, const void* k, const void* v, Params& p,
                      int B, int Sk, int D, const long long* strides,
                      bool quant, int hpc, cudaStream_t stream) {
  const void* bases[3] = {q, k, v};
  cudaError_t err = head_maps(&p, bases, B, p.S, Sk, D, strides);
  if (err != cudaSuccess) return err;
  p.n_keys = Sk;
  if (p.qbias != nullptr)
    return launch_v1_form<kV1Bias>(p, B, D, quant, hpc, stream);
  if (p.mask != nullptr)
    return launch_v1_form<kV1Mask>(p, B, D, quant, hpc, stream);
  return launch_v1_form<kV1>(p, B, D, quant, hpc, stream);
}

bool bad_shape(int B, int S, int H, int n_keys) {
  return B <= 0 || S <= 0 || H <= 0 || n_keys <= 0;
}

// The cluster epilogue's info at head width D for form kForm.
template <int D, int kForm>
void cluster_info(int* info) {
  info[0] = max_clusters<D, 1, kForm>();
  info[1] = max_clusters<D, 2, kForm>();
  info[2] = HIREST_QKV3_TWO_STEP ? 0 : heads_per_block<D, kForm>();
}

}  // namespace

// v3. qkv [B, S, 3*H*D] bf16 contiguous and 16-byte aligned, biases
// pre-added, D = 88 or 128; out [B, S, H*D] bf16.
// Keys >= n_keys (1 <= n_keys <= S) are left out. c = scale * log2(e).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int hirest_attention_qkv3_bf16(const void* qkv, void* out, int B,
                                          int S, int H, int D, int n_keys,
                                          float c, void* stream) {
  if (bad_shape(B, S, H, n_keys) || n_keys > S)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.out = out;
  p.S = S;
  p.H = H;
  p.n_keys = n_keys;
  p.c = c;
  return (int)launch_v3(qkv, p, B, D, false, 0, (cudaStream_t)stream);
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
  if (bad_shape(B, S, H, n_keys) || n_keys > S ||
      reinterpret_cast<uintptr_t>(q) % 16)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.out = q;
  p.ws = static_cast<float*>(ws);
  p.rowmax = static_cast<unsigned int*>(rowmax);
  p.scales = static_cast<float*>(s);
  p.S = S;
  p.H = H;
  p.n_keys = n_keys;
  p.c = c;
  return (int)launch_v3(qkv, p, B, D, true, hpc, (cudaStream_t)stream);
}

// v1 (K6, K7, K8). q [B, H, Sq, D], k and v [B, H, Sk, D]: bf16 views with
// unit stride along D; `strides` holds the (batch, head, row) element
// strides of q, k and v in that order, positive multiples of 8, and q, k
// and v are 16-byte aligned (the TMA maps'). mask is null or int32
// [B, Sk] (nonzero marks a valid key). qbias and vbias are both null, or
// both bf16 [H * D], 16-byte aligned, added to q and v (K8, which takes no
// mask). out [B, Sq, H*D] bf16. D = 64, 88 or 128; any Sq and Sk.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int hirest_attention_v1(const void* q, const void* k,
                                   const void* v, const void* mask,
                                   const void* qbias, const void* vbias,
                                   void* out, int B, int H, int Sq, int Sk,
                                   int D, const long long* strides,
                                   float scale, void* stream) {
  const bool bias = qbias != nullptr;
  if (bad_shape(B, Sq, H, Sk) || bias != (vbias != nullptr) ||
      (bias && mask != nullptr))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.out = out;
  p.mask = static_cast<const int*>(mask);
  p.qbias = static_cast<const __nv_bfloat16*>(qbias);
  p.vbias = static_cast<const __nv_bfloat16*>(vbias);
  p.S = Sq;
  p.H = H;
  p.c = scale;
  return (int)launch_v1(q, k, v, p, B, Sk, D, strides, false, 0,
                        (cudaStream_t)stream);
}

// K8 with the int8 epilogue instead of o (quant_out): q, k, v, the biases
// (required) and `strides` as above, no mask; codes [B, Sq, H*D] int8
// (16-byte aligned) and scales [B, Sq] f32 out. At H = 16 the cluster
// epilogue (hpc as hirest_attention_qkv3_quant's; ws and rowmax unused),
// else, or in a two-step build, the two-step epilogue on ws [B, Sq, H*D]
// f32 and rowmax [B, Sq], which it zeroes.
extern "C" int hirest_attention_v1_quant(
    const void* q, const void* k, const void* v, const void* qbias,
    const void* vbias, void* ws, void* rowmax, void* codes, void* scales,
    int B, int H, int Sq, int Sk, int D, const long long* strides, float scale,
    int hpc, void* stream) {
  if (bad_shape(B, Sq, H, Sk) || qbias == nullptr || vbias == nullptr ||
      reinterpret_cast<uintptr_t>(codes) % 16)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.out = codes;
  p.ws = static_cast<float*>(ws);
  p.rowmax = static_cast<unsigned int*>(rowmax);
  p.scales = static_cast<float*>(scales);
  p.qbias = static_cast<const __nv_bfloat16*>(qbias);
  p.vbias = static_cast<const __nv_bfloat16*>(vbias);
  p.S = Sq;
  p.H = H;
  p.c = scale;
  return (int)launch_v1(q, k, v, p, B, Sk, D, strides, true, hpc,
                        (cudaStream_t)stream);
}

// The cluster epilogue at head width D (v3: 88 or 128; v1, K8's form: 64,
// 88 or 128): info[0] and info[1] the clusters of 16 and of 8 the card
// holds at once (cudaOccupancyMaxActiveClusters; a CUDA error negated),
// info[2] the heads a block the launch takes (0 in a two-step build).
extern "C" int hirest_attention_qkv3_cluster_info(int D, int v1, int* info) {
  if (v1 && D == 64)
    cluster_info<64, kV1Bias>(info);
  else if (D == 88)
    v1 ? cluster_info<88, kV1Bias>(info) : cluster_info<88, kV3>(info);
  else if (D == 128)
    v1 ? cluster_info<128, kV1Bias>(info) : cluster_info<128, kV3>(info);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* hirest_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
