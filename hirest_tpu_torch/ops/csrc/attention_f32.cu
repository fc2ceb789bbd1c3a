// Softmax attention in float32 on the tensor cores, in 3xTF32: the f32
// counterpart of K1, K6, K7, K8 and K9.
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
// with f32 results. The max and sum are taken online, a 32-key tile at a
// time, and after PV o is multiplied by the correctly rounded 1 / sum. The
// TPU kernels' two softmax forms (K1/K9's exp2 with the divide after PV,
// K6/K7/K8's normalised p) differ in f32 only in the order of roundings,
// ~1e-7 relative, so this one body serves all of them.
//
// 3xTF32. One TF32 pass (10 mantissa bits) moves the output by ~4e-4 of
// its largest magnitude, 40x the 1e-5 bar the card holds the body to. So
// each f32 operand x is split into hi = tf32(x) and lo = tf32(x - hi)
// (cvt.rna.tf32.f32's rounding: to nearest, ties away; x - hi is exact in
// f32), and each product is taken as lo hi' + hi lo' + hi hi' into f32
// accumulators; lo lo' (~2^-22 relative) is the term left out. The CPU
// model of this arithmetic (tests/test_torch_attention_tf32x3.py, which
// prints it; inputs at the trunk's scale 0.75) errs against an f64
// product by, of max |o|:
//   [2, 12, 50, 64]: one pass 4.27e-4, 3xTF32 1.92e-7
//   [2, 16, 264, 88], 257 keys: one pass 3.68e-4, 3xTF32 2.24e-7
//   [2, 16, 257, 128]: one pass 3.56e-4, 3xTF32 2.40e-7
// The model rounds each product's sum once; the tensor cores round their
// partial sums as they go, not to nearest (so the card errs ~10x more);
// the card's errors against the plain f32 version are in PERF.md.
//
// The int8-out forms (K3, K9 and K8 with quant_out) take the same body and
// the attention kernels' two-step epilogue (rowquant.cuh): o is an f32
// [B, Sq, H*D] workspace, never rounded, and each warp folds its rows'
// max |o| into rowmax[b * Sq + row] with atomicMax on the float's bits
// (park_f32_tile); then quant_rows_kernel writes the codes and the row
// scales (one scale over all heads of a row: max / 127 floored at 1e-8,
// round-half-even quotients clipped to +-127).
//
// Bound on an H100 SXM, the larger of 3 x the f32 FLOP at the 494.7
// TFLOP/s dense TF32 rate and q, k, v read and o written at 3.35 TB/s:
// ViT-B/32's [128, 12, 50, 64]: 0.98 GFLOP (0.0060 ms) against 4 x 19.7 MB
// = 78.6 MB (0.0235 ms): bound by memory. EVA-g's [128, 16, 257, 88]: 47.6
// GFLOP (0.289 ms) against 4 x 185.3 MB = 741 MB (0.221 ms); at the padded
// head width [128, 16, 257, 128]: 69.3 GFLOP (0.420 ms) against 1078 MB
// (0.322 ms): bound by operations.
//
// Design: a persistent grid, one block an SM, four warpgroups.
// - Work items are (b, h, 128-row query tile), query tiles fastest; a block
//   walks them with a static stride, the grid one short of the SMs where
//   that would be a multiple of the query tiles a head (so that each block
//   gets its share of the short last tiles).
// - q, k and v each have a TMA map over the 4-d tensor [B, S, H, D] (S and
//   H in the order of their strides), read in boxes of 32 columns (128
//   bytes, 128-byte swizzle): rows past S and columns past D read as zeros,
//   so d = 88 runs 96 wide. Warp 0's one thread loads each consumer's
//   64-row Q tile into its own buffer, 32-key K tiles into the stages of a
//   ring and V tiles into two landing buffers.
// - The other seven warps of the first two warpgroups split each landed
//   tile into tf32 halves: K in place (hi over each raw box, lo in the box
//   after it), V transposed, since tf32 wgmma takes B K-major only: V^T hi
//   and lo [D][32 keys], 128-byte swizzled, with each 8-key group stored in
//   the order 0 2 4 6 1 3 5 7. Then p needs no shuffle: a thread's score
//   accumulators hold keys 2t and 2t + 1 of each 8-key slice, which are
//   the tf32 A fragment's columns t and t + 4 under that order. A warp's
//   lanes take 32 consecutive columns: no bank conflicts. The rounding is
//   two integer operations, not cvt, which runs on the SM's conversion
//   unit, a few results a clock.
// - Two consumer warpgroups of 64 query rows each share every stage. Each
//   splits its Q tile once an item (with the q bias): hi into registers as
//   A fragments, lo too at d = 64 and otherwise back over the raw tile,
//   read by descriptor. Scores: lo hi' (m64n32k8) into zeroed
//   accumulators, then hi hi' and hi lo' as one m64n64k8 product against a
//   box's hi and lo rows; the small terms first, so that the tensor
//   cores' partial sums round them before the large ones join. The
//   online softmax in f32 on the CUDA cores (expf, scores scaled by
//   __fmul_rn, keys past Sk left out, masked keys -1e30, so a row whose
//   keys are all masked gets a uniform p); PV is 3 x 4 wgmma m64nDk8
//   (D = 64, 96, 128) with p split in registers.
// - The consumers take turns (named barriers) to issue a tile's PV and
//   then the next tile's scores, so that one's softmax runs while the
//   other's products do; the PV completes before the scores are issued,
//   which frees p's registers (no spills at d = 128).
// - Shared memory, 1024-aligned: the two Q tiles, kStages stages (K hi and
//   lo, V^T hi and lo), two V landing buffers, the mbarriers: at d = 88
//   48 + 3 x 48 + 24 KB, at d = 128 64 + 2 x 64 + 32 KB, at d = 64
//   32 + 5 x 32 + 16 KB.
// - A query tile's rows past Sq cost a full tile for its consumer (wgmma's
//   M is 64), and every item costs a full pass of the split: at S = 257 a
//   head's third item has one row; the last key tile has one live key of
//   32.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "rowquant.cuh"

// HIREST_F32_TRACE=1 records clock64() at the pipeline's steps for block
// 0's first kTraceTiles key tiles into g_trace[tile][event], which
// hirest_attention_f32_trace copies out (chip_smoke.py --time-f32 reads
// it). Events: the producer's tile start (0), K and V loads issued (1,
// 2); the splitter's K landed (3), K split (4), V landed (5), V^T stage
// free (6), V^T split (7); consumer 0's waits begun and passed (8, 9),
// its turn taken (10), its products issued (11), scores done (12),
// softmax done (13), p split (14); its Q wait begun and passed (15, 16);
// an item's last PV done (17), its output written (18).
#ifndef HIREST_F32_TRACE
#define HIREST_F32_TRACE 0
#endif
#if HIREST_F32_TRACE
constexpr int kTraceTiles = 64, kTraceEvents = 19;
__device__ long long g_trace[kTraceTiles * kTraceEvents];
#define TRACE(tile, e)                                          \
  do {                                                          \
    if (blockIdx.x == 0 && (tile) < kTraceTiles)                \
      g_trace[(tile) * kTraceEvents + (e)] = clock64();         \
  } while (0)
#else
#define TRACE(tile, e) \
  do {                 \
  } while (0)
#endif

namespace {

constexpr int kKeys = 32;       // keys a K/V tile
constexpr int kBoxCols = 32;    // f32 columns a TMA box: one 128-byte row
constexpr int kQRows = 64;      // query rows a consumer warpgroup
constexpr int kConsumers = 2;
constexpr int kRows = kQRows * kConsumers;  // query rows an item
// two warpgroups whose first warp produces and whose other seven split,
// and the consumer warpgroups
constexpr int kThreads = 128 * (2 + kConsumers);
constexpr int kSplitWarps = 7;
constexpr int kSplitterRegs = 40;
constexpr int kConsumerRegs = 216;
// setmaxnreg moves registers within the block's allocation at launch,
// kThreads x the launch bound's 128 a thread
static_assert(256 * kSplitterRegs + 128 * kConsumers * kConsumerRegs <=
                  kThreads * (65536 / kThreads / 8 * 8),
              "the block's registers");
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may use
constexpr int kVRaw = 2;          // V landing buffers
constexpr int kBarBytes = 512;    // room for the mbarriers

template <int D>
struct Geo {
  static_assert(D % 8 == 0 && D <= 128, "head widths the body takes");
  static constexpr int kDp = (D + kBoxCols - 1) / kBoxCols * kBoxCols;
  static constexpr int kBoxes = kDp / kBoxCols;
  static constexpr int kSteps = kDp / 8;         // k8 steps of QK^T
  static constexpr int kQBox = kQRows * 128;     // bytes of a Q box
  static constexpr int kQTile = kBoxes * kQBox;  // a consumer's Q tile
  static constexpr int kKBox = kKeys * 128;
  static constexpr int kKTile = kBoxes * kKBox;   // a K or V tile of f32
  static constexpr int kVtTile = kDp * kKeys * 4;  // V^T hi or lo
  // K's hi and lo boxes interleaved (hi box 0, lo box 0, hi box 1, ...), so
  // that one n64 B operand holds a box's 32 keys' hi and lo rows; then V^T
  // hi and V^T lo
  static constexpr int kStage = 2 * kKTile + 2 * kVtTile;
  static constexpr int kStages =
      (kSmemMax - 1024 - kBarBytes - kConsumers * kQTile - kVRaw * kKTile) /
      kStage;
  static_assert(kStages >= 2, "a ring of two stages at least");
  static_assert(kBarBytes >= 8 * (5 * kStages + 2 * kVRaw + 2 * kConsumers),
                "room for the mbarriers");
  static constexpr size_t kSmem = 1024 + (size_t)kConsumers * kQTile +
                                  (size_t)kStages * kStage +
                                  (size_t)kVRaw * kKTile + kBarBytes;
  static constexpr int kAcc = kDp / 2;   // PV accumulators a thread
  static constexpr int kOTiles = D / 8;  // 8-column slices written out
  // Q's lo half in registers beside hi (d = 64), or in shared memory, read
  // by descriptor by the one product of three that takes it
  static constexpr bool kQloRegs = D <= 64;
};

struct Args {
  const int* mask;       // [B, Sk] or null
  const float* qbias;    // [H * D] or null
  const float* vbias;    // [H * D] or null
  float* o;
  unsigned int* rowmax;  // [B * Sq] for the int8 epilogue, or null
  long long o_st[3];     // o's (batch, head, row) element strides
  int B, H, Sq, Sk;
  int q_tiles, items;
  int heads_inner;  // bit i: map i (q, k, v) has H before S
  int o_pairs;      // o's column pairs are 8-byte aligned
  float scale;
};

// hi and lo halves of one value: hi = tf32(x), lo = tf32(x - hi).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// addr, opaque to the compiler: a descriptor built from it is built
// where it is used, not held in registers across the loop.
__device__ __forceinline__ uint32_t opaque(uint32_t addr) {
  asm volatile("" : "+r"(addr));
  return addr;
}

// One box of `map` (columns col..col+31 of rows row.. of head h, image b)
// into shared memory; heads_inner says whether the map's second dimension
// is the heads'.
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, bool heads_inner,
                                         int col, int row, int h, int b) {
  if (heads_inner)
    tma_load_4d(dst, map, bar, col, h, row, b);
  else
    tma_load_4d(dst, map, bar, col, row, h, b);
}

// Byte offset of element (row r, column c) in a tile of 32-column boxes
// `box` bytes apart, 128-byte rows, 128-byte swizzle.
__device__ __forceinline__ int swz(int r, int c, int box) {
  return (c / kBoxCols) * box + r * 128 + ((((c % kBoxCols) >> 2) ^ (r & 7))
                                           << 4) + (c & 3) * 4;
}

// PV over one 8-key step: o += p v.
template <int D>
__device__ __forceinline__ void pv_step(float (&o)[Geo<D>::kAcc],
                                        const uint32_t (&p)[4], uint32_t vt,
                                        int j) {
  const uint64_t db = smem_desc(vt + 32 * j);
  if constexpr (Geo<D>::kDp == 64)
    wgmma_tf32_n64(o, p, db, 1);
  else if constexpr (Geo<D>::kDp == 96)
    wgmma_tf32_n96(o, p, db, 1);
  else
    wgmma_tf32_n128(o, p, db, 1);
}

// kQuant: the int8 epilogue's first step; an instantiation of its own.
template <int D, bool kQuant>
__global__ void __launch_bounds__(kThreads, 1)
    attention_f32_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const Args a) {
  using G = Geo<D>;
  constexpr int NS = G::kStages;
  extern __shared__ uint8_t smem_raw[];
  // 1024-aligned, and derived from smem_raw by an offset, so that the
  // compiler keeps the shared space (LDS/STS, not generic loads)
  uint8_t* qbuf =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* stages = qbuf + kConsumers * G::kQTile;
  uint8_t* vraw = stages + NS * G::kStage;
  uint64_t* kfull = reinterpret_cast<uint64_t*>(vraw + kVRaw * G::kKTile);
  uint64_t* ksplit = kfull + NS;    // K hi and lo ready
  uint64_t* kempty = ksplit + NS;   // both consumers done with K
  uint64_t* vtfull = kempty + NS;   // V^T hi and lo ready
  uint64_t* vtempty = vtfull + NS;  // both consumers done with V^T
  uint64_t* vfull = vtempty + NS;   // a V tile landed
  uint64_t* vempty = vfull + kVRaw;  // the splitter done with it
  uint64_t* qfull = vempty + kVRaw;
  uint64_t* qempty = qfull + kConsumers;
  const int key_tiles = (a.Sk + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&ksplit[s], kSplitWarps);
      mbar_init(&kempty[s], 4 * kConsumers);
      mbar_init(&vtfull[s], kSplitWarps);
      mbar_init(&vtempty[s], 4 * kConsumers);
    }
    for (int v = 0; v < kVRaw; ++v) {
      mbar_init(&vfull[v], 1);
      mbar_init(&vempty[v], kSplitWarps);
    }
    for (int w = 0; w < kConsumers; ++w) {
      mbar_init(&qfull[w], 1);
      mbar_init(&qempty[w], 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  // one arrival a warp
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  if (wg < 2) setmaxnreg_dec<kSplitterRegs>();
  if (threadIdx.x < 32) {
    // producer: one thread loads every tile
    if (threadIdx.x == 0) {
      int tile = 0;
      int q_loads[kConsumers] = {};
      for (int it = blockIdx.x; it < a.items; it += gridDim.x) {
        const int qt = it % a.q_tiles, h = (it / a.q_tiles) % a.H,
                  b = it / (a.q_tiles * a.H);
#pragma unroll
        for (int w = 0; w < kConsumers; ++w) {
          const int row0 = qt * kRows + kQRows * w;
          if (row0 >= a.Sq) continue;  // no rows for consumer w
          if (q_loads[w] > 0) mbar_wait(&qempty[w], (q_loads[w] - 1) & 1);
          ++q_loads[w];
          mbar_expect_tx(&qfull[w], G::kQTile);
#pragma unroll
          for (int bx = 0; bx < G::kBoxes; ++bx)
            load_box(qbuf + w * G::kQTile + bx * G::kQBox, &qmap, &qfull[w],
                     a.heads_inner & 1, bx * kBoxCols, row0, h, b);
        }
        for (int kt = 0; kt < key_tiles; ++kt, ++tile) {
          const int s = tile % NS, v = tile % kVRaw, key0 = kt * kKeys;
          TRACE(tile, 0);
          if (tile >= NS) mbar_wait(&kempty[s], (tile / NS - 1) & 1);
          TRACE(tile, 1);
          mbar_expect_tx(&kfull[s], G::kKTile);
#pragma unroll
          for (int bx = 0; bx < G::kBoxes; ++bx)
            load_box(stages + s * G::kStage + 2 * bx * G::kKBox, &kmap,
                     &kfull[s], a.heads_inner & 2, bx * kBoxCols, key0, h, b);
          if (tile >= kVRaw) mbar_wait(&vempty[v], (tile / kVRaw - 1) & 1);
          TRACE(tile, 2);
          mbar_expect_tx(&vfull[v], G::kKTile);
#pragma unroll
          for (int bx = 0; bx < G::kBoxes; ++bx)
            load_box(vraw + v * G::kKTile + bx * G::kKBox, &vmap, &vfull[v],
                     a.heads_inner & 4, bx * kBoxCols, key0, h, b);
        }
      }
    }
  } else if (wg < 2) {
    // splitter warps sw = 0 .. 6: tf32 halves of every K and V tile
    const int sw = threadIdx.x / 32 - 1;
    const bool tr = sw == 0 && lane == 0;
    int tile = 0;
    for (int it = blockIdx.x; it < a.items; it += gridDim.x) {
      const int h = (it / a.q_tiles) % a.H;
      const float* vb = a.vbias ? a.vbias + h * D : nullptr;
      for (int kt = 0; kt < key_tiles; ++kt, ++tile) {
        const int s = tile % NS, v = tile % kVRaw;
        uint8_t* st = stages + s * G::kStage;
        // K: hi over each raw box, lo in the box after it, element by
        // element
        mbar_wait(&kfull[s], (tile / NS) & 1);
        if (tr) TRACE(tile, 3);
#pragma unroll 1
        for (int i = 32 * sw + lane;
             i < G::kKTile / 16;
             i += 32 * kSplitWarps) {
          uint4* kh = reinterpret_cast<uint4*>(
              st + (i / (G::kKBox / 16)) * 2 * G::kKBox +
              (i % (G::kKBox / 16)) * 16);
          const uint4 x = *kh;
          uint4 hi, lo;
          split_tf32(__uint_as_float(x.x), hi.x, lo.x);
          split_tf32(__uint_as_float(x.y), hi.y, lo.y);
          split_tf32(__uint_as_float(x.z), hi.z, lo.z);
          split_tf32(__uint_as_float(x.w), hi.w, lo.w);
          kh[0] = hi;
          kh[G::kKBox / 16] = lo;
        }
        fence_proxy_async();
        release(&ksplit[s]);
        if (tr) TRACE(tile, 4);

        // V^T: a warp's task (box, pc) writes position chunk pc (positions
        // 4 pc .. 4 pc + 3 = keys 8 (pc / 2) + pc % 2 + 2 m, m < 4) of rows
        // n = 32 box + lane
        mbar_wait(&vfull[v], (tile / kVRaw) & 1);
        if (tr) TRACE(tile, 5);
        if (tile >= NS) mbar_wait(&vtempty[s], (tile / NS - 1) & 1);
        if (tr) TRACE(tile, 6);
        const uint8_t* vr = vraw + v * G::kKTile;
        uint8_t* vth = st + 2 * G::kKTile;
        uint8_t* vtl = vth + G::kVtTile;
#pragma unroll 1
        for (int task = sw; task < G::kBoxes * 8; task += kSplitWarps) {
          const int box = task % G::kBoxes, pc = task / G::kBoxes;
          const int n = kBoxCols * box + lane;
          const int key0 = 8 * (pc >> 1) + (pc & 1);
          const float bias = (vb != nullptr && n < D) ? vb[n] : 0.f;
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const float x = *reinterpret_cast<const float*>(
                vr + swz(key0 + 2 * m, n, G::kKBox));
            split_tf32(x + bias, hi[m], lo[m]);
          }
          const int off = n * 128 + ((pc ^ (n & 7)) << 4);
          *reinterpret_cast<uint4*>(vth + off) =
              make_uint4(hi[0], hi[1], hi[2], hi[3]);
          *reinterpret_cast<uint4*>(vtl + off) =
              make_uint4(lo[0], lo[1], lo[2], lo[3]);
        }
        fence_proxy_async();
        release(&vtfull[s]);
        release(&vempty[v]);
        if (tr) TRACE(tile, 7);
      }
    }
  } else {
    // consumer cw: rows 64 cw .. 64 cw + 63 of each item's query tile
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 2;
    const int warp = threadIdx.x / 32 % 4;
    const int g = lane >> 2, t = lane & 3;
    uint8_t* qs = qbuf + cw * G::kQTile;
    int tile = 0, q_loads = 0;
    // the consumers take turns to issue their products (named barriers 3
    // and 4): one's softmax runs while the other's wgmmas do; consumer 0
    // goes first
    const int my_turn = 3 + cw, next_turn = 4 - cw;
    if (cw == 1) named_barrier_arrive(3, 256);

    for (int it = blockIdx.x; it < a.items; it += gridDim.x) {
      const int qt = it % a.q_tiles, h = (it / a.q_tiles) % a.H,
                b = it / (a.q_tiles * a.H);
      const int first_row = qt * kRows + kQRows * cw;
      if (first_row >= a.Sq) {
        // no rows of this item here: keep the turns and the stages' counts
        for (int kt = 0; kt < key_tiles; ++kt, ++tile) {
          const int s = tile % NS;
          mbar_wait(&ksplit[s], (tile / NS) & 1);
          named_barrier_sync(my_turn, 256);
          named_barrier_arrive(next_turn, 256);
          release(&kempty[s]);
          mbar_wait(&vtfull[s], (tile / NS) & 1);
          release(&vtempty[s]);
        }
        continue;
      }

      // Q's A fragments for k8 step j: rows 16 warp + g (+ 8), columns
      // 8 j + t (+ 4), the q bias added, split into tf32 halves
      const bool tr = cw == 0 && threadIdx.x % 128 == 0;
      if (tr) TRACE(tile, 15);
      mbar_wait(&qfull[cw], q_loads++ & 1);
      if (tr) TRACE(tile, 16);
      // (all loads before any store: the lo half goes back in place)
      const float* qb = a.qbias ? a.qbias + h * D : nullptr;
      uint32_t qh[G::kSteps][4], ql[G::kSteps][4];
#pragma unroll
      for (int j = 0; j < G::kSteps; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 16 * warp + g + 8 * (e & 1),
                    c = 8 * j + t + 4 * (e >> 1);
          float x = *reinterpret_cast<const float*>(qs + swz(r, c, G::kQBox));
          if (qb != nullptr && c < D) x += qb[c];
          split_tf32(x, qh[j][e], ql[j][e]);
        }
      }
      if constexpr (!G::kQloRegs) {
#pragma unroll
        for (int j = 0; j < G::kSteps; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 16 * warp + g + 8 * (e & 1),
                      c = 8 * j + t + 4 * (e >> 1);
            *reinterpret_cast<uint32_t*>(qs + swz(r, c, G::kQBox)) = ql[j][e];
          }
        }
      }
      if constexpr (G::kQloRegs) {
        release(&qempty[cw]);
      } else {
        fence_proxy_async();
        named_barrier_sync(1 + cw, 128);  // the whole lo tile written
      }

      // scores of the K tile in stage s: lo hi' into columns 0..31 of
      // sacc, then hi hi' and hi lo' as one n64 product against a box's hi
      // and lo rows (columns 0..31 and 32..63); sc their sum. The small
      // terms go first (the accumulators are zeroed for them).
      float sacc[32], sc[16];
      float(&sacc_hi)[16] = *reinterpret_cast<float(*)[16]>(sacc);
      auto issue_scores = [&](int s) {
        const uint32_t kh = opaque(smem_u32(stages)) + s * G::kStage;
        const uint32_t qa = opaque(smem_u32(qs));
#pragma unroll
        for (int j = 0; j < G::kSteps; ++j) {
          const uint64_t db =
              smem_desc(kh + (j / 4) * 2 * G::kKBox + (j % 4) * 32);
          if constexpr (G::kQloRegs)
            wgmma_tf32_n32(sacc_hi, ql[j], db, 1);
          else
            wgmma_tf32_n32_ss(
                sacc_hi, smem_desc(qa + (j / 4) * G::kQBox + (j % 4) * 32),
                db, 1);
        }
#pragma unroll
        for (int j = 0; j < G::kSteps; ++j)
          wgmma_tf32_n64(sacc, qh[j],
                         smem_desc(kh + (j / 4) * 2 * G::kKBox + (j % 4) * 32),
                         1);
      };
      auto zero_scores = [&]() {
#pragma unroll
        for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
      };
      auto sum_scores = [&]() {
#pragma unroll
        for (int i = 0; i < 16; ++i) sc[i] = sacc[i] + sacc[16 + i];
      };
      // o += p v for the V^T tiles in stage s, p's halves in ph and pl
      uint32_t ph[4][4], pl[4][4];
      float o[G::kAcc];
      auto issue_pv = [&](int s) {
        const uint32_t vth = opaque(smem_u32(stages)) + s * G::kStage +
                             2 * G::kKTile,
                       vtl = vth + G::kVtTile;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pv_step<D>(o, pl[j], vth, j);
          pv_step<D>(o, ph[j], vtl, j);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) pv_step<D>(o, ph[j], vth, j);
      };
      // tile kt's keys this thread's scores hold, 8 (q / 2) + 2 t + q % 2
      // for bit q: live (below Sk) and valid (live, and not masked)
      const int* mask = a.mask ? a.mask + (long long)b * a.Sk : nullptr;
      auto key_bits = [&](int kt, uint32_t& live, uint32_t& valid) {
        live = valid = 0;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int key = kt * kKeys + 8 * (q / 2) + 2 * t + (q & 1);
          const bool l = key < a.Sk;
          live |= (uint32_t)l << q;
          valid |= (uint32_t)(l && (mask == nullptr || mask[key] != 0)) << q;
        }
      };
      // the online softmax of sc: m, l updated, alpha (o's factor) out, p
      // as the tf32 A fragment of each 8-key step i, {row g key 2t, row
      // g + 8 key 2t, row g key 2t + 1, row g + 8 key 2t + 1}: columns t
      // and t + 4 under V^T's key order
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
      float al0 = 0.f, al1 = 0.f;
      const float scale = a.scale;
      auto softmax = [&](uint32_t live, uint32_t valid) {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int q = 2 * (i / 4) + (i & 1);
          const float x = __fmul_rn(sc[i], scale);
          const float y = (valid >> q) & 1 ? x : -1e30f;
          sc[i] = (live >> q) & 1 ? y : -INFINITY;
        }
        float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          t0 = fmaxf(t0, fmaxf(sc[4 * i], sc[4 * i + 1]));
          t1 = fmaxf(t1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, off));
          t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, off));
        }
        // finite: every tile has a live key
        const float n0 = fmaxf(m0, t0), n1 = fmaxf(m1, t1);
        al0 = expf(m0 - n0);  // 0 on the first tile
        al1 = expf(m1 - n1);
        m0 = n0;
        m1 = n1;
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sc[4 * i] = expf(sc[4 * i] - n0);
          sc[4 * i + 1] = expf(sc[4 * i + 1] - n0);
          sc[4 * i + 2] = expf(sc[4 * i + 2] - n1);
          sc[4 * i + 3] = expf(sc[4 * i + 3] - n1);
          ps0 += sc[4 * i] + sc[4 * i + 1];
          ps1 += sc[4 * i + 2] + sc[4 * i + 3];
        }
        l0 = l0 * al0 + ps0;
        l1 = l1 * al1 + ps1;
      };
      auto split_p = [&]() {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          split_tf32(sc[4 * i], ph[i][0], pl[i][0]);
          split_tf32(sc[4 * i + 2], ph[i][1], pl[i][1]);
          split_tf32(sc[4 * i + 1], ph[i][2], pl[i][2]);
          split_tf32(sc[4 * i + 3], ph[i][3], pl[i][3]);
        }
      };
      auto rescale = [&]() {
#pragma unroll
        for (int i = 0; i < G::kAcc / 4; ++i) {
          o[4 * i] *= al0;
          o[4 * i + 1] *= al0;
          o[4 * i + 2] *= al1;
          o[4 * i + 3] *= al1;
        }
      };
#pragma unroll
      for (int i = 0; i < G::kAcc; ++i) o[i] = 0.f;

      // Tile 0: scores and p. Then, in one turn, tile kt - 1's PV and tile
      // kt's scores (the PV done first, so that p's registers are free
      // while the scores accumulate); tile kt's softmax while the other
      // consumer's products run; the last tile's PV after the loop.
      uint32_t live, valid;
      key_bits(0, live, valid);
      int s = tile % NS;
      if (tr) TRACE(tile, 8);
      mbar_wait(&ksplit[s], (tile / NS) & 1);
      if (tr) TRACE(tile, 9);
      named_barrier_sync(my_turn, 256);
      if (tr) TRACE(tile, 10);
      zero_scores();
      wgmma_fence();
      issue_scores(s);
      wgmma_commit();
      named_barrier_arrive(next_turn, 256);
      wgmma_wait<0>();
      fence_regs(sacc);
      release(&kempty[s]);
      sum_scores();
      softmax(live, valid);
      split_p();
      if (tr) TRACE(tile, 14);
      for (int kt = 1; kt < key_tiles; ++kt) {
        const int prev = s;
        ++tile;
        s = tile % NS;
        key_bits(kt, live, valid);
        if (tr) TRACE(tile, 8);
        mbar_wait(&vtfull[prev], ((tile - 1) / NS) & 1);
        mbar_wait(&ksplit[s], (tile / NS) & 1);
        if (tr) TRACE(tile, 9);
        named_barrier_sync(my_turn, 256);
        if (tr) TRACE(tile, 10);
        rescale();
        zero_scores();
        wgmma_fence();
        issue_pv(prev);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        release(&vtempty[prev]);
        wgmma_fence();
        issue_scores(s);
        wgmma_commit();
        named_barrier_arrive(next_turn, 256);
        if (tr) TRACE(tile, 11);
        wgmma_wait<0>();
        fence_regs(sacc);
        if (tr) TRACE(tile, 12);
        release(&kempty[s]);
        sum_scores();
        softmax(live, valid);
        if (tr) TRACE(tile, 13);
        split_p();
        if (tr) TRACE(tile, 14);
      }
      if (!G::kQloRegs) release(&qempty[cw]);
      rescale();
      mbar_wait(&vtfull[s], (tile / NS) & 1);
      wgmma_fence();
      issue_pv(s);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      release(&vtempty[s]);
      if (tr) TRACE(tile, 17);

#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      // o / l as o times the correctly rounded 1 / l
      const float r0 = __frcp_rn(l0), r1 = __frcp_rn(l1);
      const int row0 = first_row + 16 * warp + g, row1 = row0 + 8;
      float* o0 = a.o + b * a.o_st[0] + h * a.o_st[1] + row0 * a.o_st[2] +
                  2 * t;
      float* o1 = o0 + 8 * a.o_st[2];
      if constexpr (kQuant) {
        float y[G::kOTiles][4];
#pragma unroll
        for (int i = 0; i < G::kOTiles; ++i) {
          y[i][0] = o[4 * i] * r0;
          y[i][1] = o[4 * i + 1] * r0;
          y[i][2] = o[4 * i + 2] * r1;
          y[i][3] = o[4 * i + 3] * r1;
        }
        unsigned int* mx = a.rowmax + (long long)b * a.Sq + row0;
        park_f32_tile<G::kOTiles>(y, o0, o1, row0 < a.Sq, row1 < a.Sq, mx,
                                  mx + 8, t);
      } else {
#pragma unroll
        for (int i = 0; i < G::kOTiles; ++i) {
          const float y0 = o[4 * i] * r0, y1 = o[4 * i + 1] * r0;
          const float y2 = o[4 * i + 2] * r1, y3 = o[4 * i + 3] * r1;
          if (a.o_pairs) {
            if (row0 < a.Sq)
              *reinterpret_cast<float2*>(o0 + 8 * i) = make_float2(y0, y1);
            if (row1 < a.Sq)
              *reinterpret_cast<float2*>(o1 + 8 * i) = make_float2(y2, y3);
          } else {
            if (row0 < a.Sq) {
              o0[8 * i] = y0;
              o0[8 * i + 1] = y1;
            }
            if (row1 < a.Sq) {
              o1[8 * i] = y2;
              o1[8 * i + 1] = y3;
            }
          }
        }
      }
      if (tr) TRACE(tile, 18);
      ++tile;
    }
  }
}

// An f32 [B, H, S, D] view (element strides st = (batch, head, row), unit
// stride along D) as a 4-d TMA map, S and H in the order of their strides,
// read in boxes of 32 columns by `rows` rows with 128-byte swizzle; rows
// past S and columns past D read as zeros. Sets *heads_inner when H comes
// first.
cudaError_t head_map(CUtensorMap* map, const float* base, int B, int H,
                     int S, int D, const long long* st, int rows,
                     bool* heads_inner) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorInitializationError;
  if (reinterpret_cast<uintptr_t>(base) % 16)
    return cudaErrorMisalignedAddress;
  for (int i = 0; i < 3; ++i)
    if (st[i] <= 0 || st[i] % 4) return cudaErrorInvalidValue;
  const bool hi = st[1] < st[2];
  *heads_inner = hi;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)(hi ? H : S),
                              (cuuint64_t)(hi ? S : H), (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(hi ? st[1] : st[2]) * 4,
                                 (cuuint64_t)(hi ? st[2] : st[1]) * 4,
                                 (cuuint64_t)st[0] * 4};
  const cuuint32_t box[4] = {(cuuint32_t)kBoxCols, hi ? 1u : (cuuint32_t)rows,
                             hi ? (cuuint32_t)rows : 1u, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
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

template <int D, bool kQuant>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const long long* st, Args a, cudaStream_t stream) {
  using G = Geo<D>;
  CUtensorMap maps[3];
  const float* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    bool hi = false;
    const cudaError_t err =
        head_map(&maps[i], bases[i], a.B, a.H, i == 0 ? a.Sq : a.Sk, D,
                 st + 3 * i, i == 0 ? kQRows : kKeys, &hi);
    if (err != cudaSuccess) return err;
    a.heads_inner |= (int)hi << i;
  }
  const auto kernel = attention_f32_kernel<D, kQuant>;
  // the shared-memory opt-in, once an instantiation
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kSmem);
  if (opt_in != cudaSuccess) return opt_in;
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  a.q_tiles = (a.Sq + kRows - 1) / kRows;
  const long long items = (long long)a.B * a.H * a.q_tiles;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  a.items = (int)items;
  // a block walks items grid apart; a grid that is not a multiple of the
  // query tiles a head gives each block a share of each tile (the last,
  // often short, ones too) while the tiles of a head still run together
  int grid = (int)(items < sms ? items : sms);
  if (a.q_tiles > 1 && grid > 1 && grid % a.q_tiles == 0) --grid;
  kernel<<<grid, kThreads, G::kSmem, stream>>>(maps[0], maps[1], maps[2], a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_width(const float* q, const float* k, const float* v,
                         const long long* st, const Args& a,
                         cudaStream_t stream) {
  return a.rowmax ? launch<D, true>(q, k, v, st, a, stream)
                  : launch<D, false>(q, k, v, st, a, stream);
}

int launch_f32(const void* q, const void* k, const void* v, const void* mask,
               const void* qbias, const void* vbias, void* o, int B, int H,
               int Sq, int Sk, int D, const long long* strides, float scale,
               cudaStream_t st, Args a) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  a.mask = static_cast<const int*>(mask);
  a.qbias = static_cast<const float*>(qbias);
  a.vbias = static_cast<const float*>(vbias);
  a.o = static_cast<float*>(o);
  a.B = B;
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.scale = scale;
  for (int i = 0; i < 3; ++i) a.o_st[i] = strides[9 + i];
  a.o_pairs = reinterpret_cast<uintptr_t>(o) % 8 == 0 && a.o_st[0] % 2 == 0 &&
              a.o_st[1] % 2 == 0 && a.o_st[2] % 2 == 0;
  const float *fq = static_cast<const float*>(q),
              *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v);
  switch (D) {
    case 64: return (int)launch_width<64>(fq, fk, fv, strides, a, st);
    case 88: return (int)launch_width<88>(fq, fk, fv, strides, a, st);
    case 128: return (int)launch_width<128>(fq, fk, fv, strides, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, H, Sq, D], k and v [B, H, Sk, D], o [B, H, Sq, D]: f32 views with
// unit stride along D; `strides` holds the (batch, head, row) element
// strides of q, k, v and o, in that order: those of q, k and v positive
// multiples of 4, and q, k and v 16-byte aligned (the TMA maps'). mask is
// null or int32 [B, Sk] (nonzero marks a valid key); qbias and vbias are
// each null or f32 [H * D], added to q and v. D = 64, 88 or 128; any Sq
// and Sk. Launches on `stream` and returns cudaGetLastError().
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

#if HIREST_F32_TRACE
// The trace of the last launch: kTraceTiles x kTraceEvents clock64()
// readings into dst.
extern "C" int hirest_attention_f32_trace(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));
}
#endif

extern "C" const char* hirest_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
