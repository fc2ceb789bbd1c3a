// K6, K7 and K8: softmax attention over split-heads or packed-heads bf16
// tensors, with bf16 output, or with an int8 row-quantization epilogue.
//
// Replaces hirest_tpu/ops/attention.py::_pallas_attention (K6, kernel
// bodies _attn_kernel and _attn_kernel_masked), _pallas_attention_packed
// (K7, bodies _attn_kernel_packed and _attn_kernel_packed_masked) and
// fused_attention_qkv (K8, v1, bodies _attn_kernel_qkvfused and
// _attn_kernel_qkvfused_quant). All three compute, for each (b, h), over
// keys j < Sk with valid(j) = (no mask, or mask[b, j] != 0):
//   q   = bf16(q + q_bias),  v = bf16(v + v_bias)    K8 only: bf16 adds
//   s   = (q k^T in f32) * scale;   s[:, j] = -1e30 where !valid(j)
//   m   = rowmax(s),   l = sum_j exp(s - m)          f32
//   p   = bf16(exp(s - m) / l)                       normalised, then rounded
//   o   = p v accumulated in f32
// and write bf16(o), or (K8's quant_out) quantize each token's whole H*D
// row of f32 o: sc = max(max|o| / 127, 1e-8), q = clamp(rint(o / sc), +-127).
// The kernel takes element strides of [B, H, S, D] views of q, k, v and o,
// so K6's split-heads views of one qkv projection, K7's packed [B, S, H*D]
// tensors and K8's q, k and v thirds of one fused [B, S, 3*H*D] projection
// are the same launch, and none needs a copy.
//
// Bound on an H100 SXM: K6 on the unrolled EVA-g tower, [128, 16, 257, 88]:
// q, k and v read and o written, 4 x 92.6 MB = 370.5 MB, 111 us at
// 3.35 TB/s, against 48 us for 47.6 GFLOP of QK^T and PV at 989 TFLOP/s.
// K8 moves the same bytes (its biases are 5.6 KB); with quant_out it writes
// 46.3 MB of codes and 0.13 MB of scales instead of o: 324.3 MB, 97 us.
// K7 on the padded tower, [128, 257, 16 * 128]: 4 x 134.7 MB = 539 MB,
// 161 us, against 70 us for 69.3 GFLOP. All are bound by memory.
//
// One body, attention_split_stream_kernel<D, kMask, kBias, kQuant>, in
// three instantiations a width: K6/K7 (kMask either way), K8 with bf16 out
// (kBias) and K8 with the int8 epilogue (kBias, kQuant). The options are
// template parameters: as runtime branches, a bias branch cost K6 8 % and
// K7 12 % (PERF.md).
//
// p is normalised in f32 before it is rounded to bf16, so the row sum is
// needed before the PV product. Pass 1 folds the scores into a running
// (max, sum of exp) per lane and merges the four lanes of a row at the end;
// pass 2 recomputes the scores, forms p and feeds it from registers into
// PV on mma.sync m16n8k16 (the score tiles' C layout is PV's A layout). The
// online sum differs from the reference's sum against the final max by a
// few f32 roundings, as another summation order would. The product
// s * scale is rounded on its own (__fmul_rn), as the reference rounds it,
// and never contracted into an FMA; q fragments go from device memory
// straight into registers.
//
// Design:
// - A block takes a group of a head's 16-row query tiles, one tile a warp:
//   the ceil(Sq/16) tiles are cut into ceil(tiles/6) nearly equal groups
//   (Sq=257: 6, 6 and 5). The groups of one (b, h) are adjacent in
//   blockIdx, so K and V come from L2 after the first group reads them.
// - K and V are never staged whole. 64-key tiles, row-major with row stride
//   kKStride (d padded to 16, plus 8: conflict-free ldmatrix rows), go
//   through a 3-stage cp.async.cg ring, 16 bytes a thread, zero-filled past
//   Sk; pass 1 streams K, pass 2 K and V (and the key mask, 4 bytes a key),
//   so the next tile's loads overlap this tile's mma.sync. Shared memory is
//   a constant 105,216 bytes at d=128 (80,640 at d=88): two 6-warp blocks
//   an SM at d=128, and no bound on Sk.
// - K's B fragments come by ldmatrix.x4 and V's by ldmatrix.x4.trans from
//   the row-major tiles: no transposed store.
// - A tile with all its 64 keys below Sk takes a path without bound
//   checks, its loops unrolled whole; only the last tile checks its keys.
// - Softmax: pass 1 takes a key tile's row max first, rescales the running
//   sum once per tile, then adds e = 2^((s - m) log2e) from ex2.approx.ftz:
//   one SFU op a score, no branch a score, and none of exp2f's fix-ups for
//   results below 2^-126. Without a mask the argument is one FFMA,
//   s log2e - m log2e (m log2e rounded once a row): within ~|m| 2^-24 of
//   (s - m) log2e, and the same in both passes, so p stays normalised to
//   the sum it is divided by. Pass 2 forms p = bf16(e * r), r = 1/l rounded
//   once a row (__frcp_rn): before the bf16 rounding it is within one f32
//   ulp of e / l. (HIREST_SPLIT_ARITH builds expf, exp2f or __fdiv_rn in
//   their place, to time them: PERF.md.)
// - Masked keys score -1e30, keys past Sk -inf (left out): a row whose keys
//   are all masked gets the reference's uniform p.
// - K8's biases are added as the operands arrive, rounded to bf16 as the
//   reference adds them (add_bf16x2: the f32 sum, one rounding): q's to the
//   fragments as they are loaded, v's in shared memory, to each 16-byte V
//   chunk of a landed stage by the thread that copied it, before the ring's
//   __syncthreads publishes the stage (no second barrier). So the biased q
//   and v never exist in device memory.
// - K8's int8 epilogue is K3's (rowquant.cuh): each warp parks its f32
//   query tile of its head in an [B*Sq, H*D] workspace and folds the rows'
//   max |o| into a row maximum with atomicMax; a second kernel quantizes
//   the rows. The workspace costs 370 MB of traffic more than the bound
//   counts: a row's 16 heads are 16 blocks, and their row maximum needs the
//   workspace until they share it on chip.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "rowquant.cuh"

namespace {

struct Strides {  // element strides (batch, head, row) of the [B, H, S, D] views
  long long q[3], k[3], v[3], o[3];
};

struct Args {
  const __nv_bfloat16 *q, *k, *v;
  const int* mask;                    // null, or [B, Sk]: nonzero marks a valid key
  const __nv_bfloat16 *qbias, *vbias;  // null, or [H * D] each (K8)
  __nv_bfloat16* o;                   // bf16 output (through its strides)
  float* ws;                          // or quant_out: the f32 workspace [B * Sq, H * D]
  unsigned int* rowmax;               // and its row maxima [B * Sq]
  int B, H, Sq, Sk;
  Strides st;
  float scale;
};

// Timing variants of the softmax arithmetic (chip_smoke.py
// --time-attention): bit 0 takes expf, bit 2 exp2f, for ex2.approx.ftz;
// bit 1 takes __fdiv_rn for the reciprocal multiply.
#ifndef HIREST_SPLIT_ARITH
#define HIREST_SPLIT_ARITH 0
#endif
constexpr bool kExpf = HIREST_SPLIT_ARITH & 1;
constexpr bool kFdiv = HIREST_SPLIT_ARITH & 2;
constexpr bool kExp2f = HIREST_SPLIT_ARITH & 4;

constexpr int kKeyTile = 64;      // keys a ring stage holds
constexpr int kStages = 3;        // ring depth
constexpr int kGroupWarps = 6;    // query tiles (warps) a block takes at most
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Ring {
  static constexpr int kTileElems = kKeyTile * Tile<D>::kKStride;
  // one stage: a K tile, a V tile and the tile's key mask
  static constexpr size_t kStageBytes =
      2 * kTileElems * sizeof(__nv_bfloat16) + kKeyTile * sizeof(int);
  static constexpr size_t kBytes = kStages * kStageBytes;
  static_assert(kStageBytes % 16 == 0, "stages must stay 16-byte aligned");
};

// exp(x - m) as the kernel takes it: 2^((x - m) log2e), or exp2f or expf,
// to time.
__device__ __forceinline__ float exp_shift(float x, float m) {
  if constexpr (kExpf) return expf(x - m);
  if constexpr (kExp2f) return exp2f((x - m) * kLog2e);
  return ex2_ftz((x - m) * kLog2e);
}

// exp(x - m) given ml = m log2e rounded: 2^(x log2e - ml), its argument one
// FFMA, where no key is masked. A masked launch keeps exp_shift, since a row
// whose keys are all masked has x = m = -1e30, where x log2e - ml is not 0.
template <bool kMask>
__device__ __forceinline__ float exp_scaled(float x, float m, float ml) {
  if constexpr (kMask || kExpf || kExp2f) return exp_shift(x, m);
  return ex2_ftz(fmaf(x, kLog2e, -ml));
}

// p before its bf16 rounding: e * r with r = 1 / l, or e / l.
__device__ __forceinline__ float normalise(float e, float r, float l) {
  if constexpr (kFdiv) return __fdiv_rn(e, l);
  return e * r;
}

// Scale one 16x8 score tile (the lane's keys `key` and `key` + 1 of the
// stage, whose mask is ms) as the reference does: masked keys -1e30, and
// with `edge`, keys at or past n (the keys left in the head from the
// stage's first) -inf.
template <bool kMask>
__device__ __forceinline__ void scale_tile(float (&s)[4], float scale,
                                           const int* ms, int key, int n,
                                           bool edge) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = key + (i & 1);
    float x = __fmul_rn(s[i], scale);
    if (kMask && ms[j] == 0) x = -1e30f;
    if (edge && j >= n) x = -INFINITY;
    s[i] = x;
  }
}

// Merge the (max, sum) pairs of the four lanes that hold one row.
__device__ __forceinline__ void merge_quad_exp2(float& m, float& l) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float lo = __shfl_xor_sync(0xffffffffu, l, off);
    const float mn = fmaxf(m, mo);
    if (mn != -INFINITY) {
      l = l * exp_shift(m, mn) + lo * exp_shift(mo, mn);
      m = mn;
    }
  }
}

// Fold one row's scores of a key tile into its running (max m, sum l): the
// tile's max first, the sum rescaled once, then one exp a score.
template <int kN, bool kMask>
__device__ __forceinline__ void fold_tile(float& m, float& l,
                                          const float (&s)[kN][4], int nn,
                                          int half) {
  float t = -INFINITY;
#pragma unroll
  for (int j = 0; j < kN; ++j)
    if (j < nn) t = fmaxf(t, fmaxf(s[j][2 * half], s[j][2 * half + 1]));
  if (t > m) {
    l *= exp_shift(m, t);  // 0 while m is still -inf
    m = t;
  }
  if (m == -INFINITY) return;  // no key of this lane's yet
  const float ml = m * kLog2e;
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kN; ++j)
    if (j < nn)
      sum += exp_scaled<kMask>(s[j][2 * half], m, ml) +
             exp_scaled<kMask>(s[j][2 * half + 1], m, ml);
  l += sum;
}

// Pass 1 on one key tile of the ring (n keys left in the head from its
// first; kFull: n >= kKeyTile, so no key needs a bound check).
template <int D, bool kMask, bool kFull>
__device__ __forceinline__ void max_sum_tile(
    float& m0, float& l0, float& m1, float& l1,
    const uint32_t (&qa)[Tile<D>::kChunks][4], const __nv_bfloat16* ks,
    const int* ms, int n, float scale, int lane) {
  constexpr int kN = kKeyTile / 8;  // 8-key score tiles a stage
  const int nn = kFull ? kN : min(kN, (n + 7) / 8);
  float s[kN][4];
#pragma unroll
  for (int j = 0; j < kN; ++j)
    if (j < nn) {
      qk_tile_ldm<D>(s[j], qa, ks, j, lane);
      scale_tile<kMask>(s[j], scale, ms, j * 8 + 2 * (lane & 3), n, !kFull);
    }
  fold_tile<kN, kMask>(m0, l0, s, nn, 0);
  fold_tile<kN, kMask>(m1, l1, s, nn, 1);
}

// Pass 2 on one key tile: p = bf16(exp(s - m) * r), acc += p v.
template <int D, bool kMask, bool kFull>
__device__ __forceinline__ void pv_tile(
    float (&acc)[Tile<D>::kOTiles][4],
    const uint32_t (&qa)[Tile<D>::kChunks][4], const __nv_bfloat16* ks,
    const __nv_bfloat16* vs, const int* ms, int n, float scale, float m0,
    float r0, float l0, float m1, float r1, float l1, int lane) {
  using T = Tile<D>;
  const int t = lane & 3;
  const int nk = kFull ? kKeyTile / 16 : min(kKeyTile / 16, (n + 15) / 16);
  const float ml0 = m0 * kLog2e, ml1 = m1 * kLog2e;
  // ldmatrix rows of V: keys (lane & 7) + 8 ((lane >> 3) & 1) of a 16-key
  // step, d-tile dt + (lane >> 4)
  const __nv_bfloat16* vlane =
      vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * T::kKStride +
      (lane >> 4) * 8;
#pragma unroll
  for (int kb = 0; kb < kKeyTile / 16; ++kb) {
    if (kb >= nk) break;
    float sa[4], sb[4];
    qk_tile_ldm<D>(sa, qa, ks, 2 * kb, lane);
    qk_tile_ldm<D>(sb, qa, ks, 2 * kb + 1, lane);
    scale_tile<kMask>(sa, scale, ms, kb * 16 + 2 * t, n, !kFull);
    scale_tile<kMask>(sb, scale, ms, kb * 16 + 8 + 2 * t, n, !kFull);
    // The score tiles' C layout is the A layout of the PV product.
    const uint32_t pa[4] = {
        pack_f32_bf16(normalise(exp_scaled<kMask>(sa[0], m0, ml0), r0, l0),
                      normalise(exp_scaled<kMask>(sa[1], m0, ml0), r0, l0)),
        pack_f32_bf16(normalise(exp_scaled<kMask>(sa[2], m1, ml1), r1, l1),
                      normalise(exp_scaled<kMask>(sa[3], m1, ml1), r1, l1)),
        pack_f32_bf16(normalise(exp_scaled<kMask>(sb[0], m0, ml0), r0, l0),
                      normalise(exp_scaled<kMask>(sb[1], m0, ml0), r0, l0)),
        pack_f32_bf16(normalise(exp_scaled<kMask>(sb[2], m1, ml1), r1, l1),
                      normalise(exp_scaled<kMask>(sb[3], m1, ml1), r1, l1))};
    const __nv_bfloat16* vrow = vlane + kb * 16 * T::kKStride;
#pragma unroll
    for (int dt = 0; dt + 1 < T::kOTiles; dt += 2) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vrow + dt * 8);
      mma_bf16(acc[dt], pa, vb[0], vb[1]);
      mma_bf16(acc[dt + 1], pa, vb[2], vb[3]);
    }
    if constexpr (T::kOTiles % 2) {  // d = 88: the eleventh d-tile
      uint32_t vb[2];
      ldmatrix_x2_trans(vb, vrow + (T::kOTiles - 1) * 8);
      mma_bf16(acc[T::kOTiles - 1], pa, vb[0], vb[1]);
    }
  }
}

// kMask: K6/K7's key mask. kBias: K8's q/v biases. kQuant: K8's int8
// epilogue into a.ws and a.rowmax, for bf16 o.
template <int D, bool kMask, bool kBias, bool kQuant>
__global__ void __launch_bounds__(kGroupWarps * 32, 2)
    attention_split_stream_kernel(const Args a, int groups, int group_tiles) {
  static_assert(!(kMask && kBias), "K8 takes no key mask");
  using T = Tile<D>;
  using R = Ring<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Sq = a.Sq, Sk = a.Sk;
  const Strides& st = a.st;
  const int bh = blockIdx.x / groups, grp = blockIdx.x % groups;
  const int b = bh / a.H, h = bh % a.H;
  const __nv_bfloat16* qg = a.q + b * st.q[0] + h * st.q[1];
  const __nv_bfloat16* kg = a.k + b * st.k[0] + h * st.k[1];
  const __nv_bfloat16* vg = a.v + b * st.v[0] + h * st.v[1];
  const int* mg = kMask ? a.mask + (size_t)b * Sk : nullptr;
  const __nv_bfloat16* qb = kBias ? a.qbias + h * D : nullptr;
  const __nv_bfloat16* vb = kBias ? a.vbias + h * D : nullptr;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int qt = grp * group_tiles + warp;  // this warp's query tile
  const bool active = qt * 16 < Sq;  // the last group may be short
  const int key_tiles = (Sk + kKeyTile - 1) / kKeyTile;
  const int steps = 2 * key_tiles;  // pass 1: K tiles; pass 2: K and V
  const float scale = a.scale;

  auto k_tile = [&](int i) {
    return reinterpret_cast<__nv_bfloat16*>(smem_raw +
                                            (i % kStages) * R::kStageBytes);
  };
  // d's zero padding of the K tiles, read by QK^T's last d-chunk (q is
  // zero there, and uninitialised shared memory could hold a NaN)
  if constexpr (T::kDPad > D) {
    constexpr int kPad = T::kDPad - D;
    for (int i = tid; i < kStages * kKeyTile * kPad; i += nthreads) {
      const int r = i / kPad;
      k_tile(r / kKeyTile)[(r % kKeyTile) * T::kKStride + D + i % kPad] =
          __float2bfloat16(0.f);
    }
  }
  // Step i's loads into stage i % kStages, as one commit group.
  auto load_step = [&](int i) {
    if (i < steps) {
      const bool pass2 = i >= key_tiles;
      const int key0 = (pass2 ? i - key_tiles : i) * kKeyTile;
      __nv_bfloat16* ks = k_tile(i);
      load_rows_async<D, kKeyTile>(ks, kg, st.k[2], key0, Sk, tid, nthreads);
      if (pass2)
        load_rows_async<D, kKeyTile>(ks + R::kTileElems, vg, st.v[2], key0,
                                     Sk, tid, nthreads);
      if (kMask)
        for (int j = tid; j < kKeyTile; j += nthreads)
          cp_async4(reinterpret_cast<int*>(ks + 2 * R::kTileElems) + j,
                    mg + (key0 + j < Sk ? key0 + j : 0), key0 + j < Sk);
    }
    cp_async_commit();
  };

  uint32_t qa[T::kChunks][4];
  if (active) load_q<D>(qa, qg, st.q[2], qt * 16 + g, Sq, t, qb);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) load_step(i);

  // Pass 1: running row max and sum of exp over the keys that exist.
  float m0 = -INFINITY, l0 = 0.f, m1 = -INFINITY, l1 = 0.f;
  for (int i = 0; i < key_tiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step i landed for all; step i - 1's stage is free
    load_step(i + kStages - 1);
    if (!active) continue;
    const int n = Sk - i * kKeyTile;
    const __nv_bfloat16* ks = k_tile(i);
    const int* ms = reinterpret_cast<const int*>(ks + 2 * R::kTileElems);
    if (n >= kKeyTile)
      max_sum_tile<D, kMask, true>(m0, l0, m1, l1, qa, ks, ms, n, scale,
                                   lane);
    else
      max_sum_tile<D, kMask, false>(m0, l0, m1, l1, qa, ks, ms, n, scale,
                                    lane);
  }
  merge_quad_exp2(m0, l0);
  merge_quad_exp2(m1, l1);
  const float r0 = __frcp_rn(l0), r1 = __frcp_rn(l1);

  // Pass 2: p = bf16(exp(s - m) * r), o += p v.
  float acc[T::kOTiles][4];
#pragma unroll
  for (int dt = 0; dt < T::kOTiles; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  for (int i = key_tiles; i < steps; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of step i landed
    const int key0 = (i - key_tiles) * kKeyTile;
    __nv_bfloat16* ks = k_tile(i);
    __nv_bfloat16* vs = ks + R::kTileElems;
    if constexpr (kBias)  // on the V chunks this thread copied
      add_bias_rows<D, kKeyTile>(vs, vb, key0, Sk, tid, nthreads);
    __syncthreads();
    load_step(i + kStages - 1);
    if (!active) continue;
    const int n = Sk - key0;
    const int* ms = reinterpret_cast<const int*>(vs + R::kTileElems);
    if (n >= kKeyTile)
      pv_tile<D, kMask, true>(acc, qa, ks, vs, ms, n, scale, m0, r0, l0, m1,
                              r1, l1, lane);
    else
      pv_tile<D, kMask, false>(acc, qa, ks, vs, ms, n, scale, m0, r0, l0, m1,
                               r1, l1, lane);
  }
  cp_async_wait<0>();
  if (!active) return;

  const int r0w = qt * 16 + g, r1w = r0w + 8;
  if constexpr (kQuant) {
    const size_t hd = (size_t)a.H * D;
    float* w0 = a.ws + ((size_t)b * Sq + r0w) * hd + h * D + 2 * t;
    unsigned int* mx = a.rowmax + (size_t)b * Sq + r0w;
    park_f32_tile<T::kOTiles>(acc, w0, w0 + 8 * hd, r0w < Sq, r1w < Sq, mx,
                              mx + 8, t);
  } else {
    __nv_bfloat16* og = a.o + b * st.o[0] + h * st.o[1];
    __nv_bfloat16* o0 = og + r0w * st.o[2] + 2 * t;
    __nv_bfloat16* o1 = og + r1w * st.o[2] + 2 * t;
#pragma unroll
    for (int dt = 0; dt < T::kOTiles; ++dt) {
      if (r0w < Sq)
        *reinterpret_cast<uint32_t*>(o0 + dt * 8) =
            pack_f32_bf16(acc[dt][0], acc[dt][1]);
      if (r1w < Sq)
        *reinterpret_cast<uint32_t*>(o1 + dt * 8) =
            pack_f32_bf16(acc[dt][2], acc[dt][3]);
    }
  }
}

// Query tiles per block: ceil(tiles / kGroupWarps) groups, nearly equal.
void stream_groups(int Sq, int* groups, int* group_tiles) {
  const int tiles = (Sq + 15) / 16;
  *groups = (tiles + kGroupWarps - 1) / kGroupWarps;
  *group_tiles = (tiles + *groups - 1) / *groups;
}

// One instantiation and its dynamic shared memory.
struct Variant {
  void (*kernel)(const Args, int, int);
  int smem;
};

// The instantiation a launch takes: K6/K7 with or without their key mask
// (no biases), or K8 (biases, no mask) with bf16 or int8 out.
template <int D>
Variant variant(bool mask, bool bias, bool quant) {
  return {bias ? (quant ? attention_split_stream_kernel<D, false, true, true>
                        : attention_split_stream_kernel<D, false, true, false>)
               : (mask ? attention_split_stream_kernel<D, true, false, false>
                       : attention_split_stream_kernel<D, false, false, false>),
          (int)Ring<D>::kBytes};
}

// The same at a runtime head width; a null kernel for an unbuilt width.
Variant variant_width(int D, bool mask, bool bias, bool quant) {
  switch (D) {
    case 64:
      return variant<64>(mask, bias, quant);
    case 88:
      return variant<88>(mask, bias, quant);
    case 128:
      return variant<128>(mask, bias, quant);
    default:
      return {nullptr, 0};
  }
}

// Launch v over a's heads on `stream`.
cudaError_t launch_stream(const Variant& v, const Args& a,
                          cudaStream_t stream) {
  if (v.kernel == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      v.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, v.smem);
  if (err != cudaSuccess) return err;
  int groups, group_tiles;
  stream_groups(a.Sq, &groups, &group_tiles);
  const long long blocks = (long long)a.B * a.H * groups;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto kernel = v.kernel;
  kernel<<<(unsigned)blocks, group_tiles * 32, v.smem, stream>>>(a, groups,
                                                                 group_tiles);
  return cudaGetLastError();
}

// The arguments both entry points share; strides holds the (batch, head,
// row) element strides of q, k, v and (bf16 output only) o, in that order.
Args make_args(const void* q, const void* k, const void* v, const void* mask,
               const void* qbias, const void* vbias, int B, int H, int Sq,
               int Sk, const long long* strides, int n_strides, float scale) {
  Args a = {};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.mask = static_cast<const int*>(mask);
  a.qbias = static_cast<const __nv_bfloat16*>(qbias);
  a.vbias = static_cast<const __nv_bfloat16*>(vbias);
  a.B = B;
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.scale = scale;
  long long* all[4] = {a.st.q, a.st.k, a.st.v, a.st.o};
  for (int i = 0; i < n_strides; ++i) all[i / 3][i % 3] = strides[i];
  return a;
}

}  // namespace

// q [B, H, Sq, D], k and v [B, H, Sk, D], o [B, H, Sq, D]: bf16 views with
// unit stride along D and 16-byte aligned rows; `strides` holds the
// (batch, head, row) element strides of q, k, v and o in that order. mask is
// null or int32 [B, Sk] (nonzero marks a valid key). qbias and vbias are
// both null, or both bf16 [H * D], 16-byte aligned, added to q and v (K8,
// which takes no mask). D = 64, 88 or 128; any Sq and Sk. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int hirest_attention_split(const void* q, const void* k,
                                      const void* v, const void* mask,
                                      const void* qbias, const void* vbias,
                                      void* o, int B, int H, int Sq, int Sk,
                                      int D, const long long* strides,
                                      float scale, void* stream) {
  const bool bias = qbias != nullptr;
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || bias != (vbias != nullptr) ||
      (bias && mask != nullptr))
    return (int)cudaErrorInvalidValue;
  Args a = make_args(q, k, v, mask, qbias, vbias, B, H, Sq, Sk, strides, 12,
                     scale);
  a.o = static_cast<__nv_bfloat16*>(o);
  return (int)launch_stream(variant_width(D, mask != nullptr, bias, false), a,
                            (cudaStream_t)stream);
}

// The launch of one instantiation at Sq queries and head width D, unmasked:
// K6/K7 (bias 0), K8 (bias 1, quant 0) or K8's int8 epilogue (bias 1,
// quant 1). Threads a block, dynamic shared memory a block, and blocks
// resident on one SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int hirest_attention_split_occupancy(int D, int Sq, int bias,
                                                int quant, int* blocks_per_sm,
                                                int* threads, int* smem) {
  const Variant v = variant_width(D, false, bias, quant);
  if (Sq <= 0 || v.kernel == nullptr || (quant && !bias))
    return (int)cudaErrorInvalidValue;
  int groups, group_tiles;
  stream_groups(Sq, &groups, &group_tiles);
  *threads = group_tiles * 32;
  *smem = v.smem;
  cudaError_t err = cudaFuncSetAttribute(
      v.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, v.smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, v.kernel, *threads, v.smem);
}

// K8 with the int8 epilogue instead of o (quant_out), so the biases are
// required and there is no mask: codes [B, Sq, H*D] int8 and scales
// [B, Sq] f32 out; ws [B, Sq, H*D] f32 and rowmax [B, Sq] (4 bytes each)
// are scratch. `strides` holds q's, k's and v's only. Zeroes rowmax and
// launches both steps on `stream`.
extern "C" int hirest_attention_split_quant(
    const void* q, const void* k, const void* v, const void* qbias,
    const void* vbias, void* ws, void* rowmax, void* codes, void* scales,
    int B, int H, int Sq, int Sk, int D, const long long* strides, float scale,
    void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || (H * D) % 4 ||
      qbias == nullptr || vbias == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  Args a = make_args(q, k, v, nullptr, qbias, vbias, B, H, Sq, Sk, strides, 9,
                     scale);
  a.ws = static_cast<float*>(ws);
  a.rowmax = static_cast<unsigned int*>(rowmax);
  const int rows = B * Sq;
  cudaError_t err = cudaMemsetAsync(rowmax, 0, sizeof(unsigned int) * rows, st);
  if (err != cudaSuccess) return (int)err;
  err = launch_stream(variant_width(D, false, true, true), a, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_quant_rows(a.ws, a.rowmax, codes, scales, rows, H * D, st);
}

extern "C" const char* hirest_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
