// Hopper pieces shared by the kernels built on TMA and wgmma
// (fused_mlp_int8.cu, attention_qkv3.cu, attention_f32.cu, int8_gemm.cu)
// and by the row ring (rowring.cuh): mbarriers, TMA tile loads (also
// multicast to a cluster) and stores with their bulk groups, 1-d bulk
// copies, the tensor-map encoder, clusters and their distributed shared
// memory, setmaxnreg, wgmma's fence / commit / wait,
// shared-memory matrix descriptors, the bf16 wgmma products of the
// attention kernel, and the tf32 ones of the f32 body with its tf32
// rounding, proxy fence and named barrier (attention_tiles.cuh takes its
// smem_u32 too). sm_90a only.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

// --- shared memory, mbarriers, TMA ---------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// One box of a 2-d tensor map (x along the contiguous axis, y along rows)
// into shared memory; completes the box's bytes on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_u32(bar))
      : "memory");
}

// The same box written into the shared memory of every block of the
// cluster named in `mask` (bit r: rank r), at the same offset as dst, each
// copy completing its bytes on that block's barrier at bar's offset.
__device__ __forceinline__ void tma_load_multicast(void* dst,
                                                   const CUtensorMap* map,
                                                   uint64_t* bar, int x, int y,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

// One box of shared memory out to a 2-d tensor map at (x, y), in the
// issuing thread's bulk group; the map clips what lies past its bounds.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(x), "r"(y)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most kPending of this thread's bulk groups still read
// their shared memory (the source may then be written again).
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending)
               : "memory");
}

// Waits until at most kPending of this thread's bulk groups are in flight.
template <int kPending>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// An L2 policy that evicts the lines it covers first: for data read once.
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// One contiguous run of `bytes` from global to shared memory, no tensor map
// (a 1-d bulk copy) under the L2 policy `policy`: bytes a multiple of 16,
// both addresses 16-byte aligned; completes its bytes on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar)),
      "l"(policy)
      : "memory");
}

// The same for a 4-d tensor map, coordinates innermost first.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// --- clusters ------------------------------------------------------------
//
// Blocks of one cluster (fused_mlp_int8.cu's K4a, attention_qkv3.cu's K3
// epilogue) reach each other's shared memory through mapa addresses.

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of *p in the shared memory of the cluster's block `rank`.
__device__ __forceinline__ uint32_t cluster_addr(const void* p,
                                                 uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  return remote;
}

// *p in the shared memory of the cluster's block `rank` = v.
__device__ __forceinline__ void st_cluster(float* p, uint32_t rank, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(
                   cluster_addr(p, rank)),
               "f"(v)
               : "memory");
}

// *p in the shared memory of the cluster's block `rank` (volatile: kept
// after the barrier wait that makes it valid).
__device__ __forceinline__ float ld_cluster(const float* p, uint32_t rank) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(cluster_addr(p, rank)));
  return v;
}

// The 16 bytes at p in the shared memory of the cluster's block `rank`.
__device__ __forceinline__ uint4 ld_cluster_v4(const void* p, uint32_t rank) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(cluster_addr(p, rank))
               : "memory");
  return v;
}

// One arrival on the mbarrier *bar of the cluster's block `rank`,
// releasing this thread's earlier writes to the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t rank) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          cluster_addr(bar, rank))
      : "memory");
}

// One arrival on the mbarrier *bar of the cluster's block `rank`, at the
// default release semantics (the CTA's scope), for an arrival that orders
// no memory access of this thread's for the peer.
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar,
                                                   uint32_t rank) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(
                   cluster_addr(bar, rank))
               : "memory");
}

// mbar_wait that acquires what the arrivals released in the cluster.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// --- warpgroups ----------------------------------------------------------

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Keeps the compiler from touching the accumulators across the async
// wgmma: after wgmma_wait they are read as the tensor cores left them.
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// --- shared-memory matrix descriptors ------------------------------------

// A K-major tile with 128-byte rows and 128-byte swizzle (what TMA's
// CU_TENSOR_MAP_SWIZZLE_128B writes): 8-row groups 1024 bytes apart. A
// wgmma's 32-byte K step moves the start address within the swizzle row;
// the tile itself is 1024-byte aligned.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// A K-major tile with 64-byte rows and 64-byte swizzle
// (CU_TENSOR_MAP_SWIZZLE_64B): 8-row groups 512 bytes apart; a 32-byte K
// step moves the start address within the row. 512-byte aligned.
__device__ __forceinline__ uint64_t smem_desc_k64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

// An MN-major tile in 64-byte swizzle: 32-element (64-byte) slices along
// M/N, `mn_stride` bytes apart, each of rows along K, 8-row K groups 512
// bytes apart. 512-byte aligned.
__device__ __forceinline__ uint64_t smem_desc_mn64(uint32_t addr,
                                                   uint32_t mn_stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((mn_stride >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

// --- bf16 wgmma, A from registers ----------------------------------------
//
// D[64 x N] (+)= A[64 x 16] * B, f32 accumulate. A is the warpgroup's
// register fragment: warp w holds rows 16w..16w+15 in mma.sync's m16n8k16
// A layout (a[0] rows g / cols 2t, a[1] rows g+8, a[2] cols 2t+8, a[3]
// both). B comes by descriptor: K-major for the score product (n64),
// MN-major for PV (n96, n128, and n64 with kTransB = 1 at head width 64).
// D register 4i + e holds row 16w + g +
// 8 (e / 2), column 8i + 2t + e % 2, g = lane / 4, t = lane % 4:
// mma.sync's C layout for each 8-column slice.

#define HOPPER_F8(d, i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

template <int kTransB = 0>
__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : HOPPER_F8(d, 0), HOPPER_F8(d, 8), HOPPER_F8(d, 16), HOPPER_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate), "n"(kTransB));
}

__device__ __forceinline__ void wgmma_bf16_n96(float (&d)[48],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : HOPPER_F8(d, 0), HOPPER_F8(d, 8), HOPPER_F8(d, 16), HOPPER_F8(d, 24),
        HOPPER_F8(d, 32), HOPPER_F8(d, 40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : HOPPER_F8(d, 0), HOPPER_F8(d, 8), HOPPER_F8(d, 16), HOPPER_F8(d, 24),
        HOPPER_F8(d, 32), HOPPER_F8(d, 40), HOPPER_F8(d, 48),
        HOPPER_F8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// --- tf32 wgmma (the 3xTF32 products of attention_f32.cu) ---------------
//
// D[64 x N] (+)= A[64 x 8] * B[8 x N] on tf32 operands with f32
// accumulation. tf32 takes both operands K-major (no transpose). A from
// registers: warp w holds rows 16w..16w+15 in mma.sync's m16n8k8 tf32 A
// layout (a[0] row g col t, a[1] row g+8 col t, a[2] row g col t+4, a[3]
// row g+8 col t+4); or A by descriptor. B by descriptor. D as above.

// x rounded to tf32 (10 mantissa bits, to nearest, ties away), as a .b32
// whose low 13 bits are zero: also the f32 value it stands for. This is
// cvt.rna.tf32.f32's result for every finite x (half an ulp added to the
// magnitude's bits, then cut), in two integer operations: cvt runs on the
// SM's conversion unit, a few results a clock.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// Orders this thread's earlier generic-proxy accesses to shared memory
// before later async-proxy ones (wgmma operand reads, TMA writes).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// bar.sync on named barrier `id` (1..15) among `threads` threads, and
// bar.arrive, which counts this thread's warp without waiting.
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : HOPPER_F8(d, 0), HOPPER_F8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// The same with A by descriptor (K-major, as smem_desc describes it).
__device__ __forceinline__ void wgmma_tf32_n32_ss(float (&d)[16],
                                                  uint64_t da, uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : HOPPER_F8(d, 0), HOPPER_F8(d, 8)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : HOPPER_F8(d, 0), HOPPER_F8(d, 8), HOPPER_F8(d, 16), HOPPER_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_n96(float (&d)[48],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : HOPPER_F8(d, 0), HOPPER_F8(d, 8), HOPPER_F8(d, 16), HOPPER_F8(d, 24),
        HOPPER_F8(d, 32), HOPPER_F8(d, 40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : HOPPER_F8(d, 0), HOPPER_F8(d, 8), HOPPER_F8(d, 16), HOPPER_F8(d, 24),
        HOPPER_F8(d, 32), HOPPER_F8(d, 40), HOPPER_F8(d, 48),
        HOPPER_F8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

#undef HOPPER_F8

// --- tensor maps (host) --------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library does not link libcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}
