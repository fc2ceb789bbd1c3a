// The bulk-copy row ring of the persistent row kernels: act_quant (K5, and
// E4's ring form, act_quant.cu), ln_quant and ln_bf16 (K2, K10,
// ln_quant.cu).
//
// A block holds kGroups groups of kG threads (a warp, or a warpgroup of four
// warps). Each group has its own ring of kRowStages row slots in shared
// memory, one mbarrier a slot. Group gid walks rows gid, gid + n, gid + 2n,
// ... of the [M, C] bf16 input, rows ldx values apart (n groups in the
// grid; gid = g * gridDim.x +
// b for group g of block b, so that the groups with one row more than the
// rest spread evenly over the SMs); its i-th row lands in slot
// i % kRowStages. The group's leader (its thread 0) issues one 1-d bulk
// copy a row: the first kRowStages rows at the start, then row
// i + kRowStages as soon as the whole group has read row i out of its slot.
// Each group so keeps rows in flight while it computes, and no thread
// spends an instruction or a register on the loads. The copies read under
// an L2 evict-first policy: the input is read once, and that leaves L2 to
// the output's lines (on the card K10 ran faster so).
//
// Shared memory is kept to about half an SM (two stages a group, two blocks
// an SM): the SM's L1 is what shared memory leaves over, and on the card a
// carve-out of ~200 KB an SM slowed even the first version of K10.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

constexpr int kRowThreads = 256;  // threads a block, two blocks an SM
constexpr int kRowStages = 2;     // row slots a group

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Bytes of one slot for rows of C bf16 values, and of a block's barriers.
__host__ __device__ constexpr uint32_t ring_slot_bytes(int C) {
  return ((uint32_t)C * 2 + 127) / 128 * 128;
}

template <int kGroups>
__host__ __device__ constexpr uint32_t ring_bar_bytes() {
  return (kGroups * kRowStages * 8 + 127) / 128 * 128;
}

// Dynamic shared memory of a block's ring: the barriers, then every group's
// slots, group after group. A kernel's own data follows.
template <int kGroups>
__host__ __device__ constexpr uint32_t ring_bytes(int C) {
  return ring_bar_bytes<kGroups>() +
         kGroups * kRowStages * ring_slot_bytes(C);
}

// A group's view of its ring.
template <int kG>
struct RowRing {
  const __nv_bfloat16* x;
  unsigned char* slots;
  uint64_t* full;
  uint64_t policy;
  long long ldx;  // values from one row's start to the next's
  int M, C, gid, ngroups;

  // Every thread builds its group's view; thread 0 of the block inits the
  // barriers, which the caller's __syncthreads publishes. Each row must
  // start 16-byte aligned (x and ldx * 2 bytes) and C * 2 be a multiple of
  // 16: what a bulk copy takes.
  template <int kGroups>
  __device__ static RowRing make(unsigned char* smem,
                                 const __nv_bfloat16* x, int M, int C,
                                 long long ldx) {
    const int group = threadIdx.x / kG;
    RowRing r;
    r.x = x;
    r.ldx = ldx;
    r.full = reinterpret_cast<uint64_t*>(smem) + group * kRowStages;
    r.slots = smem + ring_bar_bytes<kGroups>() +
              (size_t)group * kRowStages * ring_slot_bytes(C);
    r.policy = l2_evict_first();
    r.M = M;
    r.C = C;
    r.gid = group * gridDim.x + blockIdx.x;
    r.ngroups = gridDim.x * kGroups;
    if (threadIdx.x == 0) {
      uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
      for (int i = 0; i < kGroups * kRowStages; ++i) mbar_init(&bars[i], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    return r;
  }

  // Rows this group takes, and the index of its i-th.
  __device__ int rows() const {
    return gid < M ? (M - 1 - gid) / ngroups + 1 : 0;
  }
  __device__ long long row(int i) const {
    return gid + (long long)i * ngroups;
  }
  __device__ const unsigned char* slot(int i) const {
    return slots + (i % kRowStages) * ring_slot_bytes(C);
  }

  // Called by every thread t of the group: the group's i-th row into its
  // slot, if it exists, by one bulk copy of the leader's. Past the first
  // kRowStages rows, only once the whole group is done reading row
  // i - kRowStages out of the same slot.
  __device__ void issue(int i, int t) const {
    if (t != 0 || row(i) >= M) return;
    uint64_t* bar = &full[i % kRowStages];
    mbar_expect_tx(bar, C * 2);
    bulk_load(const_cast<unsigned char*>(slot(i)), x + row(i) * ldx, C * 2,
              bar, policy);
  }

  // The group's i-th row, once it has landed.
  __device__ const unsigned char* wait(int i) const {
    mbar_wait(&full[i % kRowStages], (i / kRowStages) & 1);
    return slot(i);
  }
};

// The card's SMs, read once.
inline int ring_sm_count() {
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

// Blocks of the persistent grid: two an SM where two blocks' shared memory
// fits in the SM's 228 KB (1 KB of it reserved a block), else one; never
// more than the rows need. 0 when the SMs cannot be read.
inline int ring_grid(int M, int groups_per_block, uint32_t smem) {
  const int per_sm = 2 * (smem + 1024) <= 228 * 1024 ? 2 : 1;
  const long long need = (M + groups_per_block - 1) / groups_per_block;
  const long long most = (long long)ring_sm_count() * per_sm;
  return (int)(need < most ? need : most);
}
