// Register-level pieces of attention_qkv3.cu's body: the bf16 bias adds of
// K8 (to q's fragments and to each landed V tile), 16-byte shared-memory
// loads and stores, ldmatrix, bf16 packing and the SFU's 2^x.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"  // smem_u32

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 pairs added as PyTorch adds bf16 tensors: the f32 sum of each
// pair, rounded once to bf16.
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162 y = *reinterpret_cast<const __nv_bfloat162*>(&b);
  const __nv_bfloat162 r =
      __floats2bfloat162_rn(__fadd_rn(__low2float(x), __low2float(y)),
                            __fadd_rn(__high2float(x), __high2float(y)));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Eight bf16 values (16 bytes) with the eight of `bias` added as above.
__device__ __forceinline__ uint4 add_bf16x8(uint4 x, uint4 bias) {
  return make_uint4(add_bf16x2(x.x, bias.x), add_bf16x2(x.y, bias.y),
                    add_bf16x2(x.z, bias.z), add_bf16x2(x.w, bias.w));
}

// 16 bytes of shared memory at a shared-space address, and back.
__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// Four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and lane (g, t) gets row g, columns 2t and 2t+1 of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// Two floats rounded to bf16 in one conversion, lo in the low half.
__device__ __forceinline__ uint32_t pack_f32_bf16(float lo, float hi) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// 2^x on the SFU's ex2: exp2f's instruction without its fix-ups for
// results below 2^-126, which it flushes to 0 (a p that small is 0 at the
// bar).
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
