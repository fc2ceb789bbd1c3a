// The dequantization of an int8 x int8 -> int32 product, one device function
// for both kernels that compute it: E3 (int8_epilogue.cu's dequant_kernel)
// and G1 (int8_gemm.cu's epilogue), so the two cannot drift apart.
//
//   out = dt((f32(acc) * xs) * ws + b)          [+ residual, summed in dt]
//
// The plain version's arithmetic (ops/quant.py::int8_epilogue_ref),
// rounding for rounding: the int32 -> f32 conversion rounds to nearest
// (__int2float_rn, as .float() converts); the products and the sums are
// __fmul_rn / __fadd_rn, which nvcc never contracts into an FMA (one FMA
// would move codes downstream). In bf16 the value is rounded to bf16 before
// the residual reads it, and the sum is rounded again by its store, as
// `x + int8_mm(...)` rounds.
#pragma once

#include <cuda_bf16.h>

// (f32(acc) * xs) * ws: the product's value before its bias.
__device__ __forceinline__ float int8_dequant(int acc, float xs, float ws) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
}

// v + b, the bias added in f32.
__device__ __forceinline__ float int8_dequant_bias(float v, float b) {
  return __fadd_rn(v, b);
}

// v as the plain version stores it in T: rounded to bf16, or kept in f32.
template <typename T>
__device__ __forceinline__ float int8_round_to(float v);

template <>
__device__ __forceinline__ float int8_round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <>
__device__ __forceinline__ float int8_round_to<float>(float v) {
  return v;
}

// residual x + dt(v), summed in f32; the caller's store rounds it to T.
template <typename T>
__device__ __forceinline__ float int8_residual_sum(float x, float v) {
  return __fadd_rn(x, int8_round_to<T>(v));
}
