// The GELUs of the int8 trunk, shared by the fused int8 MLP (K4,
// fused_mlp_int8.cu) and act_quant (K5, act_quant.cu). Each product and sum
// is rounded where the plain PyTorch version rounds it (__fmul_rn /
// __fadd_rn keep nvcc from contracting them into FMAs).
#pragma once

#include <math.h>

// models/layers.py::gelu_bf16_poly, operation by operation; constants are
// the double literals rounded to float, as PyTorch rounds its scalars.
__device__ __forceinline__ float gelu_poly(float x) {
  const float u = __fmul_rn(fminf(fmaxf(x, (float)-4.1), (float)4.1),
                            (float)0.7071067811865476);
  const float s = __fmul_rn(u, u);
  float p = __fadd_rn(__fmul_rn(s, (float)6.119205364e-06),
                      (float)-0.0001988900883);
  p = __fadd_rn(__fmul_rn(p, s), (float)0.002738415506);
  p = __fadd_rn(__fmul_rn(p, s), (float)-0.02129873868);
  p = __fadd_rn(__fmul_rn(p, s), (float)0.1064506995);
  p = __fadd_rn(__fmul_rn(p, s), (float)-0.3732706075);
  p = __fadd_rn(__fmul_rn(p, s), (float)1.128166641);
  const float e = fminf(fmaxf(__fmul_rn(u, p), -1.f), 1.f);
  return __fmul_rn(__fmul_rn(__fadd_rn(e, 1.f), x), 0.5f);
}

// Exact GELU as PyTorch computes it: x * 0.5 * (1 + erf(x / sqrt(2))).
__device__ __forceinline__ float gelu_erf(float x) {
  return __fmul_rn(__fmul_rn(x, 0.5f),
                   __fadd_rn(1.f, erff(__fmul_rn(x, (float)0.70710678118654752))));
}
