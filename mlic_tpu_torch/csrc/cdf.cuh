// The analytic quantized-Gaussian CDF, shared by the CDF evaluator kernel
// (eval_cdf.cu: table generation, both self-checks, the encoder's start and
// frequency) and the rANS decode kernel's bisection (rans_decode.cu).
//
// Replaces mlic_tpu/entropy/parametric.py:93 (eval_cdf_parts), which XLA
// compiled separately in every program that used it -- the one hazard
// between the encoder's integer table and the decoder (parametric.py:32-37).
// Here one source defines the arithmetic for every caller:
//
//   cdf(k) = k + rint(clamp(0.5 * erfc(-(k*m + b)) * A + C, 0, B))
//
// Each product and sum is rounded on its own (__fmul_rn / __fadd_rn), so
// nvcc cannot contract k*m+b or g*A+C into an FMA at one call site and not
// at another, and the op sequence equals the plain PyTorch version's
// (separate mul and add kernels).  rintf rounds half to even, like
// torch.round and jnp.round.
#pragma once

__device__ __forceinline__ int cdf_eval(int k, float m, float b, float A,
                                        float C, float B) {
  const float t = __fadd_rn(__fmul_rn(static_cast<float>(k), m), b);
  const float g = __fmul_rn(0.5f, erfcf(-t));
  float raw = __fadd_rn(__fmul_rn(g, A), C);
  raw = fminf(fmaxf(raw, 0.0f), B);
  return k + static_cast<int>(rintf(raw));
}
