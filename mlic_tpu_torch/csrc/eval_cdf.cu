// CDF evaluator: out[i] = cdf_eval(k[i], m[c], b[c], A[c], C[c], B[c]) with
// c = i % n_cols -- the k array may stack several evaluations per column
// set (the encoder evaluates slot and slot + 1 in one launch).
//
// Replaces the XLA evaluation of mlic_tpu/entropy/parametric.py:93
// (eval_cdf_parts) in generate_tables, self_check, self_check_encode and
// device_rans.analytic_start_freq; its arithmetic lives in cdf.cuh, shared
// with the decode kernel.
//
// Bound on this card: memory bytes -- per element 4 B of k read and 4 B
// written, plus 20 B of columns per column set; the erfcf and a dozen
// float ops per element are far below the f32 rate.  Design: grid-stride
// elementwise loop, coalesced reads and writes.
#include <cuda_runtime.h>

#include "cdf.cuh"
#include "launch_count.cuh"

namespace {

__global__ void eval_cdf_kernel(const int* __restrict__ k,
                                const float* __restrict__ m,
                                const float* __restrict__ b,
                                const float* __restrict__ A,
                                const float* __restrict__ C,
                                const float* __restrict__ B,
                                int* __restrict__ out, long long n_total,
                                long long n_cols) {
  count_device_launch();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n_total; i += stride) {
    const long long c = i % n_cols;
    out[i] = cdf_eval(k[i], m[c], b[c], A[c], C[c], B[c]);
  }
}

}  // namespace

extern "C" int eval_cdf_launch(const int* k, const float* m, const float* b,
                               const float* A, const float* C, const float* B,
                               int* out, long long n_total, long long n_cols,
                               void* stream) {
  if (n_cols < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_total > 0) {
    const int threads = 256;
    long long blocks = (n_total + threads - 1) / threads;
    if (blocks > 132 * 32) blocks = 132 * 32;
    eval_cdf_kernel<<<static_cast<int>(blocks), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        k, m, b, A, C, B, out, n_total, n_cols);
  }
  return static_cast<int>(cudaGetLastError());
}

MLIC_DEVICE_LAUNCH_COUNTER(eval_cdf)
