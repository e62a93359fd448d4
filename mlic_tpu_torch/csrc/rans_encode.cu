// Interleaved rans16 encode scan over [S, L] position-ordered symbols.
//
// Replaces the reverse lax.scan of mlic_tpu/entropy/device_rans.py:525
// (encode_scan_prepped), whose _divmod_u32 float-reciprocal division was a
// TPU workaround; here the divide is plain uint32 / and %.
//
// One thread per lane walks the steps from S-1 down to 0 (rANS is LIFO):
// state x (uint32) starts at 2^16; a step emits the low 16 bits iff
// x >= freq << 16, shifts them out, then sets
// x = (x / freq) << 16 + x % freq + start.  start and freq-1 are uint16
// in step-major order, so the lanes of a warp read neighbouring addresses.
// Outputs: the final states, the word of every step (x & 0xffff before the
// emit test) and the emit mask; compaction stays in PyTorch.
//
// Bound on this card: the S-step serial chain of each lane (a load, an
// integer divide and a few ALU ops per step), not bytes -- 7 B per
// (step, lane) moved in all is microseconds at HBM rate.  With L = 4096
// lanes only 32 blocks run; the loop is latency-bound by design of the
// coder, and the next step's loads do not depend on x, so the compiler may
// issue them early.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void rans_encode_kernel(const uint16_t* __restrict__ start,
                                   const uint16_t* __restrict__ freqm1,
                                   long long* __restrict__ x_out,
                                   uint16_t* __restrict__ words,
                                   bool* __restrict__ emits, int S, int L) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  uint32_t x = 1u << 16;
  for (int s = S - 1; s >= 0; --s) {
    const size_t i = static_cast<size_t>(s) * L + l;
    const uint32_t st = start[i];
    const uint32_t fr = static_cast<uint32_t>(freqm1[i]) + 1u;
    const bool emit = x >= (fr << 16);
    words[i] = static_cast<uint16_t>(x & 0xffffu);
    emits[i] = emit;
    if (emit) x >>= 16;
    x = ((x / fr) << 16) + (x % fr) + st;
  }
  x_out[l] = static_cast<long long>(x);
}

}  // namespace

extern "C" int rans_encode_launch(const uint16_t* start,
                                  const uint16_t* freqm1, long long* x_out,
                                  uint16_t* words, bool* emits, int S, int L,
                                  void* stream) {
  if (S < 0 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 128;
  const int blocks = (L + threads - 1) / threads;
  rans_encode_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      start, freqm1, x_out, words, emits, S, L);
  return static_cast<int>(cudaGetLastError());
}
