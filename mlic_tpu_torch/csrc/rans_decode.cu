// Interleaved rans16 decode of one coding phase, stream format v3/v4
// (global emission order).
//
// Replaces the lax.scan of mlic_tpu/entropy/device_rans.py:169
// (make_decoder, fmt="global"): the parametric step (_step_parametric :277),
// the integer-row step of the v4 z section (_step_rowtab :237) and the
// renormalization (_renorm_global :152).  The escape patch stays in PyTorch.
//
// One block per image, one thread per lane (n_lanes below 32, or a multiple
// of 32 up to 1024, so every warp's ballot mask is exact); each thread
// loops over the phase's S steps.  Per step:
//  * parametric mode (cols != nullptr): the six pre-selected row columns
//    (m, b, A, C, B, L) of this position, a bisection of n_steps levels on
//    the shared cdf_eval (cdf.cuh) over slots [0, L]; cf == 2^16-1 is the
//    escape (its cdf slot has frequency 1 in every row);
//  * row-table mode: the same bisection over the integer CDF row
//    cdf_rows[row] (factorized-prior rows of the z section), exact by
//    construction;
//  * x = freq * (x >> 16) + cf - start (uint32), then the lanes whose state
//    fell below 2^16 read one 16-bit word each.  Words are stored in
//    (step, lane) consumption order per image, so a lane's word sits at the
//    image pointer plus its exclusive rank among this step's reading lanes:
//    a warp ballot and popcount give the rank inside the warp, per-warp
//    totals in shared memory the offset of the warp.
// The carry (x per lane, word pointer per image) is read from x_in/ptr_in
// and written to x_out/ptr_out, so one decode chains the z section and the
// y phases through device tensors.
//
// Bound on this card: the serial chain of S steps per lane, each a
// bisection of ~12 erfcf evaluations plus two block barriers -- not bytes
// (29 B per position moved in all) and not the f32 rate.  Only as many
// blocks as images run (8 of 132 SMs at the codec's batch); the design
// keeps the whole step in registers and the renorm scan to one ballot and
// two barriers.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cdf.cuh"

namespace {

__global__ void rans_decode_kernel(
    const uint16_t* __restrict__ words, long long n_words,
    const long long* __restrict__ x_in, const int* __restrict__ ptr_in,
    long long* __restrict__ x_out, int* __restrict__ ptr_out,
    int* __restrict__ sym, bool* __restrict__ esc, int S, int n_lanes,
    const float* __restrict__ cols, int n_steps, const int* __restrict__ rows,
    const int* __restrict__ cdf_rows, int width,
    const int* __restrict__ max_value_t, const int* __restrict__ offsets_t) {
  __shared__ int warp_counts[32];
  const int b = blockIdx.x;
  const int l = threadIdx.x;
  const long long BL = static_cast<long long>(gridDim.x) * n_lanes;
  const long long g = static_cast<long long>(b) * n_lanes + l;
  const int lane = l & 31;
  const int warp = l >> 5;
  const int n_warps = (n_lanes + 31) >> 5;
  const unsigned mask = n_lanes >= 32 ? 0xffffffffu : ((1u << n_lanes) - 1u);
  const unsigned below = (1u << lane) - 1u;
  const long long plane = static_cast<long long>(S) * BL;

  uint32_t x = static_cast<uint32_t>(x_in[g]);
  long long ptr = ptr_in[b];
  for (int s = 0; s < S; ++s) {
    const long long i = static_cast<long long>(s) * BL + g;
    const int cf = static_cast<int>(x & 0xffffu);
    int lo = 0, v_lo = 0, hi, v_hi, out_sym;
    uint32_t start, freq;
    bool e;
    if (cols != nullptr) {
      const float pm = cols[i], pb = cols[plane + i], pA = cols[2 * plane + i];
      const float pC = cols[3 * plane + i], pB = cols[4 * plane + i];
      const int max_value = static_cast<int>(cols[5 * plane + i]);
      e = cf == 0xffff;
      hi = max_value;
      v_hi = 0xffff;
      for (int it = 0; it < n_steps; ++it) {
        if (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          const int v = cdf_eval(mid, pm, pb, pA, pC, pB);
          if (v <= cf) { lo = mid; v_lo = v; } else { hi = mid; v_hi = v; }
        }
      }
      start = e ? 0xffffu : static_cast<uint32_t>(v_lo);
      freq = e ? 1u : static_cast<uint32_t>(v_hi - v_lo);
      out_sym = lo - ((max_value - 1) >> 1);
    } else {
      const int row = rows[i];
      const int max_value = max_value_t[row];
      const int* crow = cdf_rows + static_cast<long long>(row) * width;
      hi = max_value + 1;
      v_hi = 1 << 16;
      for (int it = 0; it < n_steps; ++it) {
        if (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          const int v = crow[mid];
          if (v <= cf) { lo = mid; v_lo = v; } else { hi = mid; v_hi = v; }
        }
      }
      start = static_cast<uint32_t>(v_lo);
      freq = static_cast<uint32_t>(v_hi - v_lo);
      e = lo == max_value;
      out_sym = lo + offsets_t[row];
    }
    x = freq * (x >> 16) + static_cast<uint32_t>(cf) - start;

    const bool need = x < (1u << 16);
    const unsigned ballot = __ballot_sync(mask, need);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < n_warps; ++w) {
      const int c = warp_counts[w];
      before += w < warp ? c : 0;
      total += c;
    }
    __syncthreads();  // warp_counts is rewritten by the next step
    if (need) {
      long long pos = ptr + before + __popc(ballot & below);
      if (pos > n_words - 1) pos = n_words - 1;
      x = (x << 16) | words[pos];
    }
    ptr += total;
    sym[i] = out_sym;
    esc[i] = e;
  }
  x_out[g] = static_cast<long long>(x);
  if (l == 0) ptr_out[b] = static_cast<int>(ptr);
}

}  // namespace

extern "C" int rans_decode_launch(
    const uint16_t* words, long long n_words, const long long* x_in,
    const int* ptr_in, long long* x_out, int* ptr_out, int* sym, bool* esc,
    int S, int n_images, int n_lanes, const float* cols, int n_steps,
    const int* rows, const int* cdf_rows, int width, const int* max_value,
    const int* offsets, void* stream) {
  // A warp is either the only, partial one (n_lanes < 32) or full: the
  // ballot's mask names all 32 lanes of every warp from 32 lanes up.
  if (n_lanes < 1 || n_lanes > 1024 || (n_lanes >= 32 && n_lanes % 32) ||
      n_images < 1 || n_words < 1 || S < 0 ||
      (cols == nullptr && rows == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rans_decode_kernel<<<n_images, n_lanes, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      words, n_words, x_in, ptr_in, x_out, ptr_out, sym, esc, S, n_lanes,
      cols, n_steps, rows, cdf_rows, width, max_value, offsets);
  return static_cast<int>(cudaGetLastError());
}
