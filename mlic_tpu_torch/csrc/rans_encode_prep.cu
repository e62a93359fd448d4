// K7: the prep of the format-v4 rANS encode -- each position's (start,
// freq - 1, escape) for the z section, from the integer CDF rows, and for
// the y section, from the analytic Gaussian CDF, in the caller's [B, n]
// layout, which K3 and K6 read in place.
//
// Replaces analytic_start_freq (mlic_tpu/entropy/device_rans.py:419) with
// the row select it calls (select_rows, :387, the Pallas kernel
// select_rows_pallas of mlic_tpu/ops/pallas_select.py:93 on the TPU) and
// _gather_start_freq (:468).  The TPU needed a separate compare-and-select
// kernel because a dynamic gather is slow there; before this kernel the
// port ran the same composition in about 30 launches: K1 writing six f32
// planes (24 B a position) that the next ops read back, eight elementwise
// ops, a stack, K2, two subtractions, and a dozen ops of gathers for z.
//
// y: the row-parameter table (<= 128 rows x 6 f32, 3 KB) is staged in the
// block's shared memory and each position reads its row's six constants
// (m, b, A, C, B, L) there; rows outside [0, n_rows) take row 0, as
// select_rows does.  Then L, the offset -(L - 1) / 2, the slot (L for an
// escape) and cdf_eval (cdf.cuh) at slot and slot + 1: the one CDF function
// that K2 and the decoder K4 evaluate too, which is what makes the round
// trip exact.
// z: the row of an image's flat index j (NHWC raveled, channel-minor) is
// z_rows_base + j % n_z_rows; its max_value and offset give the slot, and
// the two CDF entries come from the integer row in global memory (the
// factorized-prior rows are a few KB and stay in L2).
// y in gather mode (y_gather = 1: Codec.update fell back, its table failing
// the encode-shaped check or replaced by the host-built rows): the same
// gather as z, at the row y_idx names (rows outside [0, n_cdf_rows) take
// row 0); the row-parameter table is then not read and may be absent.
// The Gaussian rows are up to 3,136 entries (12.5 KB) each, 65 of them:
// about 0.8 MB, which L2 holds.  A format-v3 encode has no z section
// (n_z = 0).
//
// Bound on this card: bytes.  A y position reads 8 B (symbol, scale index)
// and writes 9 B (start and freq - 1 as int32, the escape flag): 34.7 MB
// and ~0.010 ms at the serving batch of 8 x 768x512 (2,039,808 positions).
// Its two cdf_eval are ~72 f32 operations, under a quarter of the byte
// time at the f32 rate.  A gathered y position moves the same 17 B plus
// two 4 B entries of its row.  Design: one launch for both sections, a
// grid-stride loop of one position a thread, coalesced loads and stores;
// nothing but the outputs is written to device memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cdf.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 128;
constexpr int kCols = 6;            // m, b, A, C, B, L

// (start, freq - 1, escape) of value `sym` in integer row `row`.
__device__ __forceinline__ void gather_entry(
    int sym, int row, const int* __restrict__ cdf_rows, int width,
    const int* __restrict__ max_value, const int* __restrict__ offsets,
    int* start, int* freqm1, bool* esc) {
  const int mv = max_value[row];
  // int32 arithmetic wraps, as the plain version's does
  const int v = static_cast<int>(static_cast<unsigned>(sym) -
                                 static_cast<unsigned>(offsets[row]));
  const bool e = v < 0 || v >= mv;
  const int* crow = cdf_rows + static_cast<long long>(row) * width;
  const int lo = crow[e ? mv : v];
  *start = lo;
  *freqm1 = crow[(e ? mv : v) + 1] - lo - 1;
  *esc = e;
}

__global__ void __launch_bounds__(kThreads) rans_encode_prep_kernel(
    const int* __restrict__ y_sym, const int* __restrict__ y_idx,
    const int* __restrict__ z_sym, const float* __restrict__ row_params,
    int n_rows, int y_gather, const int* __restrict__ cdf_rows, int width,
    int n_cdf_rows, const int* __restrict__ max_value,
    const int* __restrict__ offsets, int z_rows_base, int n_z_rows,
    long long n_y_total, long long n_total, int n_z,
    int* __restrict__ z_start, int* __restrict__ z_freqm1,
    bool* __restrict__ z_esc, int* __restrict__ y_start,
    int* __restrict__ y_freqm1, bool* __restrict__ y_esc) {
  __shared__ float tab[kMaxRows * kCols];
  if (!y_gather) {
    for (int i = threadIdx.x; i < n_rows * kCols; i += blockDim.x)
      tab[i] = row_params[i];
    __syncthreads();
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n_total; i += stride) {
    if (i < n_y_total && y_gather) {
      int r = y_idx[i];
      if (r < 0 || r >= n_cdf_rows) r = 0;
      gather_entry(y_sym[i], r, cdf_rows, width, max_value, offsets,
                   y_start + i, y_freqm1 + i, y_esc + i);
    } else if (i < n_y_total) {
      int r = y_idx[i];
      if (r < 0 || r >= n_rows) r = 0;
      const float* c = tab + r * kCols;
      const int L = static_cast<int>(c[5]);     // support size, exact in f32
      const int off = -((L - 1) >> 1);
      // int32 arithmetic wraps, as the plain version's does
      const int v = static_cast<int>(static_cast<unsigned>(y_sym[i]) -
                                     static_cast<unsigned>(off));
      const bool e = v < 0 || v >= L;
      const int slot = e ? L : v;
      const int lo = cdf_eval(slot, c[0], c[1], c[2], c[3], c[4]);
      const int hi = cdf_eval(slot + 1, c[0], c[1], c[2], c[3], c[4]);
      y_start[i] = lo;
      y_freqm1[i] = hi - lo - 1;
      y_esc[i] = e;
    } else {
      const int k = static_cast<int>(i - n_y_total);   // < 2^31 (wrapper)
      const int row = z_rows_base + (k % n_z) % n_z_rows;
      gather_entry(z_sym[k], row, cdf_rows, width, max_value, offsets,
                   z_start + k, z_freqm1 + k, z_esc + k);
    }
  }
}

}  // namespace

// Inputs: y_sym, y_idx int32 [B, n_y]; z_sym int32 [B, n_z]; row_params f32
// [n_rows, 6] (read unless y_gather); cdf_rows int32 [n_cdf_rows, width],
// max_value and offsets int32 [n_cdf_rows] (read only when n_z > 0 or
// y_gather).  Outputs: start, freq - 1 (int32) and escape (bool) of z
// [B, n_z] and of y [B, n_y].
extern "C" int rans_encode_prep_launch(
    const int* y_sym, const int* y_idx, const int* z_sym,
    const float* row_params, int n_rows, int y_gather, const int* cdf_rows,
    int width, int n_cdf_rows, const int* max_value, const int* offsets,
    int z_rows_base, int n_z_rows, int n_images, int n_y, int n_z,
    int* z_start, int* z_freqm1, bool* z_esc, int* y_start, int* y_freqm1,
    bool* y_esc, void* stream) {
  const long long n_y_total = static_cast<long long>(n_images) * n_y;
  const long long n_z_total = static_cast<long long>(n_images) * n_z;
  const bool rows_ok = cdf_rows != nullptr && max_value != nullptr &&
                       offsets != nullptr && width >= 2 && n_cdf_rows >= 1;
  if ((!y_gather && (row_params == nullptr || n_rows < 1 ||
                     n_rows > kMaxRows)) ||
      (y_gather && !rows_ok) || n_images < 1 || n_y < 0 || n_z < 0 ||
      n_y_total >= (1ll << 31) || n_z_total >= (1ll << 31) ||
      (n_z > 0 && (!rows_ok || n_z_rows < 1 || z_rows_base < 0 ||
                   z_rows_base + n_z_rows > n_cdf_rows)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_total = n_y_total + n_z_total;
  if (n_total > 0) {
    long long blocks = (n_total + kThreads - 1) / kThreads;
    if (blocks > 132 * 16) blocks = 132 * 16;
    rans_encode_prep_kernel<<<static_cast<int>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        y_sym, y_idx, z_sym, row_params, n_rows, y_gather ? 1 : 0, cdf_rows,
        width, n_cdf_rows, max_value, offsets, z_rows_base, n_z_rows,
        n_y_total, n_total, n_z > 0 ? n_z : 1, z_start, z_freqm1, z_esc,
        y_start, y_freqm1, y_esc);
  }
  return static_cast<int>(cudaGetLastError());
}
