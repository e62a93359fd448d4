// Row select: out[j][i] = table[rows[i]][j] for a tiny f32 table.
//
// Replaces the Pallas kernel select_rows_pallas (mlic_tpu/ops/pallas_select.py:93,
// body _kernel :62), which ran a compare+select chain over the table rows
// because dynamic gathers are slow on the TPU.  On Hopper a gather from
// shared memory is cheap, so the table (<= 128 rows x 8 columns, 4 KB) is
// staged in shared memory once per block and every thread does one direct
// lookup per column.  Rows outside [0, n_rows) select row 0, as the chain
// does.  No arithmetic: the result is bit-identical to table[row].
//
// Bound on this card: memory bytes -- 4 B of row index read and 4 B per
// column written per element (28 B for the codec's 6 columns), no
// arithmetic.  Design: grid-stride loop, one element per thread per
// iteration, coalesced int32 reads and f32 column-plane writes.
#include <cuda_runtime.h>

#include "launch_count.cuh"

namespace {

constexpr int kMaxRows = 128;
constexpr int kMaxCols = 8;

__global__ void select_rows_kernel(const int* __restrict__ rows,
                                   const float* __restrict__ table,
                                   float* __restrict__ out, long long n,
                                   int n_rows, int n_cols) {
  count_device_launch();
  __shared__ float tab[kMaxRows * kMaxCols];
  for (int i = threadIdx.x; i < n_rows * n_cols; i += blockDim.x) {
    tab[i] = table[i];
  }
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    int r = rows[i];
    if (r < 0 || r >= n_rows) r = 0;
    for (int j = 0; j < n_cols; ++j) {
      out[j * n + i] = tab[r * n_cols + j];
    }
  }
}

}  // namespace

extern "C" int select_rows_launch(const int* rows, const float* table,
                                  float* out, long long n, int n_rows,
                                  int n_cols, void* stream) {
  if (n_rows < 1 || n_rows > kMaxRows || n_cols < 1 || n_cols > kMaxCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 132 * 32) blocks = 132 * 32;
    select_rows_kernel<<<static_cast<int>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        rows, table, out, n, n_rows, n_cols);
  }
  return static_cast<int>(cudaGetLastError());
}

MLIC_DEVICE_LAUNCH_COUNTER(select_rows)
