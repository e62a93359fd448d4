// Row select: out[j][i] = table[rows[i]][j] for a tiny f32 table.
//
// Replaces the Pallas kernel select_rows_pallas (mlic_tpu/ops/pallas_select.py:93,
// body _kernel :62), which ran a compare+select chain over the table rows
// because dynamic gathers are slow on the TPU.  On Hopper a gather from
// shared memory is cheap, so the table (<= 128 rows x 8 columns, 4 KB) is
// staged in shared memory once per block and every element is one direct
// lookup per column.  Rows outside [0, n_rows) select row 0, as the chain
// does.  No arithmetic: the result is bit-identical to table[row].
//
// Bound on this card: memory bytes -- 4 B of row index read and 4 B per
// column written per element (28 B for the codec's 6 columns), no
// arithmetic; at the codec's [48, 4096] the whole call moves 5.5 MB, about
// 1.6 us at 3.35 TB/s, so a launch's fixed latencies weigh as much as the
// bytes.  Design: a thread takes four elements, reads their row indices as
// one 16-byte int4 and writes each column plane as one 16-byte float4; its
// first indices are loaded before the table, and the table's entries all
// before any is stored, so one load latency precedes the stores; the grid
// is at most 16 blocks of 128 threads on each of the 132 SMs (one wave,
// every block resident), grid-striding beyond.  Where the count is not a
// multiple of four or a pointer is not 16-byte aligned, the same lookups
// run one element a thread.
#include <cuda_runtime.h>

#include <cstdint>

#include "launch_count.cuh"

namespace {

constexpr int kMaxRows = 128;
constexpr int kMaxCols = 8;
constexpr int kThreads = 128;
constexpr int kBlocksMax = 132 * 16;

__device__ __forceinline__ int clamp_row(int r, int n_rows) {
  return (r < 0 || r >= n_rows) ? 0 : r;
}

__global__ void __launch_bounds__(kThreads)
    select_rows_kernel(const int* __restrict__ rows,
                       const float* __restrict__ table,
                       float* __restrict__ out, long long n, long long n4,
                       int n_rows, int n_cols) {
  count_device_launch();
  __shared__ float tab[kMaxRows * kMaxCols];
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long q = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int4* rows4 = reinterpret_cast<const int4*>(rows);
  int4 r4 = q < n4 ? __ldg(rows4 + q) : make_int4(0, 0, 0, 0);
  // the table's loads all issued before any is stored: one latency
  constexpr int kPer = kMaxRows * kMaxCols / kThreads;
  float t[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = u * kThreads + threadIdx.x;
    t[u] = i < n_rows * n_cols ? __ldg(table + i) : 0.0f;
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = u * kThreads + threadIdx.x;
    if (i < n_rows * n_cols) tab[i] = t[u];
  }
  __syncthreads();
  for (; q < n4; q += stride) {
    const int a = clamp_row(r4.x, n_rows) * n_cols;
    const int b = clamp_row(r4.y, n_rows) * n_cols;
    const int c = clamp_row(r4.z, n_rows) * n_cols;
    const int d = clamp_row(r4.w, n_rows) * n_cols;
    const long long next = q + stride;
    if (next < n4) r4 = __ldg(rows4 + next);
    for (int j = 0; j < n_cols; ++j) {
      reinterpret_cast<float4*>(out + j * n)[q] =
          make_float4(tab[a + j], tab[b + j], tab[c + j], tab[d + j]);
    }
  }
  for (long long i = 4 * n4 + static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    const int r = clamp_row(rows[i], n_rows) * n_cols;
    for (int j = 0; j < n_cols; ++j) out[j * n + i] = tab[r + j];
  }
}

__global__ void empty_kernel() {}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

long long blocks_for(long long items) {
  const long long b = (items + kThreads - 1) / kThreads;
  return b < 1 ? 1 : (b > kBlocksMax ? kBlocksMax : b);
}

}  // namespace

extern "C" int select_rows_launch(const int* rows, const float* table,
                                  float* out, long long n, int n_rows,
                                  int n_cols, void* stream) {
  if (n_rows < 1 || n_rows > kMaxRows || n_cols < 1 || n_cols > kMaxCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const long long n4 =
        (n % 4 == 0 && aligned16(rows) && aligned16(out)) ? n / 4 : 0;
    select_rows_kernel<<<static_cast<int>(blocks_for(n4 ? n4 : n)),
                         kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        rows, table, out, n, n4, n_rows, n_cols);
  }
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on the grid select_rows_launch takes for n elements: the
// floor of a launch of that shape on the stream, for timing beside K1.
extern "C" int select_rows_empty_launch(long long n, void* stream) {
  empty_kernel<<<static_cast<int>(blocks_for(n % 4 == 0 ? n / 4 : n)),
                 kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

MLIC_DEVICE_LAUNCH_COUNTER(select_rows)
