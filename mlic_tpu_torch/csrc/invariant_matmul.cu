// Batch-invariant product with float32 accumulation: C[g] = A[g] . B[g]
// (+ bias) over a group of independent problems g (kernel K8).
//
// Replaces no TPU kernel.  The JAX package leaves these products to XLA:
// the entropy path's window fusion (mlic_tpu/models/context.py:172), the
// two linear-attention contractions (:218-219) and the 5x5 reprojections
// (:237, :272), and the analysis transforms' convolutions that cuDNN was
// seen to order by the batch (models/transforms.py in the port).  On the
// H100, cuBLAS and cuDNN choose their kernel, and with it the order of a
// long reduction, by the problem's size, batch included: an image of a
// batch then rounds otherwise than the same image alone, its streams
// differ, and a container decoded alone sees other entropy parameters than
// its encoder did.  This kernel makes an image's floats the same at every
// batch:
//
//  * No split-K.  Every output element is one float32 FFMA chain over
//    k = 0 .. K-1 in that order, started from 0; the bias, where there is
//    one, is added after the chain.  CUDA cores only: no TF32, no tensor
//    cores (the entropy path stays in full f32).
//  * The launch configuration (tile sizes, K-tile, thread mapping) depends
//    on one problem's (M, N, K) only, never on the number of problems in
//    the group, i.e. on the batch.  (Since each output is one chain in a
//    fixed order, no choice of tile could change a float anyway.)
//
// The operands are float32, or all bfloat16 (the analysis transforms'
// convolutions under the bf16 policy): bf16 values widen exactly to f32,
// the chain is the same f32 chain, and the result is rounded to bf16 once,
// to nearest even.
//
// A is read through strides (dense mode) or, for a "SAME" convolution of
// odd window w and stride s, through the window gather of an image
// [channel, row, column] with zero padding (gather mode): M = output rows
// x output columns (each (size - 1) / s + 1), k = (channel * w + dy) * w +
// dx, the order of an OIHW weight flattened.  B and C are read and written
// through strides.  A group index is (g0, g1), each with its own stride in
// A, B and C, so the attention contractions run over images x heads in one
// launch.
//
// Bound on this card: at the entropy path's shapes, f32 operations (2 M N K
// a problem against 67 TFLOP/s); the 1x1 convolutions over an image's 3
// channels move bytes.  Design, simple first: a BM x BN output tile per
// block of 256 threads (a 16 x 16 thread grid, each thread owning (BM/16) x
// (BN/16) outputs strided by 16; BN 96 where N is 96, so the gather runs
// once a row of tiles), A and B tiles of depth 16 staged in shared memory
// with the coalesced axis of each operand chosen from its strides; the
// gather's pixel and tap arithmetic is done once a tile into shared memory.
// A persistent grid and double-buffered cp.async or TMA loads are later
// work.  Launches on the given stream, allocates nothing, counts its
// launches on the device and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "launch_count.cuh"

struct Problem {
  const void* a;
  const void* b;
  const void* bias;  // null: no bias
  void* c;
  // dense: g0, g1, m, k strides of A; gather: image, channel, row, column
  long long a_s[4];
  long long b_s[4];  // g0, g1, k, n
  long long c_s[4];  // g0, g1, m, n
  int groups0, groups1, m, n, k;
  int window;         // 0: dense; odd w: the w x w SAME window gather
  int stride;         // gather mode: the convolution's stride
  int height, width;  // gather mode: the input image's rows and columns
  int bf16;           // 0: every operand float32; 1: every operand bfloat16
};

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(u) << 16);  // exact
}

__device__ __forceinline__ void st(float* p, float v) { *p = v; }

__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One step k of every chain a thread owns: acc[i][j] += a[m_i] * b[n_j].
template <int TM, int TN>
__device__ __forceinline__ void fma_step(float (&acc)[TM][TN],
                                         const float* a, const float* b,
                                         int tx, int ty) {
  float av[TM], bv[TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) av[i] = a[ty + 16 * i];
#pragma unroll
  for (int j = 0; j < TN; ++j) bv[j] = b[tx + 16 * j];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
    invariant_matmul_kernel(const Problem p, int tiles_m, int tiles_n) {
  count_device_launch();
  constexpr int TM = BM / 16, TN = BN / 16;
  __shared__ float As[kBK][BM + 1];  // + 1: k-fast stores miss no bank
  __shared__ float Bs[kBK][BN + 1];
  const long long tiles = static_cast<long long>(tiles_m) * tiles_n;
  const long long g = blockIdx.x / tiles;
  const int t = static_cast<int>(blockIdx.x - g * tiles);
  const int g0 = static_cast<int>(g / p.groups1);
  const int g1 = static_cast<int>(g - static_cast<long long>(g0) * p.groups1);
  const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
  const T* A = static_cast<const T*>(p.a) + g0 * p.a_s[0] +
               (p.window ? 0 : g1 * p.a_s[1]);
  const T* B = static_cast<const T*>(p.b) + g0 * p.b_s[0] + g1 * p.b_s[1];
  const T* bias = static_cast<const T*>(p.bias);
  T* C = static_cast<T*>(p.c) + g0 * p.c_s[0] + g1 * p.c_s[1];
  // the coalesced axis of each operand's tile loads
  const bool a_k_fast = p.window == 0 && p.a_s[3] == 1;
  const bool b_k_fast = p.b_s[2] == 1 && p.b_s[3] != 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // gather mode: each tile row's top-left input pixel, each K-tile
  // column's channel offset and window tap (no division in the loads)
  __shared__ int row_s[BM], col_s[BM], dy_s[kBK], dx_s[kBK];
  __shared__ long long off_s[kBK];
  if (p.window) {
    const int out_w = (p.width - 1) / p.stride + 1, r = p.window / 2;
    for (int mm = threadIdx.x; mm < BM; mm += kThreads) {
      const int m = m0 + mm;
      row_s[mm] = m < p.m ? (m / out_w) * p.stride - r : -(1 << 24);
      col_s[mm] = (m % out_w) * p.stride - r;
    }
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < p.k; k0 += kBK) {
    if (p.window) {
      if (threadIdx.x < kBK) {
        const int k = min(k0 + static_cast<int>(threadIdx.x), p.k - 1);
        const int w2 = p.window * p.window, ch = k / w2, tap = k - ch * w2;
        off_s[threadIdx.x] = ch * p.a_s[1];
        dy_s[threadIdx.x] = tap / p.window;
        dx_s[threadIdx.x] = tap % p.window;
      }
      __syncthreads();
      for (int e = threadIdx.x; e < kBK * BM; e += kThreads) {
        const int kk = e / BM, mm = e % BM;
        const int y = row_s[mm] + dy_s[kk], x = col_s[mm] + dx_s[kk];
        As[kk][mm] = (k0 + kk < p.k && y >= 0 && y < p.height && x >= 0 &&
                      x < p.width)
                         ? ld(A + off_s[kk] + y * p.a_s[2] + x * p.a_s[3])
                         : 0.0f;
      }
    } else {
      for (int e = threadIdx.x; e < kBK * BM; e += kThreads) {
        const int kk = a_k_fast ? e % kBK : e / BM;
        const int mm = a_k_fast ? e / kBK : e % BM;
        const int m = m0 + mm, k = k0 + kk;
        As[kk][mm] = (m < p.m && k < p.k)
                         ? ld(A + m * p.a_s[2] + k * p.a_s[3])
                         : 0.0f;
      }
    }
    for (int e = threadIdx.x; e < kBK * BN; e += kThreads) {
      const int kk = b_k_fast ? e % kBK : e / BN;
      const int nn = b_k_fast ? e / kBK : e % BN;
      const int k = k0 + kk, n = n0 + nn;
      Bs[kk][nn] = (k < p.k && n < p.n)
                       ? ld(B + k * p.b_s[2] + n * p.b_s[3])
                       : 0.0f;
    }
    __syncthreads();
    // the chain takes exactly K steps, in order
    if (p.k - k0 >= kBK) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) fma_step(acc, As[kk], Bs[kk], tx, ty);
    } else {
      for (int kk = 0; kk < p.k - k0; ++kk) {
        fma_step(acc, As[kk], Bs[kk], tx, ty);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= p.m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= p.n) continue;
      st(C + m * p.c_s[2] + n * p.c_s[3],
         bias ? acc[i][j] + ld(bias + n) : acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN>
void launch(const Problem& p, cudaStream_t stream) {
  const int tiles_m = (p.m + BM - 1) / BM, tiles_n = (p.n + BN - 1) / BN;
  const long long blocks = static_cast<long long>(p.groups0) * p.groups1 *
                           tiles_m * tiles_n;
  invariant_matmul_kernel<T, BM, BN>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(p, tiles_m,
                                                               tiles_n);
}

// The tile's width: 64 or 96 where N is a multiple of it, else 32 above 16
// columns, else 16; its height 64 from 64 rows on, else 32 above 16.
int tile_n(int n) {
  return n % 64 == 0 ? 64 : (n % 96 == 0 ? 96 : (n > 16 ? 32 : 16));
}
int tile_m(int m) { return m >= 64 ? 64 : (m > 16 ? 32 : 16); }

template <typename T, int BM>
void launch_n(const Problem& p, cudaStream_t s) {
  switch (tile_n(p.n)) {
    case 96: launch<T, BM, 96>(p, s); break;
    case 64: launch<T, BM, 64>(p, s); break;
    case 32: launch<T, BM, 32>(p, s); break;
    default: launch<T, BM, 16>(p, s);
  }
}

template <typename T>
void launch_m(const Problem& p, cudaStream_t s) {
  switch (tile_m(p.m)) {
    case 64: launch_n<T, 64>(p, s); break;
    case 32: launch_n<T, 32>(p, s); break;
    default: launch_n<T, 16>(p, s);
  }
}

}  // namespace

extern "C" int invariant_matmul_launch(const Problem* p, void* stream) {
  const long long blocks_max = 2147483647LL;
  if (!p || !p->a || !p->b || !p->c || p->groups0 < 1 || p->groups1 < 1 ||
      p->m < 1 || p->n < 1 || p->k < 1 || p->window < 0 ||
      (p->bf16 != 0 && p->bf16 != 1) ||
      (p->window && (p->window % 2 == 0 || p->groups1 != 1 ||
                     p->stride < 1 || p->height < 1 || p->width < 1 ||
                     static_cast<long long>((p->height - 1) / p->stride + 1) *
                             ((p->width - 1) / p->stride + 1) != p->m)) ||
      static_cast<long long>(p->groups0) * p->groups1 *
              ((p->m + 15) / 16) * ((p->n + 15) / 16) > blocks_max) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->bf16) {
    launch_m<__nv_bfloat16>(*p, s);
  } else {
    launch_m<float>(*p, s);
  }
  return static_cast<int>(cudaGetLastError());
}

MLIC_DEVICE_LAUNCH_COUNTER(invariant_matmul)
