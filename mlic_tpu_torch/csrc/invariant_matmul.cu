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
// batch.
//
// The contract of every output element, whatever the path or tile:
//
//  * One float32 fmaf chain over k = 0 .. K-1 in that order, started from
//    0.0f; the bias, where there is one, is added after the chain; no
//    split-K, no atomics.  bf16 operands widen exactly to f32 and the
//    result is rounded to bf16 once, to nearest even.
//  * CUDA cores only.  The tensor cores (mma, wgmma) sum their products in
//    the hardware's order and take f32 operands through TF32's 10-bit
//    mantissa: every float, every stream and the rate would change.  So
//    the yardstick is the CUDA cores' 67 TFLOP/s f32 and 3.35 TB/s.
//  * Since each output is one chain in a fixed order, no choice of tile,
//    path, grid or thread mapping can change a float.  The launch
//    therefore follows the problem and the number of problems, and
//    invariant_matmul_oracle_launch -- one thread an output, the plain
//    chain -- is the statement each path is held to bit for bit.
//
// Operands: A is read through strides (dense mode) or, for a "SAME"
// convolution of window w in {1, 3, 5} and stride s, through the window
// gather of an image [channel, row, column] with zero padding (gather
// mode): M = output rows x output columns (each (size - 1) / s + 1), k =
// (channel * w + dy) * w + dx, the order of an OIHW weight flattened.  B
// and C are read and written through strides.  A group index is (g0, g1),
// each with its own stride in A, B and C, so the attention contractions
// run over images x heads in one launch.  f32, or all bf16 (the analysis
// convolutions: the byte path and the halo gather of window 3 only).
//
// Three paths, each a register-blocked SGEMM on the CUDA cores of 256
// threads a block, each thread a TM x TN micro-tile fed by 128-bit (or
// 64-bit) shared loads, K tiles through a ring of three stages filled by
// cp.async (bf16 through registers, widened on the way, two stages), and
// an epilogue through shared memory that stores along C's stride-1 axis:
//
//  * Halo gather (the 5x5 reprojections of the entropy path, f32; the
//    dense encoder's 3x3 convolutions, bf16, strides 1 and 2): a block
//    computes 16 output columns x 4, 8 or 16 rows by 64 or 96 channels,
//    a thread TM consecutive columns of one row.  A K tile is whole
//    channels, each staged once as its input patch (the block's rows and
//    columns plus the window's halo), so each input pixel is copied once a
//    channel instead of w^2 times; for each (channel, dy) a thread loads
//    the patch values of its row once and the w taps read them shifted.
//  * Tiled (dense products: the window fusion, the attention contractions;
//    and the gathers of other windows and strides, which no model sends
//    here): BM x BN tiles from 32 x 32 to 256 x 64 (8 x 8 a thread) by
//    the problem and the number of problems (two blocks an SM).  A problem
//    of whole tiles copies each K tile at addresses that step by a
//    constant, with no checks (the REG instantiation); an operand whose m
//    or n axis is contiguous and 16-byte aligned arrives 16 bytes a copy;
//    the rest 4 bytes an element by a copy plan in shared memory, checked.
//  * Bytes (K <= 4 with C's rows contiguous: g_a's 1x1 convolutions over
//    the image's 3 channels): bound by the output's bytes.  A thread takes
//    8 output pixels, holds their K inputs in registers, and for each
//    output channel runs the 8 chains and stores 8 values along m, 16
//    bytes at a time where aligned.  Nothing is padded to a K tile.
//
// What bounds them on an H100 (tools/sass_census.py reads the hot loops):
// the compute paths issue 73-89% FFMAs in their inner loops and reach
// about 50-65% of the f32 bound; the shared loads a FFMA (1.5 bytes at 8 x
// 4, 1.0 at 8 x 8, 0.7 on the halo path, against the 128 bytes a clock an
// SM reads for its 128 FFMAs) and the copies' address arithmetic are what
// the tile shapes above trade.
//
// Launches on the given stream, allocates nothing, counts its launches on
// the device (the oracle does not) and returns cudaGetLastError().
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
  int window;         // 0: dense; 1, 3 or 5: the w x w SAME window gather
  int stride;         // gather mode: the convolution's stride
  int height, width;  // gather mode: the input image's rows and columns
  int bf16;           // 0: every operand float32; 1: every operand bfloat16
};

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(u) << 16);  // exact
}

__device__ __forceinline__ void st(float* p, float v) { *p = v; }

__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The problem's operands for group g (g0 major), as typed pointers.
template <typename T>
struct Operands {
  const T* a;
  const T* b;
  const T* bias;
  T* c;
  __device__ Operands(const Problem& p, long long g) {
    const int g0 = static_cast<int>(g / p.groups1);
    const int g1 = static_cast<int>(g - static_cast<long long>(g0) *
                                            p.groups1);
    a = static_cast<const T*>(p.a) + g0 * p.a_s[0] +
        (p.window ? 0 : g1 * p.a_s[1]);
    b = static_cast<const T*>(p.b) + g0 * p.b_s[0] + g1 * p.b_s[1];
    bias = static_cast<const T*>(p.bias);
    c = static_cast<T*>(p.c) + g0 * p.c_s[0] + g1 * p.c_s[1];
  }
};

// A[m][k] of one problem by its addressing mode, 0 outside the image.
template <typename T>
__device__ __forceinline__ float a_at(const Problem& p, const T* a, int m,
                                      int k) {
  if (!p.window) return ld(a + m * p.a_s[2] + k * p.a_s[3]);
  const int w = p.window, w2 = w * w, r = w / 2;
  const int out_w = (p.width - 1) / p.stride + 1;
  const int oy = m / out_w, ox = m - oy * out_w;
  const int ch = k / w2, tap = k - ch * w2, dy = tap / w;
  const int y = oy * p.stride - r + dy, x = ox * p.stride - r + tap - dy * w;
  if (y < 0 || y >= p.height || x < 0 || x >= p.width) return 0.0f;
  return ld(a + ch * p.a_s[1] + y * p.a_s[2] + x * p.a_s[3]);
}

// ---------------------------------------------------------------------------
// The chain oracle: one thread an output, the plain fmaf loop.  Not counted.

template <typename T>
__global__ void oracle_kernel(const Problem p) {
  const long long per = static_cast<long long>(p.m) * p.n;
  const long long total = per * p.groups0 * p.groups1;
  const bool m_fast = p.c_s[2] == 1;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long g = i / per;
    const int e = static_cast<int>(i - g * per);
    const int m = m_fast ? e % p.m : e / p.n;
    const int n = m_fast ? e / p.m : e % p.n;
    const Operands<T> o(p, g);
    float acc = 0.0f;
    for (int k = 0; k < p.k; ++k)
      acc = fmaf(a_at(p, o.a, m, k), ld(o.b + k * p.b_s[2] + n * p.b_s[3]),
                 acc);
    st(o.c + m * p.c_s[2] + n * p.c_s[3], o.bias ? acc + ld(o.bias + n) : acc);
  }
}

// ---------------------------------------------------------------------------
// Helpers of the compute paths.

template <int V>
__device__ __forceinline__ void lds(const float* s, float* out) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(s);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else if constexpr (V == 2) {
    const float2 v = *reinterpret_cast<const float2*>(s);
    out[0] = v.x, out[1] = v.y;
  } else {
    out[0] = *s;
  }
}

// f32 staging: a 4-byte asynchronous copy global -> shared, zero-filled
// where `valid` is false (nothing is read then), in commit groups.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// 16 bytes global -> shared, of which the first `bytes` are read and the
// rest zero-filled
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

// A K tile's rows of R floats that are contiguous in global memory (an
// operand whose m or n axis has stride 1), 16 bytes a copy: row kk of the
// tile from src + kk * ks into dst + kk * LD, zero past `k_n` rows and
// past `r_left` floats of a row.
template <int R, int LD, int BK>
__device__ __forceinline__ void copy_rows16(float* dst, const float* src,
                                            long long ks, int k_n,
                                            int r_left) {
  constexpr int Q = R / 4;
#pragma unroll
  for (int i = 0; i < (BK * Q + kThreads - 1) / kThreads; ++i) {
    const int c = static_cast<int>(threadIdx.x) + i * kThreads;
    if ((i + 1) * kThreads > BK * Q && c >= BK * Q) break;
    const int kk = c / Q, r = (c % Q) * 4;
    const int left = kk < k_n ? r_left - r : 0;
    const int bytes = left >= 4 ? 16 : (left > 0 ? 4 * left : 0);
    cp_async16(dst + kk * LD + r, src + (bytes ? kk * ks + r : 0), bytes);
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A BM x BN block tile of 256 threads, TM x TN outputs a thread, K tiles
// of depth BK.  Thread (tx, ty) owns rows ty*VM + i (+ TY*VM per group of
// VM) and columns tx*VN + j likewise, so its shared loads are VM- and
// VN-wide vectors.  The tiled kernel stages through a ring of three
// stages filled by cp.async.
template <int BM_, int BN_, int TM_, int TN_, int BK_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, BK = BK_;
  static constexpr int TX = BN / TN, TY = BM / TM;
  static_assert(TX * TY == kThreads, "256 threads a block");
  static constexpr int VM = TM % 4 == 0 ? 4 : (TM % 2 == 0 ? 2 : 1);
  static constexpr int VN = TN % 4 == 0 ? 4 : (TN % 2 == 0 ? 2 : 1);
  static constexpr int LDA = BM + 4, LDB = BN + 4;  // rows stay 16B-aligned
  static constexpr int EA = (BK * BM + kThreads - 1) / kThreads;
  static constexpr int EB = (BK * BN + kThreads - 1) / kThreads;
  static constexpr int kStage = BK * (LDA + LDB);
  static constexpr int kEpilogue =
      BN * (BM + 4) > BM * (BN + 4) ? BN * (BM + 4) : BM * (BN + 4);

  // each thread's copy plan of a K tile, in shared memory after the
  // stages: A's source offsets [EA][256] (the destination steps by a
  // constant), B's (source, destination) pairs [EB][256]
  static constexpr int kPlanBytes = EA * kThreads * 4 + EB * kThreads * 8;
  static constexpr int kStages = 3;
  static constexpr int kSmemBytes =
      4 * kStages * kStage + kPlanBytes > 4 * kEpilogue
          ? 4 * kStages * kStage + kPlanBytes
          : 4 * kEpilogue;
  static __device__ __forceinline__ int row(int i, int ty) {
    return (i / VM) * (TY * VM) + ty * VM + i % VM;
  }
  static __device__ __forceinline__ int col(int j, int tx) {
    return (j / VN) * (TX * VN) + tx * VN + j % VN;
  }
};

// One step k of every chain a thread owns: acc[i][j] += a[m_i] * b[n_j].
template <class L>
__device__ __forceinline__ void fma_step(float (&acc)[L::TM][L::TN],
                                         const float* as, const float* bs,
                                         int tx, int ty) {
  float av[L::TM], bv[L::TN];
#pragma unroll
  for (int i = 0; i < L::TM; i += L::VM)
    lds<L::VM>(as + L::row(i, ty), av + i);
#pragma unroll
  for (int j = 0; j < L::TN; j += L::VN)
    lds<L::VN>(bs + L::col(j, tx), bv + j);
#pragma unroll
  for (int i = 0; i < L::TM; ++i)
#pragma unroll
    for (int j = 0; j < L::TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// One K tile of the chains, in order: all BK steps, or the ragged last.
template <class L>
__device__ __forceinline__ void fma_tile(float (&acc)[L::TM][L::TN],
                                         const float* as, int steps, int tx,
                                         int ty) {
  const float* bs = as + L::BK * L::LDA;
  if (steps == L::BK) {
#pragma unroll
    for (int kk = 0; kk < L::BK; ++kk)
      fma_step<L>(acc, as + kk * L::LDA, bs + kk * L::LDB, tx, ty);
  } else {
    for (int kk = 0; kk < steps; ++kk)
      fma_step<L>(acc, as + kk * L::LDA, bs + kk * L::LDB, tx, ty);
  }
}

// The tiled kernel, f32: dense products and the gathers off the halo path.
// REG: M, N and K are whole numbers of tiles and the copies step by a
// constant (dense only): element i of a K tile's A is at a_off + i a_inc,
// of B at b_off + i b_inc, with no checks and no plan.  Otherwise vec
// (bit 0: A's m axis is contiguous and 16-byte aligned, dense only; bit
// 1: B's n axis) sends an operand's K tiles 16 bytes a copy, and the rest
// copy 4 bytes an element by the plan, with checks.
template <class L, int W, bool REG>
__global__ void __launch_bounds__(kThreads, 2)
    invariant_matmul_kernel(const Problem p, int tiles_m, int tiles_n,
                            int vec) {
  static_assert(!REG || W == 0, "REG is dense");
  count_device_launch();
  constexpr int BM = L::BM, BN = L::BN, BK = L::BK, EA = L::EA, EB = L::EB;
  constexpr int S = L::kStages, W2 = W * W;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int* a_plan = reinterpret_cast<int*>(smem + S * L::kStage);
  int2* b_plan = reinterpret_cast<int2*>(a_plan + EA * kThreads);
  const long long tiles = static_cast<long long>(tiles_m) * tiles_n;
  const long long g = blockIdx.x / tiles;
  const int t = static_cast<int>(blockIdx.x - g * tiles);
  const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
  const Operands<float> o(p, g);
  const int tid = threadIdx.x, tx = tid % L::TX, ty = tid / L::TX;
  const int n_tiles = (p.k + BK - 1) / BK;

  // Staging element i of a K tile is e = tid + 256 i.  A is k-fast where
  // its k axis is contiguous (dense), else m-fast, so element i sits at
  // (ka + i dka, ma + i dma) of the tile.  B is k-fast where its k axis is
  // contiguous (a weight [N][K]), else n-fast.  The plan holds each
  // element's source offset from the operand's tile-0 base, which holds
  // for the whole chain (-1: zero -- outside the image, past M or N), the
  // gather's K tile being BK / W^2 whole channels; B's with its
  // destination.
  const bool a_k_fast = W == 0 && p.a_s[3] == 1;
  const bool b_kf = p.b_s[2] == 1 && p.b_s[3] != 1;
  const int ka = a_k_fast ? tid % BK : tid / BM;
  const int ma = a_k_fast ? tid / BK : tid % BM;
  const int dka = a_k_fast ? 0 : kThreads / BM;
  const int dma = a_k_fast ? kThreads / BK : 0;
  const int a_dst = ka * L::LDA + ma, a_ddst = dka * L::LDA + dma;
  if constexpr (!REG) {
    int y0 = 0, x0 = 0;
    if constexpr (W > 0) {
      const int out_w = (p.width - 1) / p.stride + 1, m = m0 + ma;
      const int oy = m / out_w;
      y0 = oy * p.stride - W / 2;
      x0 = (m - oy * out_w) * p.stride - W / 2;
    }
#pragma unroll
    for (int i = 0; i < EA; ++i) {
      const int kk = ka + i * dka, mm = ma + i * dma;
      int off = -1;
      if (tid + i * kThreads < BK * BM && m0 + mm < p.m) {
        if constexpr (W > 0) {
          const int tap = kk % W2, y = y0 + tap / W, x = x0 + tap % W;
          if (y >= 0 && y < p.height && x >= 0 && x < p.width)
            off = static_cast<int>((kk / W2) * p.a_s[1] + y * p.a_s[2] +
                                   x * p.a_s[3]);
        } else {
          off = static_cast<int>(mm * p.a_s[2] + kk * p.a_s[3]);
        }
      }
      a_plan[i * kThreads + tid] = off;
    }
#pragma unroll
    for (int i = 0; i < EB; ++i) {
      const int e = tid + i * kThreads;
      const int kk = b_kf ? e % BK : e / BN;
      const int nn = b_kf ? e / BK : e % BN;
      const bool v = e < BK * BN && n0 + nn < p.n;
      b_plan[i * kThreads + tid] = make_int2(
          v ? static_cast<int>(kk * p.b_s[2] + nn * p.b_s[3]) : -1,
          BK * L::LDA + kk * L::LDB + nn);
    }
    __syncthreads();
  }
  const float* a_tile = W > 0 ? o.a : o.a + m0 * p.a_s[2];
  const long long a_step = W > 0 ? (BK / W2) * p.a_s[1] : BK * p.a_s[3];
  const float* b_tile = o.b + n0 * p.b_s[3];
  const long long b_step = BK * p.b_s[2];
  // element i exists in the tile (the last may not, for every thread)
  auto has_a = [&](int i) {
    return (i + 1) * kThreads <= BK * BM || tid + i * kThreads < BK * BM;
  };
  auto has_b = [&](int i) {
    return (i + 1) * kThreads <= BK * BN || tid + i * kThreads < BK * BN;
  };

  float acc[L::TM][L::TN];
#pragma unroll
  for (int i = 0; i < L::TM; ++i)
#pragma unroll
    for (int j = 0; j < L::TN; ++j) acc[i][j] = 0.0f;

  // a ring of S stages filled by cp.async: tile + S - 1 is copied while
  // tile is computed
  auto copy_in = [&](int tile) {
    float* stage = smem + (tile % S) * L::kStage;
    const float* a = a_tile + tile * a_step;
    const float* b = b_tile + tile * b_step;
    if constexpr (REG) {
      const int a_off = static_cast<int>(ma * p.a_s[2] + ka * p.a_s[3]);
      const int a_inc = static_cast<int>(dma * p.a_s[2] + dka * p.a_s[3]);
      const int kb = b_kf ? tid % BK : tid / BN;
      const int nb = b_kf ? tid / BK : tid % BN;
      const int b_off = static_cast<int>(kb * p.b_s[2] + nb * p.b_s[3]);
      const int b_inc = static_cast<int>(b_kf ? kThreads / BK * p.b_s[3]
                                              : kThreads / BN * p.b_s[2]);
      const int b_dst = BK * L::LDA + kb * L::LDB + nb;
      const int b_dinc = b_kf ? kThreads / BK : kThreads / BN * L::LDB;
#pragma unroll
      for (int i = 0; i < EA; ++i)
        cp_async4(stage + a_dst + i * a_ddst, a + (a_off + i * a_inc));
#pragma unroll
      for (int i = 0; i < EB; ++i)
        cp_async4(stage + b_dst + i * b_dinc, b + (b_off + i * b_inc));
    } else {
      const int k_left = p.k - tile * BK;
      if (vec & 1) {
        copy_rows16<BM, L::LDA, BK>(stage, a, p.a_s[3], k_left, p.m - m0);
      } else {
#pragma unroll
        for (int i = 0; i < EA; ++i) {
          if (!has_a(i)) continue;
          const int off = a_plan[i * kThreads + tid];
          const bool v = off >= 0 && ka + i * dka < k_left;
          cp_async4(stage + a_dst + i * a_ddst, a + (v ? off : 0), v);
        }
      }
      if (vec & 2) {
        copy_rows16<BN, L::LDB, BK>(stage + BK * L::LDA, b, p.b_s[2], k_left,
                                    p.n - n0);
      } else {
#pragma unroll
        for (int i = 0; i < EB; ++i) {
          if (!has_b(i)) continue;
          const int2 pl = b_plan[i * kThreads + tid];
          // past K (a ragged last tile) is 0
          const bool v = pl.x >= 0 &&
                         (k_left >= BK ||
                          (pl.y - BK * L::LDA) / L::LDB < k_left);
          cp_async4(stage + pl.y, b + (v ? pl.x : 0), v);
        }
      }
    }
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < n_tiles) copy_in(s);
    cp_commit();
  }
  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_wait<S - 2>();
    // tile has landed; every thread is past tile - 1, whose stage the next
    // copy refills
    __syncthreads();
    if (tile + S - 1 < n_tiles) copy_in(tile + S - 1);
    cp_commit();
    // the chain takes exactly K steps, in order
    fma_tile<L>(acc, smem + (tile % S) * L::kStage, min(BK, p.k - tile * BK),
                tx, ty);
  }
  cp_wait<0>();
  __syncthreads();

  // epilogue: the tile through shared memory, stored along C's stride-1
  // axis (m for an NCHW convolution output, else n)
  const bool m_fast = p.c_s[2] == 1;
#pragma unroll
  for (int i = 0; i < L::TM; ++i)
#pragma unroll
    for (int j = 0; j < L::TN; ++j) {
      const int mm = L::row(i, ty), nn = L::col(j, tx);
      smem[m_fast ? nn * (BM + 4) + mm : mm * (BN + 4) + nn] = acc[i][j];
    }
  __syncthreads();
  for (int e = tid; e < BM * BN; e += kThreads) {
    const int mm = m_fast ? e % BM : e / BN;
    const int nn = m_fast ? e / BM : e % BN;
    const int m = m0 + mm, n = n0 + nn;
    if (m >= p.m || n >= p.n) continue;
    const float v = smem[m_fast ? nn * (BM + 4) + mm : mm * (BN + 4) + nn];
    st(o.c + m * p.c_s[2] + n * p.c_s[3], o.bias ? v + ld(o.bias + n) : v);
  }
}

// ---------------------------------------------------------------------------
// Halo gather: a "SAME" convolution of window W and stride S whose output
// is NCHW.  A block computes RH x RW outputs of one image (RW = 16
// columns) by BN channels; each thread TM consecutive columns of one row
// by TN channels.  A K tile is CB whole channels: each channel's input
// patch (PH rows of PWU pixels, row pitch PW) and the CB * W^2 x BN
// weights.  For each (channel, dy) a thread loads the NA patch values its
// row needs once, and the W taps dx read them at i * S + dx.
template <class L, int W, int S>
struct Halo {
  static constexpr int W2 = W * W, CB = (16 + W2 - 1) / W2, BK = CB * W2;
  static_assert(L::BK == BK, "a K tile of whole channels");
  static constexpr int RW = 16, XG = RW / L::TM, RH = L::TY / XG;
  static_assert(XG * RH == L::TY, "the thread rows tile the block");
  static constexpr int PH = (RH - 1) * S + W, PWU = (RW - 1) * S + W;
  static constexpr int PW = (PWU + 3) / 4 * 4;
  static constexpr int NA = ((L::TM - 1) * S + W + 3) / 4 * 4;
  static_assert((RW - L::TM) * S + NA <= PW, "window loads stay in a row");
  static constexpr int PATCH = PH * PW;
  static constexpr int PE = (CB * PH * PWU + kThreads - 1) / kThreads;
  static constexpr int kStage = CB * PATCH + BK * L::LDB;
  static constexpr int kPlanBytes = L::EB * kThreads * 8;
  template <typename T>
  __host__ __device__ static constexpr int stages() {
    return sizeof(T) == 4 ? 3 : 2;
  }
  template <typename T>
  __host__ __device__ static constexpr int smem_bytes() {
    return 4 * stages<T>() * kStage + kPlanBytes > 4 * L::kEpilogue
               ? 4 * stages<T>() * kStage + kPlanBytes
               : 4 * L::kEpilogue;
  }
};

// Every K tile is full (K = C * W^2 with C a multiple of CB) and every
// column tile too (N a multiple of BN): the launch sends nothing else.
template <typename T, class L, int W, int S>
__global__ void __launch_bounds__(kThreads, 2)
    invariant_matmul_kernel_halo(const Problem p, int tiles_x, int tiles_y,
                                 int tiles_n) {
  count_device_launch();
  using H = Halo<L, W, S>;
  constexpr int BM = L::BM, BN = L::BN, TM = L::TM, TN = L::TN, BK = H::BK;
  constexpr int CB = H::CB, EB = L::EB, NS = H::template stages<T>();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int2* b_plan = reinterpret_cast<int2*>(smem + NS * H::kStage);
  // the column tiles of one patch are neighbours in the grid
  int blk = static_cast<int>(blockIdx.x);
  const int bn = blk % tiles_n;
  blk /= tiles_n;
  const int bx = blk % tiles_x;
  blk /= tiles_x;
  const int by = blk % tiles_y;
  const Operands<T> o(p, blk / tiles_y);
  const int out_h = (p.height - 1) / S + 1, out_w = (p.width - 1) / S + 1;
  const int oy0 = by * H::RH, ox0 = bx * H::RW, n0 = bn * BN;
  const int tid = threadIdx.x, tx = tid % L::TX, ty = tid / L::TX;
  const int gy = ty / H::XG, lx = (ty % H::XG) * TM;
  const int n_tiles = p.k / BK;

  // the patch copy plan, in registers: element i of a K tile's patches is
  // e = tid + 256 i, at (channel, row, column) of the tile's patches;
  // source offset -1 outside the image (zero-filled), destination -1 past
  // the patches
  int p_src[H::PE], p_dst[H::PE];
  {
    const int iy0 = oy0 * S - W / 2, ix0 = ox0 * S - W / 2;
#pragma unroll
    for (int i = 0; i < H::PE; ++i) {
      const int e = tid + i * kThreads;
      const int cl = e / (H::PH * H::PWU), r = e - cl * (H::PH * H::PWU);
      const int q = r / H::PWU, pp = r - q * H::PWU;
      const int y = iy0 + q, x = ix0 + pp;
      const bool in = e < CB * H::PH * H::PWU;
      p_dst[i] = in ? cl * H::PATCH + q * H::PW + pp : -1;
      p_src[i] = in && y >= 0 && y < p.height && x >= 0 && x < p.width
                     ? static_cast<int>(cl * p.a_s[1] + y * p.a_s[2] +
                                        x * p.a_s[3])
                     : -1;
    }
    const bool b_k_fast = p.b_s[2] == 1 && p.b_s[3] != 1;
#pragma unroll
    for (int i = 0; i < EB; ++i) {
      const int e = tid + i * kThreads;
      const int kk = b_k_fast ? e % BK : e / BN;
      const int nn = b_k_fast ? e / BK : e % BN;
      b_plan[i * kThreads + tid] = make_int2(
          static_cast<int>(kk * p.b_s[2] + nn * p.b_s[3]),
          CB * H::PATCH + kk * L::LDB + nn);
    }
  }
  __syncthreads();
  const T* b_tile = o.b + n0 * p.b_s[3];
  const long long a_step = CB * p.a_s[1], b_step = BK * p.b_s[2];
  auto has_b = [&](int i) {
    return (i + 1) * kThreads <= BK * BN || tid + i * kThreads < BK * BN;
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  // one K tile of every chain the thread owns, k = (channel W + dy) W + dx
  // in order
  auto compute = [&](const float* stage) {
    const float* bs = stage + CB * H::PATCH;
#pragma unroll
    for (int cl = 0; cl < CB; ++cl)
#pragma unroll
      for (int dy = 0; dy < W; ++dy) {
        float av[H::NA];
        const float* ap =
            stage + cl * H::PATCH + (gy * S + dy) * H::PW + lx * S;
#pragma unroll
        for (int v = 0; v < H::NA; v += 4) lds<4>(ap + v, av + v);
#pragma unroll
        for (int dx = 0; dx < W; ++dx) {
          const float* b = bs + ((cl * W + dy) * W + dx) * L::LDB;
          float bv[TN];
#pragma unroll
          for (int j = 0; j < TN; j += L::VN)
            lds<L::VN>(b + L::col(j, tx), bv + j);
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = fmaf(av[i * S + dx], bv[j], acc[i][j]);
        }
      }
  };

  if constexpr (sizeof(T) == 4) {
    auto copy_in = [&](int tile) {
      float* stage = smem + (tile % NS) * H::kStage;
      const T* a = o.a + tile * a_step;
      const T* b = b_tile + tile * b_step;
#pragma unroll
      for (int i = 0; i < H::PE; ++i)
        if (p_dst[i] >= 0)
          cp_async4(stage + p_dst[i], a + (p_src[i] >= 0 ? p_src[i] : 0),
                    p_src[i] >= 0);
#pragma unroll
      for (int i = 0; i < EB; ++i)
        if (has_b(i)) {
          const int2 pl = b_plan[i * kThreads + tid];
          cp_async4(stage + pl.y, b + pl.x);
        }
    };
#pragma unroll
    for (int s = 0; s < NS - 1; ++s) {
      if (s < n_tiles) copy_in(s);
      cp_commit();
    }
    for (int tile = 0; tile < n_tiles; ++tile) {
      cp_wait<NS - 2>();
      __syncthreads();
      if (tile + NS - 1 < n_tiles) copy_in(tile + NS - 1);
      cp_commit();
      compute(smem + (tile % NS) * H::kStage);
    }
    cp_wait<0>();
  } else {
    // bf16: global -> registers (widened) -> shared, two stages
    float ra[H::PE], rb[EB];
    auto fetch = [&](int tile) {
      const T* a = o.a + tile * a_step;
      const T* b = b_tile + tile * b_step;
#pragma unroll
      for (int i = 0; i < H::PE; ++i)
        ra[i] = p_src[i] >= 0 ? ld(a + p_src[i]) : 0.0f;
#pragma unroll
      for (int i = 0; i < EB; ++i)
        rb[i] = has_b(i) ? ld(b + b_plan[i * kThreads + tid].x) : 0.0f;
    };
    auto deposit = [&](int tile) {
      float* stage = smem + (tile & 1) * H::kStage;
#pragma unroll
      for (int i = 0; i < H::PE; ++i)
        if (p_dst[i] >= 0) stage[p_dst[i]] = ra[i];
#pragma unroll
      for (int i = 0; i < EB; ++i)
        if (has_b(i)) stage[b_plan[i * kThreads + tid].y] = rb[i];
    };
    fetch(0);
    deposit(0);
    __syncthreads();
    for (int tile = 0; tile < n_tiles; ++tile) {
      const bool more = tile + 1 < n_tiles;
      if (more) fetch(tile + 1);
      compute(smem + (tile & 1) * H::kStage);
      if (more) deposit(tile + 1);
      __syncthreads();
    }
  }
  __syncthreads();

  // epilogue: the tile through shared memory, stored along the output rows
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      smem[L::col(j, tx) * (BM + 4) + gy * H::RW + lx + i] = acc[i][j];
  __syncthreads();
  for (int e = tid; e < BM * BN; e += kThreads) {
    const int mm = e % BM, nn = e / BM;
    const int y = oy0 + mm / H::RW, x = ox0 + mm % H::RW;
    if (y >= out_h || x >= out_w) continue;
    const float v = smem[nn * (BM + 4) + mm];
    st(o.c + (y * out_w + x) + (n0 + nn) * p.c_s[3],
       o.bias ? v + ld(o.bias + n0 + nn) : v);
  }
}

// ---------------------------------------------------------------------------
// Byte path: K <= kByteK, C's m axis contiguous.

constexpr int kPix = 8;  // output pixels a thread
constexpr int kByteK = 4;

__device__ __forceinline__ void st8(float* c, const float (&v)[kPix]) {
  if ((reinterpret_cast<unsigned long long>(c) & 15) == 0) {
    reinterpret_cast<float4*>(c)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(c)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int i = 0; i < kPix; ++i) c[i] = v[i];
  }
}

// two values rounded to bf16 (to nearest even, as st), the first low
__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

__device__ __forceinline__ void st8(__nv_bfloat16* c, const float (&v)[kPix]) {
  if ((reinterpret_cast<unsigned long long>(c) & 15) == 0) {
    *reinterpret_cast<uint4*>(c) =
        make_uint4(bf16x2(v[0], v[1]), bf16x2(v[2], v[3]),
                   bf16x2(v[4], v[5]), bf16x2(v[6], v[7]));
  } else {
#pragma unroll
    for (int i = 0; i < kPix; ++i) st(c + i, v[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    invariant_matmul_kernel_bytes(const Problem p, int chunks) {
  const int K = p.k;
  count_device_launch();
  extern __shared__ float4 smem4[];
  float* w = reinterpret_cast<float*>(smem4);  // [N][K], widened
  float* bias_s = w + p.n * K;
  const long long g = blockIdx.x / chunks;
  const int chunk = static_cast<int>(blockIdx.x - g * chunks);
  const Operands<T> o(p, g);
  for (int e = threadIdx.x; e < p.n * K; e += kThreads) {
    const int n = e / K, k = e - n * K;
    w[e] = ld(o.b + k * p.b_s[2] + n * p.b_s[3]);
  }
  for (int n = threadIdx.x; n < p.n; n += kThreads)
    bias_s[n] = o.bias ? ld(o.bias + n) : 0.0f;
  __syncthreads();
  const int m0 = (chunk * kThreads + static_cast<int>(threadIdx.x)) * kPix;
  if (m0 >= p.m) return;
  float a[kPix][kByteK];
#pragma unroll
  for (int v = 0; v < kPix; ++v)
#pragma unroll
    for (int k = 0; k < kByteK; ++k)
      a[v][k] = k < K && m0 + v < p.m ? a_at(p, o.a, m0 + v, k) : 0.0f;
  for (int n = 0; n < p.n; ++n) {
    float out[kPix];
#pragma unroll
    for (int v = 0; v < kPix; ++v) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kByteK; ++k)
        if (k < K) acc = fmaf(a[v][k], w[n * K + k], acc);
      out[v] = o.bias ? acc + bias_s[n] : acc;
    }
    T* c = o.c + m0 + n * p.c_s[3];
    if (m0 + kPix <= p.m) {
      st8(c, out);
    } else {
#pragma unroll
      for (int v = 0; v < kPix; ++v)
        if (m0 + v < p.m) st(c + v, out[v]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch.

// cudaFuncSetAttribute for a kernel's dynamic shared memory, once a device
template <auto Kernel>
int allow_smem(int bytes) {
  static unsigned long long sized = 0;  // devices
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64 || !(sized >> dev & 1)) {
    e = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) sized |= 1ull << dev;
  }
  return 0;
}

int grid(long long blocks) {
  return blocks > 2147483647LL ? -1 : static_cast<int>(blocks);
}

bool aligned16(const void* ptr, const long long (&s)[4], int contiguous) {
  if (reinterpret_cast<unsigned long long>(ptr) & 15) return false;
  for (int i = 0; i < 4; ++i)
    if (i != contiguous && s[i] % 4) return false;
  return s[contiguous] == 1;
}

template <class L, int W, bool REG = false>
int launch_tiles(const Problem& p, cudaStream_t stream) {
  constexpr int smem = L::kSmemBytes;
  if (const int e = allow_smem<invariant_matmul_kernel<L, W, REG>>(smem))
    return e;
  const int tiles_m = (p.m + L::BM - 1) / L::BM;
  const int tiles_n = (p.n + L::BN - 1) / L::BN;
  const int blocks = grid(static_cast<long long>(p.groups0) * p.groups1 *
                          tiles_m * tiles_n);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte copies of an operand whose m (n) axis is contiguous (dense)
  const int vec = W == 0 ? int(aligned16(p.a, p.a_s, 2)) |
                               int(aligned16(p.b, p.b_s, 3)) << 1
                         : 0;
  invariant_matmul_kernel<L, W, REG>
      <<<blocks, kThreads, smem, stream>>>(p, tiles_m, tiles_n, vec);
  return 0;
}

// A dense problem of whole tiles whose copies step by a constant, with no
// 16-byte copies to lose: the tiled kernel's REG instantiation.
template <class L>
bool regular(const Problem& p) {
  const bool b_affine =
      (p.b_s[2] == 1 && p.b_s[3] != 1) || kThreads % L::BN == 0;
  return p.m % L::BM == 0 && p.n % L::BN == 0 && p.k % L::BK == 0 &&
         b_affine && !aligned16(p.a, p.a_s, 2) && !aligned16(p.b, p.b_s, 3);
}

template <typename T, class L, int W, int S>
int launch_halo(const Problem& p, cudaStream_t stream) {
  using H = Halo<L, W, S>;
  constexpr int smem = H::template smem_bytes<T>();
  if (const int e = allow_smem<invariant_matmul_kernel_halo<T, L, W, S>>(smem))
    return e;
  const int tiles_y = ((p.height - 1) / S + H::RH) / H::RH;
  const int tiles_x = ((p.width - 1) / S + H::RW) / H::RW;
  const int tiles_n = p.n / L::BN;
  const int blocks = grid(static_cast<long long>(p.groups0) * tiles_y *
                          tiles_x * tiles_n);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  invariant_matmul_kernel_halo<T, L, W, S>
      <<<blocks, kThreads, smem, stream>>>(p, tiles_x, tiles_y, tiles_n);
  return 0;
}

template <typename T>
int launch_bytes(const Problem& p, cudaStream_t stream) {
  const int chunks = (p.m + kThreads * kPix - 1) / (kThreads * kPix);
  const int blocks =
      grid(static_cast<long long>(p.groups0) * p.groups1 * chunks);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(p.n) * (p.k + 1) * sizeof(float);
  invariant_matmul_kernel_bytes<T>
      <<<blocks, kThreads, smem, stream>>>(p, chunks);
  return 0;
}

// The column tile: 64 or 96 where N is a multiple of it, else 0.
int tile_n(int n) { return n % 64 == 0 ? 64 : (n % 96 == 0 ? 96 : 0); }

// 128 rows where the group then has two blocks an SM of 132, else 64
bool tall(long long blocks_of_128) { return blocks_of_128 >= 2 * 132; }


// The paths and their shapes, one rule for valid() and launch():
//  * bytes: K <= kByteK with C's m axis contiguous (the weights fit 48 KB);
//  * halo: window 5 of stride 1 (f32) or window 3 of stride 1 or 2 (bf16),
//    NCHW output, C a multiple of CB and N of a column tile;
//  * tiles: dense and the other f32 gathers (windows 1, 3, 5).
// bf16 takes the byte path and the halo gather of window 3 only: the
// analysis transforms' products.
bool takes_bytes(const Problem& p) {
  return p.k <= kByteK && p.c_s[2] == 1 &&
         static_cast<long long>(p.n) * (p.k + 1) * 4 <= 48 * 1024;
}

bool takes_halo(const Problem& p) {
  const int w = p.window, w2 = w * w, bk = w2 * ((16 + w2 - 1) / w2);
  return w == (p.bf16 ? 3 : 5) &&
         (p.stride == 1 || (p.bf16 && p.stride == 2)) &&
         p.c_s[2] == 1 && p.groups1 == 1 && p.k % bk == 0 &&
         (p.bf16 ? p.n % 64 == 0 : tile_n(p.n) > 0);
}

template <typename T, int W, int S>
int launch_halo_tiles(const Problem& p, cudaStream_t s) {
  constexpr int BK = W * W * ((16 + W * W - 1) / (W * W));
  const int bn = sizeof(T) == 2 ? 64 : tile_n(p.n);
  // blocks of 128 and of 256 outputs (8 and 16 rows of 16)
  const long long cols = static_cast<long long>(p.groups0) *
                         ((p.width - 1) / S / 16 + 1) * (p.n / bn);
  const long long per_128 = cols * ((p.height - 1) / S / 8 + 1);
  const long long per_256 = cols * ((p.height - 1) / S / 16 + 1);
  if constexpr (sizeof(T) == 4)
    if (bn == 96)
      return tall(per_128)
                 ? launch_halo<T, Tile<128, 96, 8, 6, BK>, W, S>(p, s)
                 : launch_halo<T, Tile<64, 96, 4, 6, BK>, W, S>(p, s);
  if constexpr (S == 1)
    if (tall(per_256))
      return launch_halo<T, Tile<256, 64, 8, 8, BK>, W, S>(p, s);
  return tall(per_128) ? launch_halo<T, Tile<128, 64, 8, 4, BK>, W, S>(p, s)
                       : launch_halo<T, Tile<64, 64, 4, 4, BK>, W, S>(p, s);
}

// f32 gathers off the halo path (no model's): 32 x 32 tiles, a K tile of
// whole channels, W^2 * ceil(16 / W^2)
template <int W>
int launch_gather(const Problem& p, cudaStream_t s) {
  constexpr int BK = W * W * ((16 + W * W - 1) / (W * W));
  return launch_tiles<Tile<32, 32, 2, 2, BK>, W>(p, s);
}

// dense f32: BN 64 or 96 where N is a multiple of it, else 32 (the
// attention contractions; a K tile of 64 where M is short too).  A regular
// problem takes 256 rows at BN 64 where the group then has two blocks an
// SM, else 128 where it does, else 64; any other one 64 rows.
int launch_dense(const Problem& p, cudaStream_t s) {
  const int bn = tile_n(p.n);
  if (bn == 0)
    return p.m >= 128 ? launch_tiles<Tile<128, 32, 8, 2, 16>, 0>(p, s)
                      : launch_tiles<Tile<32, 32, 2, 2, 64>, 0>(p, s);
  const long long cols = static_cast<long long>(p.groups0) * p.groups1 *
                         (p.n / bn);
  const bool t128 = tall(cols * ((p.m + 127) / 128));
  if (bn == 96) {
    using T128 = Tile<128, 96, 8, 6, 16>;
    using T64 = Tile<64, 96, 4, 6, 16>;
    if (t128 && regular<T128>(p)) return launch_tiles<T128, 0, true>(p, s);
    if (regular<T64>(p)) return launch_tiles<T64, 0, true>(p, s);
    return launch_tiles<T64, 0>(p, s);
  }
  using T256 = Tile<256, 64, 8, 8, 16>;
  using T128 = Tile<128, 64, 8, 4, 16>;
  using T64 = Tile<64, 64, 4, 4, 16>;
  if (tall(cols * ((p.m + 255) / 256)) && regular<T256>(p))
    return launch_tiles<T256, 0, true>(p, s);
  if (t128 && regular<T128>(p)) return launch_tiles<T128, 0, true>(p, s);
  if (regular<T64>(p)) return launch_tiles<T64, 0, true>(p, s);
  return launch_tiles<T64, 0>(p, s);
}

int launch(const Problem& p, cudaStream_t s) {
  if (takes_bytes(p))
    return p.bf16 ? launch_bytes<__nv_bfloat16>(p, s)
                  : launch_bytes<float>(p, s);
  if (takes_halo(p)) {
    if (p.bf16)
      return p.stride == 1 ? launch_halo_tiles<__nv_bfloat16, 3, 1>(p, s)
                           : launch_halo_tiles<__nv_bfloat16, 3, 2>(p, s);
    return launch_halo_tiles<float, 5, 1>(p, s);
  }
  switch (p.window) {
    case 0: return launch_dense(p, s);
    case 1: return launch_gather<1>(p, s);
    case 3: return launch_gather<3>(p, s);
    default: return launch_gather<5>(p, s);
  }
}

bool fits_int(long long v) { return v >= 0 && v < 2147483647LL; }

// The shapes and strides the paths take.
bool valid(const Problem* p) {
  if (!p || !p->a || !p->b || !p->c || p->groups0 < 1 || p->groups1 < 1 ||
      p->m < 1 || p->n < 1 || p->k < 1 || (p->bf16 != 0 && p->bf16 != 1))
    return false;
  for (int i = 0; i < 4; ++i)
    if (p->a_s[i] < 0 || p->b_s[i] < 0 || p->c_s[i] < 0) return false;
  // the copy plans' offsets inside a K tile are 32-bit
  if (!fits_int(64 * p->b_s[2] + 128 * p->b_s[3])) return false;
  if (!p->window)
    return (!p->bf16 || takes_bytes(*p)) &&
           fits_int(256 * p->a_s[2] + 64 * p->a_s[3]);
  const int w = p->window;
  return (w == 1 || w == 3 || w == 5) && p->groups1 == 1 && p->stride >= 1 &&
         p->height >= 1 && p->width >= 1 &&
         static_cast<long long>((p->height - 1) / p->stride + 1) *
                 ((p->width - 1) / p->stride + 1) == p->m &&
         fits_int(16 * p->a_s[1] + p->height * p->a_s[2] +
                  p->width * p->a_s[3]) &&
         (!p->bf16 || takes_bytes(*p) || takes_halo(*p));
}

}  // namespace

extern "C" int invariant_matmul_launch(const Problem* p, void* stream) {
  if (!valid(p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = launch(*p, s);
  return rc ? rc : static_cast<int>(cudaGetLastError());
}

// The chain oracle on the same Problem: what every path above must equal
// bit for bit.  Not counted on the device, and called by no module of the
// port (chip_smoke.py holds K8 to it).
extern "C" int invariant_matmul_oracle_launch(const Problem* p,
                                              void* stream) {
  if (!valid(p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total =
      static_cast<long long>(p->m) * p->n * p->groups0 * p->groups1;
  const long long want = (total + 255) / 256;
  const unsigned blocks =
      static_cast<unsigned>(want < 132 * 64 ? want : 132 * 64);
  if (p->bf16) {
    oracle_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(*p);
  } else {
    oracle_kernel<float><<<blocks, 256, 0, s>>>(*p);
  }
  return static_cast<int>(cudaGetLastError());
}

MLIC_DEVICE_LAUNCH_COUNTER(invariant_matmul)
