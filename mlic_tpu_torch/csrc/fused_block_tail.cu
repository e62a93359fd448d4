// Fused residual-block tail, NCHW:
//   out = act2(pointwise1x1(depthwise3x3(gelu(mid)))) + skip
// with act2 = GDN  y * rsqrt(beta + y^2 @ gamma),
//             IGDN y *  sqrt(beta + y^2 @ gamma), or tanh-GELU.
//
// Replaces the Pallas kernel fused_block_tail
// (mlic_tpu/ops/pallas_fused_block.py:148, call :138, body _kernel :79).
// What the TPU version needed and this one does not: channels padded to 128
// lanes, an aligned wt+8 column window, a zero-padded copy of `mid` in
// device memory, and tile sizes that must divide H and W.  Here the block
// masks the image border itself (zero before the GELU, and gelu(0) == 0, so
// that is the flax op order), takes any H, W, C and N, and pads nothing in
// device memory.
//
// Bound on this card: each of mid, skip and out crosses device memory once
// (3 x 151 MB in bf16 at [8, 96, 256, 384]: 0.135 ms at 3.35 TB/s); the
// arithmetic is 2*C*N + 18*C (+ 2*N*N for GDN) operations per pixel (30
// GFLOP there: 0.45 ms on the f32 cores, 0.03 ms on the bf16 tensor cores).
// So in bf16 the bound is the bytes.  Measured by chip_smoke.py on an
// NVIDIA H100 80GB HBM3 at 700 W, GDN at that shape: 0.74-0.75 ms a call in
// bf16 by CUDA events (2.2 ms before this design, when bf16 ran the f32 FMA
// loops below; GELU 0.61 ms, 1.30 before), and 2.2 ms in f32, against
// 3.2-3.9 ms for the same tail as separate PyTorch ops.
// What holds the bf16 kernel at 5.5x its bound is not the tensor cores
// but the f32 work around them -- gelu of the halo (6 x 34 values for a
// tile's 4 x 32) and the 9 taps of every output value -- and its latency:
// each tile runs halo, taps, product and epilogue in turn between block
// barriers, with 24 warps an SM to hide it.
//
// bf16 design (namespace tc).  A block of 384 threads (4 x 3 warps) owns a
// 4 x 32 pixel tile (M = 128 rows of both products) and all channels, and
// walks tiles persistently (as many blocks as the card holds, two an SM),
// so the weights go to shared memory once per block:
//   0. pw [N][C] and gamma^T [N][N] as bf16, K-contiguous, rows padded to
//      16k + 8 elements (an odd number of 16-byte units: ldmatrix reads
//      without bank conflicts); widths are zero-padded there, never in
//      device memory.  Wider than 96 output or 128 input channels, the
//      weights are staged in 96 x 64 chunks instead.
//   1. per chunk of 48 input channels: the (4+2) x (32+2) halo of mid,
//      16-byte loads along W (W % 8 == 0; scalar loads otherwise), gelu in
//      f32, rounded, into shared memory; the next chunk's (or next tile's)
//      loads are issued before this chunk's taps run.  A warp takes a
//      channel pair and the tile's 32 columns (48 channels: two pairs a
//      thread, no thread idle): the 9 taps and the bias, rounded once per
//      block into shared memory, give A[pixel][c] in bf16, K-contiguous.
//   2. h = A @ pw^T on the tensor cores: mma.sync m16n8k16 bf16 with f32
//      accumulators, operands by ldmatrix, a fixed order of k-steps; each
//      warp holds 32 pixels x 32 channels.  GELU tails finish here; GDN
//      keeps y = bf16(h + bpw) in shared memory.
//   3. GDN / IGDN: norm = bf16(y*y) @ gamma + beta, the squares made from
//      the ldmatrix fragments of y; y * bf16((r)sqrt(norm)).
//   4. the tile goes through shared memory ([n][pixel]) and out with
//      16-byte stores along W, skip read the same way.
// GELU is the same tanh form (gelu_tanh, tanhf) as in the f32 kernel and
// the plain version.  The f32 instantiation keeps the FMA loops below: the
// tensor cores would take f32 only as TF32, which breaks the f32 tolerance
// of 1e-5 and what the f32 policy means.
//
// f32 design.  One block of 256 threads owns a 4 x 16 pixel tile of one
// image and all channels of it (74 KB of shared memory at C = N = 96 with
// GDN, so three blocks share an SM):
//   1. per chunk of 32 input channels: gelu(mid) of the (4+2) x (16+2) halo
//      goes to shared memory (zero outside the image), then the 9 taps and
//      the depthwise bias give a[c][pixel], kept in shared memory for all C;
//   2. per chunk of 96 output channels: h = a^T @ pw + bpw by register tiles
//      (6 channels x 4 pixels a thread), the weights staged through shared
//      memory in chunks of 32 input channels, so any C and N work; GELU
//      tails finish here (gelu, + skip, store);
//   3. GDN / IGDN: y = h stays in shared memory for all N, y^2 overwrites
//      a, and the same contraction with gamma gives the norm; then
//      y * (r)sqrt(norm + beta) + skip is stored.
// A thread's 4 pixels are one column of the tile, and the 16 threads of a
// channel group are its neighbouring columns, so global loads and stores
// run along W.  No atomics; every sum runs over channels in ascending order,
// so the result is the same bits from call to call (the codec compares the
// encoder's and the decoder's reconstruction bit for bit).
//
// Rounding in bf16 (both designs round at these points, the ones of the
// Pallas body :96-118):
// gelu(mid) is computed in f32 and rounded; the 9 taps and the depthwise
// bias accumulate in f32 and are rounded ONCE (the Pallas body rounds after
// every tap; one rounding is what a bf16 convolution with f32 accumulation
// gives); the weights dw, bdw, pw and gamma are rounded to bf16; both
// contractions accumulate in f32; bpw and beta stay f32; y = h, y*y, the
// (r)sqrt factor, y*factor and the sum with skip are each rounded.  In f32
// nothing is rounded and the taps use fused multiply-adds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_count.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileH = 4;    // pixel rows of a block's tile
constexpr int kTileW = 16;   // pixel columns of it
constexpr int kChunkC = 32;  // input channels staged at a time
constexpr int kChunkN = 96;  // output channels per register-tile pass
// Row stride of the staged weights: 8 mod 32, so that the transposing store
// of pw spreads over the banks; even, so that float2 loads stay aligned.
constexpr int kStrideW = 104;
enum Act { kGdn = 0, kIgdn = 1, kGelu = 2 };

template <typename T> __device__ __forceinline__ float load(const T* p);
template <> __device__ __forceinline__ float load<float>(const float* p) {
  return __ldg(p);
}
template <>
__device__ __forceinline__ float load<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Round to the working type, as a float.
template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T> __device__ __forceinline__ void store(T* p, float x);
template <> __device__ __forceinline__ void store<float>(float* p, float x) {
  *p = x;
}
template <>
__device__ __forceinline__ void store<__nv_bfloat16>(__nv_bfloat16* p,
                                                     float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(k * (x + 0.044715f * x * x * x)));
}

// acc[j][i] += sum_{c < K} w(c, n0 + ng*RN + j) * A[c][4*pg + i], where
// w(c, n) = rnd(wg[c*stride_c + n*stride_n]) is staged through `wsm` in
// chunks of kChunkC rows.  Every thread of the block must call it.
template <typename T, int RN, int P>
__device__ __forceinline__ void contract(
    const float* __restrict__ A, int K, const float* __restrict__ wg,
    int stride_c, int stride_n, int n0, int N, float* __restrict__ wsm,
    int pg, int ng, float (&acc)[RN][4]) {
  for (int c0 = 0; c0 < K; c0 += kChunkC) {
    const int ck = min(kChunkC, K - c0);
    __syncthreads();  // the previous chunk's readers are done; A is written
    for (int idx = threadIdx.x; idx < kChunkC * kChunkN; idx += kThreads) {
      // Neighbouring threads read neighbouring addresses: along c for pw
      // (stride_c == 1, 8 channels of 4 columns a warp), along n for gamma.
      int c, n;
      if (stride_c == 1) {
        c = idx / (8 * kChunkN) * 8 + idx % 8;
        n = idx / 8 % kChunkN;
      } else {
        c = idx / kChunkN;
        n = idx % kChunkN;
      }
      float v = 0.0f;
      if (c < ck && n0 + n < N) {
        v = rnd<T>(__ldg(wg + static_cast<long long>(c0 + c) * stride_c +
                         static_cast<long long>(n0 + n) * stride_n));
      }
      wsm[c * kStrideW + n] = v;
    }
    __syncthreads();
    const float* a_row = A + static_cast<long long>(c0) * P + 4 * pg;
    const float* w_row = wsm + ng * RN;
    for (int c = 0; c < ck; ++c) {
      const float4 av = *reinterpret_cast<const float4*>(a_row + c * P);
#pragma unroll
      for (int j = 0; j < RN; j += 2) {
        const float2 wv =
            *reinterpret_cast<const float2*>(w_row + c * kStrideW + j);
        acc[j][0] = fmaf(wv.x, av.x, acc[j][0]);
        acc[j][1] = fmaf(wv.x, av.y, acc[j][1]);
        acc[j][2] = fmaf(wv.x, av.z, acc[j][2]);
        acc[j][3] = fmaf(wv.x, av.w, acc[j][3]);
        acc[j + 1][0] = fmaf(wv.y, av.x, acc[j + 1][0]);
        acc[j + 1][1] = fmaf(wv.y, av.y, acc[j + 1][1]);
        acc[j + 1][2] = fmaf(wv.y, av.z, acc[j + 1][2]);
        acc[j + 1][3] = fmaf(wv.y, av.w, acc[j + 1][3]);
      }
    }
  }
}

// mid [B, C, H, W], skip and out [B, N, H, W], contiguous, of type T.
// dw [C, 9], bdw [C], pw [N, C], bpw [N], gamma [N(d), N(n)], beta [N]: f32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_block_tail_kernel(const T* __restrict__ mid, const T* __restrict__ skip,
                        T* __restrict__ out, const float* __restrict__ dw,
                        const float* __restrict__ bdw,
                        const float* __restrict__ pw,
                        const float* __restrict__ bpw,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta, int C, int N, int H,
                        int W, int act) {
  count_device_launch();
  constexpr int TW = kTileW;
  constexpr int P = kTileH * TW;         // pixels of the tile
  constexpr int NG = kThreads / TW;      // channel groups of a pass
  constexpr int RN = kChunkN / NG;       // output channels a thread holds
  constexpr int HW = TW + 2;             // halo width
  constexpr int HALO = (kTileH + 2) * HW;
  static_assert(RN % 2 == 0 && RN * NG == kChunkN, "register tile");

  extern __shared__ __align__(16) float smem[];
  const int a_rows = (act == kGelu || C > N) ? C : N;
  float* a = smem;                                      // [a_rows][P]
  float* y = a + static_cast<long long>(a_rows) * P;    // [N][P], GDN only
  float* g = y + (act == kGelu ? 0 : static_cast<long long>(N) * P);
  float* wsm = g + kChunkC * HALO;                      // [kChunkC][kStrideW]

  const int w0 = blockIdx.x * TW, h0 = blockIdx.y * kTileH, b = blockIdx.z;
  const long long plane = static_cast<long long>(H) * W;
  const T* mid_b = mid + static_cast<long long>(b) * C * plane;
  const long long out_b = static_cast<long long>(b) * N * plane;

  // 1. a[c][col*4 + row] = depthwise3x3(gelu(mid))[c][h0+row][w0+col]
  for (int c0 = 0; c0 < C; c0 += kChunkC) {
    const int ck = min(kChunkC, C - c0);
    __syncthreads();  // the previous chunk's taps have read g
    for (int idx = threadIdx.x; idx < ck * HALO; idx += kThreads) {
      const int c = idx / HALO, r = idx % HALO;
      const int hh = h0 - 1 + r / HW, ww = w0 - 1 + r % HW;
      float v = 0.0f;
      if (hh >= 0 && hh < H && ww >= 0 && ww < W) {
        v = rnd<T>(gelu_tanh(load<T>(mid_b + (c0 + c) * plane +
                                     static_cast<long long>(hh) * W + ww)));
      }
      g[idx] = v;
    }
    __syncthreads();
    // One thread per (channel, tile column): its 6 x 3 window of g and its
    // 9 taps sit in registers and give the column's 4 rows.
    for (int idx = threadIdx.x; idx < ck * TW; idx += kThreads) {
      const int c = idx / TW, col = idx % TW;
      const float* gp = g + c * HALO + col;
      float k[9], gv[kTileH + 2][3], o[kTileH];
#pragma unroll
      for (int t = 0; t < 9; ++t) k[t] = rnd<T>(__ldg(dw + (c0 + c) * 9 + t));
      const float bias = rnd<T>(__ldg(bdw + c0 + c));
#pragma unroll
      for (int r = 0; r < kTileH + 2; ++r) {
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) gv[r][dj] = gp[r * HW + dj];
      }
#pragma unroll
      for (int row = 0; row < kTileH; ++row) {
        float s = 0.0f;
#pragma unroll
        for (int di = 0; di < 3; ++di) {
#pragma unroll
          for (int dj = 0; dj < 3; ++dj) {
            s = fmaf(k[di * 3 + dj], gv[row + di][dj], s);
          }
        }
        o[row] = rnd<T>(s + bias);
      }
      *reinterpret_cast<float4*>(a + static_cast<long long>(c0 + c) * P +
                                 col * kTileH) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
  }

  const int pg = threadIdx.x % TW;  // the thread's tile column
  const int ng = threadIdx.x / TW;
  const int ww = w0 + pg;

  // 2. h = a^T @ pw + bpw; GELU tails finish, GDN tails keep y = rnd(h).
  for (int n0 = 0; n0 < N; n0 += kChunkN) {
    float acc[RN][4] = {};
    contract<T, RN, P>(a, C, pw, 1, C, n0, N, wsm, pg, ng, acc);
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int n = n0 + ng * RN + j;
      if (n >= N) break;
      const float bias = __ldg(bpw + n);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float h = acc[j][i] + bias;
        if (act == kGelu) {
          const int hh = h0 + i;
          if (hh < H && ww < W) {
            const long long o =
                out_b + n * plane + static_cast<long long>(hh) * W + ww;
            store<T>(out + o, rnd<T>(gelu_tanh(h)) + load<T>(skip + o));
          }
        } else {
          y[static_cast<long long>(n) * P + 4 * pg + i] = rnd<T>(h);
        }
      }
    }
  }
  if (act == kGelu) return;

  // 3. norm = (y*y)^T @ gamma + beta; out = y * (r)sqrt(norm) + skip.
  __syncthreads();  // y is complete and a is no longer read
  for (int idx = threadIdx.x; idx < N * P; idx += kThreads) {
    const float v = y[idx];
    a[idx] = rnd<T>(v * v);
  }
  for (int n0 = 0; n0 < N; n0 += kChunkN) {
    float acc[RN][4] = {};
    contract<T, RN, P>(a, N, gamma, N, 1, n0, N, wsm, pg, ng, acc);
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int n = n0 + ng * RN + j;
      if (n >= N) break;
      const float bet = __ldg(beta + n);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int hh = h0 + i;
        if (hh < H && ww < W) {
          const float norm = acc[j][i] + bet;
          const float fac = act == kIgdn ? sqrtf(norm) : rsqrtf(norm);
          const float v =
              rnd<T>(y[static_cast<long long>(n) * P + 4 * pg + i] *
                     rnd<T>(fac));
          const long long o =
              out_b + n * plane + static_cast<long long>(hh) * W + ww;
          store<T>(out + o, v + load<T>(skip + o));
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: both contractions on the tensor cores (mma.sync m16n8k16, bf16
// operands from shared memory by ldmatrix, f32 accumulators).
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarpsN = 3;     // warps along N; 4 along the pixels
constexpr int kThreads = 32 * 4 * kWarpsN;
constexpr int kTileH = 4;
constexpr int kTileW = 32;     // a pixel row of the tile is 64 bytes of bf16
constexpr int kP = kTileH * kTileW;  // 128 pixels: the M of both products
constexpr int kHaloC = 48;     // channels of `mid` staged at a time
// A halo row holds columns w0-8 .. w0+39 (the tile at 8, 16-byte aligned).
constexpr int kHaloW = 48;
constexpr int kHaloStride = (kTileH + 2) * kHaloW;  // per channel
constexpr int kNT = 4;         // n-tiles of 8 a warp holds in a pass
constexpr int kNC = kWarpsN * 8 * kNT;  // output channels per pass: 96
constexpr int kKC = 64;        // input channels per weight stage, wide widths
constexpr int kLdo = kP + 8;   // row stride of the output staging [n][pixel]
// Per thread and chunk: the 16-byte vectors and the edge values of the halo.
constexpr int kVecs = (kHaloC * (kTileH + 2) * 4 + kThreads - 1) / kThreads;
constexpr int kEdges = (kHaloC * (kTileH + 2) * 2 + kThreads - 1) / kThreads;
constexpr int kOutVecs = (kNC * kTileH * 4 + kThreads - 1) / kThreads;

__host__ __device__ constexpr long long up(long long v, long long m) {
  return (v + m - 1) / m * m;
}

// Shared memory plan of one block, from (C, N, act).  Row strides of the
// K-contiguous bf16 operands are a multiple of 16 elements plus 8, an odd
// number of 16-byte units, so the 8 rows an ldmatrix reads fall on distinct
// banks.  Widths that are not a multiple of 16 (K) or 8 (N) are zero-padded
// here, never in device memory.
struct Plan {
  bool gdn, resident;  // resident: every weight staged once per block
  int lda, ldy, ldw1, ldw2, n_rows;
  // bytes: A (then GDN's staging), halo/Y/O, W, the depthwise taps
  long long r1, r2, w, taps, total;
};

__host__ __device__ inline Plan plan(long long C, long long N, int act) {
  Plan L;
  L.gdn = act != kGelu;
  const long long Cp = up(C, 16), Np = up(N, 16), N8 = up(N, 8);
  L.resident = N8 <= kNC && Cp <= 128 && (!L.gdn || Np <= 128);
  L.lda = static_cast<int>(Cp + 8);
  L.ldy = static_cast<int>(Np + 8);
  L.n_rows = L.resident ? static_cast<int>(N8) : kNC;
  L.ldw1 = L.resident ? L.lda : kKC + 8;
  L.ldw2 = L.resident ? L.ldy : kKC + 8;
  const long long a = 2LL * kP * L.lda;
  const long long o = 2LL * (N8 < kNC ? N8 : kNC) * kLdo;
  const long long halo = 2LL * kHaloC * kHaloStride;
  const long long y = L.gdn ? 2LL * kP * L.ldy : 0;
  L.r1 = up(L.gdn ? (a > o ? a : o) : a, 16);
  L.r2 = up(L.gdn ? (y > halo ? y : halo) : (o > halo ? o : halo), 16);
  L.w = L.resident ? 2LL * N8 * (L.ldw1 + (L.gdn ? L.ldw2 : 0))
                   : 2LL * kNC * (kKC + 8);
  L.taps = 4LL * 10 * C;
  L.total = L.r1 + L.r2 + L.w + L.taps;
  return L;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ float2 unpack(unsigned v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Two bf16 values squared and rounded: y*y as bf16 tensors compute it.
__device__ __forceinline__ unsigned square(unsigned v) {
  const float2 f = unpack(v);
  return pack(f.x * f.x, f.y * f.y);
}

// wsm[n][k] = bf16(w(n0 + n, k0 + k)) for n < rows, k < kc, zero where
// n0 + n >= N or k0 + k >= K; w(n, k) = wg[n * sn + k * sk].
__device__ __forceinline__ void stage(bf16* wsm, int ldw, const float* wg,
                                      long long sn, long long sk, int n0,
                                      int rows, int N, int k0, int kc, int K) {
#pragma unroll 4
  for (int idx = threadIdx.x; idx < rows * kc; idx += kThreads) {
    int n, k;  // neighbouring threads read neighbouring addresses
    if (sk == 1) {
      n = idx / kc;
      k = idx % kc;
    } else {
      k = idx / rows;
      n = idx % rows;
    }
    float v = 0.0f;
    if (n0 + n < N && k0 + k < K) {
      v = __ldg(wg + (n0 + n) * sn + (k0 + k) * sk);
    }
    wsm[n * ldw + k] = __float2bfloat16_rn(v);
  }
}

// One warp's share of a pass: acc[mt][i] += A[rows] . W[n-tile
// kWarpsN*i + wn] over k_steps steps of 16, in ascending k.  The warp's
// rows are 32*wm .. 32*wm+31 (two m-tiles); its n-tiles are every
// kWarpsN-th one, so the warps along N split any width evenly.
template <bool kSquare>
__device__ __forceinline__ void mma_pass(const bf16* A, int lda,
                                         const bf16* Wt, int ldw, int k_steps,
                                         int n_tiles, int wm, int wn, int lane,
                                         float (&acc)[2][kNT][4]) {
  const bf16* a_ptr = A + (32 * wm + (lane & 15)) * lda + (lane >> 4) * 8;
  // ldmatrix x4 of n-tiles j and j+kWarpsN: lanes 0-15 address tile j
  // (k 0-7, then 8-15), lanes 16-31 tile j+kWarpsN
  const bf16* b_ptr =
      Wt + (8 * wn + (lane & 7) + (lane >> 4) * 8 * kWarpsN) * ldw +
      ((lane >> 3) & 1) * 8;
#pragma unroll 2
  for (int ks = 0; ks < k_steps; ++ks) {
    unsigned a[2][4];
    ldsm_x4(a[0], a_ptr + ks * 16);
    ldsm_x4(a[1], a_ptr + 16 * lda + ks * 16);
    if (kSquare) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[0][r] = square(a[0][r]);
        a[1][r] = square(a[1][r]);
      }
    }
#pragma unroll
    for (int i = 0; i < kNT; i += 2) {
      const int j = kWarpsN * i + wn;
      if (j >= n_tiles) break;
      unsigned b[4];
      const bf16* bp = b_ptr + i * 8 * kWarpsN * ldw + ks * 16;
      const bool pair = i + 1 < kNT && j + kWarpsN < n_tiles;
      if (pair) {
        ldsm_x4(b, bp);
      } else {
        ldsm_x2(b, bp);
      }
      mma(acc[0][i], a[0], b[0], b[1]);
      mma(acc[1][i], a[1], b[0], b[1]);
      if (pair) {
        mma(acc[0][i + 1], a[0], b[2], b[3]);
        mma(acc[1][i + 1], a[1], b[2], b[3]);
      }
    }
  }
}

// The pixel (row of M) and output channel (of the pass) of accumulator
// element acc[mt][i][e] (the m16n8 f32 fragment: rows lane/4 and +8,
// columns 2*(lane%4) and +1).
__device__ __forceinline__ int frag_m(int wm, int mt, int lane, int e) {
  return 32 * wm + 16 * mt + (lane >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int frag_n(int wn, int i, int lane, int e) {
  return 8 * (kWarpsN * i + wn) + 2 * (lane & 3) + (e & 1);
}

// gelu of 8 bf16 values in f32, each rounded to bf16.
__device__ __forceinline__ uint4 gelu8(uint4 v) {
  unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = unpack(w[q]);
    w[q] = pack(gelu_tanh(f.x), gelu_tanh(f.y));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// out = bf16(y + skip) for 8 values.
__device__ __forceinline__ uint4 add8(uint4 y, uint4 s) {
  const unsigned a[4] = {y.x, y.y, y.z, y.w}, b[4] = {s.x, s.y, s.z, s.w};
  unsigned o[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 fa = unpack(a[q]), fb = unpack(b[q]);
    o[q] = pack(fa.x + fb.x, fa.y + fb.y);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// The raw bf16 halo of one chunk as this thread loads it on the vector path
// (W % 8 == 0): kVecs 16-byte vectors of the tile's columns and kEdges
// values of the columns beside them; zero outside the image.
struct Raw {
  uint4 vec[kVecs];
  unsigned short edge[kEdges];
};

__device__ __forceinline__ void load_raw(Raw& raw, const bf16* mid, int C,
                                         int H, int W, int b, int h0, int w0,
                                         int c0) {
  const int ck = min(kHaloC, C - c0);
  const long long plane = static_cast<long long>(H) * W;
  const bf16* base = mid + (static_cast<long long>(b) * C + c0) * plane;
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const int idx = threadIdx.x + u * kThreads;
    const int v = idx & 3, r = (idx >> 2) % (kTileH + 2);
    const int c = idx / (4 * (kTileH + 2));
    const int hh = h0 - 1 + r, ww = w0 + 8 * v;
    raw.vec[u] = make_uint4(0, 0, 0, 0);
    if (c < ck && hh >= 0 && hh < H && ww < W) {
      raw.vec[u] = __ldg(reinterpret_cast<const uint4*>(
          base + c * plane + static_cast<long long>(hh) * W + ww));
    }
  }
#pragma unroll
  for (int u = 0; u < kEdges; ++u) {
    const int idx = threadIdx.x + u * kThreads;
    const int side = idx & 1, r = (idx >> 1) % (kTileH + 2);
    const int c = idx / (2 * (kTileH + 2));
    const int hh = h0 - 1 + r, ww = side ? w0 + kTileW : w0 - 1;
    raw.edge[u] = 0;
    if (c < ck && hh >= 0 && hh < H && ww >= 0 && ww < W) {
      raw.edge[u] = __ldg(reinterpret_cast<const unsigned short*>(
          base + c * plane + static_cast<long long>(hh) * W + ww));
    }
  }
}

// gelu of the raw halo, rounded, into the halo buffer [c][row][48].
__device__ __forceinline__ void store_raw(const Raw& raw, bf16* halo) {
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const int idx = threadIdx.x + u * kThreads;
    const int v = idx & 3, r = (idx >> 2) % (kTileH + 2);
    const int c = idx / (4 * (kTileH + 2));
    if (c >= kHaloC) continue;
    *reinterpret_cast<uint4*>(halo + c * kHaloStride + r * kHaloW + 8 +
                              8 * v) = gelu8(raw.vec[u]);
  }
#pragma unroll
  for (int u = 0; u < kEdges; ++u) {
    const int idx = threadIdx.x + u * kThreads;
    const int side = idx & 1, r = (idx >> 1) % (kTileH + 2);
    const int c = idx / (2 * (kTileH + 2));
    if (c >= kHaloC) continue;
    const unsigned short e = raw.edge[u];
    halo[c * kHaloStride + r * kHaloW + (side ? 8 + kTileW : 7)] =
        __float2bfloat16_rn(
            gelu_tanh(__bfloat162float(*reinterpret_cast<const bf16*>(&e))));
  }
}

// mid [B, C, H, W], skip and out [B, N, H, W], bf16, contiguous; weights
// f32 as for the f32 kernel.  `vec`: W % 8 == 0 and the three tensors are
// 16-byte aligned, so rows move as 16-byte vectors.  Persistent: block k
// takes tiles k, k + gridDim.x, ... of the [B][H/4][W/32] tile grid.
__global__ void __launch_bounds__(kThreads, 2)
fused_block_tail_tc_kernel(const bf16* __restrict__ mid,
                           const bf16* __restrict__ skip,
                           bf16* __restrict__ out, const float* __restrict__ dw,
                           const float* __restrict__ bdw,
                           const float* __restrict__ pw,
                           const float* __restrict__ bpw,
                           const float* __restrict__ gamma,
                           const float* __restrict__ beta, int B, int C, int N,
                           int H, int W, int act, int vec) {
  count_device_launch();
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan L = plan(C, N, act);
  bf16* A = reinterpret_cast<bf16*>(smem);            // [kP][lda]
  bf16* R2 = reinterpret_cast<bf16*>(smem + L.r1);    // halo, then Y or O
  bf16* Wsm = reinterpret_cast<bf16*>(smem + L.r1 + L.r2);
  bf16* Wg = Wsm + L.n_rows * L.ldw1;                 // gamma, if resident
  // the 9 taps and the bias of channel c, rounded: taps[10c .. 10c+9]
  float* taps = reinterpret_cast<float*>(smem + L.r1 + L.r2 + L.w);
  bf16* halo = R2;                                    // [kHaloC][6][48]
  bf16* Y = R2;                                       // [kP][ldy], GDN
  bf16* O = L.gdn ? A : R2;                           // [n][kLdo]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const long long plane = static_cast<long long>(H) * W;
  const int Cp = static_cast<int>(up(C, 16)), Np = static_cast<int>(up(N, 16));
  const int N8 = static_cast<int>(up(N, 8));
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_hw = tiles_w * ((H + kTileH - 1) / kTileH);
  const int n_tiles_all = B * tiles_hw;

  // Weights that fit, and the depthwise ones, are staged once per block.
  if (L.resident) {
    stage(Wsm, L.ldw1, pw, C, 1, 0, N8, N, 0, Cp, C);
    if (L.gdn) stage(Wg, L.ldw2, gamma, 1, N, 0, N8, N, 0, Np, N);
  }
  for (int i = tid; i < C * 10; i += kThreads) {
    const int c = i / 10, k = i % 10;
    taps[i] = rnd<bf16>(__ldg(k < 9 ? dw + c * 9 + k : bdw + c));
  }

  Raw raw;
  int tile = blockIdx.x;
  if (vec && tile < n_tiles_all) {
    load_raw(raw, mid, C, H, W, tile / tiles_hw, tile % tiles_hw / tiles_w *
             kTileH, tile % tiles_w * kTileW, 0);
  }
  for (; tile < n_tiles_all; tile += gridDim.x) {
    const int b = tile / tiles_hw;
    const int h0 = tile % tiles_hw / tiles_w * kTileH;
    const int w0 = tile % tiles_w * kTileW;
    const bf16* mid_b = mid + static_cast<long long>(b) * C * plane;
    const long long out_b = static_cast<long long>(b) * N * plane;

    // 1. A[pixel][c] = depthwise3x3(gelu(mid)), per chunk of kHaloC
    //    channels; on the vector path the next chunk's (or the next tile's
    //    first chunk's) loads are in flight while this chunk's taps run.
    for (int c0 = 0; c0 < C; c0 += kHaloC) {
      const int ck = min(kHaloC, C - c0);
      __syncthreads();  // the halo, A and the staging are free again
      if (c0 == 0) {    // A's pad columns are zero (GDN's staging
                        // overwrote them)
        for (int idx = tid; idx < kP * (Cp - C); idx += kThreads) {
          A[idx / (Cp - C) * L.lda + C + idx % (Cp - C)] =
              __float2bfloat16_rn(0.0f);
        }
      }
      if (vec) {
        store_raw(raw, halo);
        if (c0 + kHaloC < C) {
          load_raw(raw, mid, C, H, W, b, h0, w0, c0 + kHaloC);
        } else if (tile + gridDim.x < n_tiles_all) {
          const int t2 = tile + gridDim.x;
          load_raw(raw, mid, C, H, W, t2 / tiles_hw,
                   t2 % tiles_hw / tiles_w * kTileH, t2 % tiles_w * kTileW, 0);
        }
      } else {
        constexpr int kRow = kTileW + 2;
        for (int idx = tid; idx < ck * (kTileH + 2) * kRow; idx += kThreads) {
          const int j = idx % kRow, r = idx / kRow % (kTileH + 2);
          const int c = idx / (kRow * (kTileH + 2));
          const int hh = h0 - 1 + r, ww = w0 - 1 + j;
          float g = 0.0f;
          if (hh >= 0 && hh < H && ww >= 0 && ww < W) {
            g = gelu_tanh(__bfloat162float(
                mid_b[(c0 + c) * plane + static_cast<long long>(hh) * W +
                      ww]));
          }
          halo[c * kHaloStride + r * kHaloW + 7 + j] = __float2bfloat16_rn(g);
        }
      }
      __syncthreads();
      // A warp takes one channel pair and the 32 columns of the tile: its
      // halo reads are consecutive, its stores bf16 pairs.
      for (int idx = tid; idx < (ck + 1) / 2 * kTileW; idx += kThreads) {
        const int col = idx & (kTileW - 1), c = 2 * (idx / kTileW);
        float o[2][kTileH];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (c + e >= ck) {  // odd C: the pad column stays zero
#pragma unroll
            for (int row = 0; row < kTileH; ++row) o[e][row] = 0.0f;
            continue;
          }
          const int cc = c0 + c + e;
          const bf16* gp = halo + (c + e) * kHaloStride + 7 + col;
          float k[9], gv[kTileH + 2][3];
#pragma unroll
          for (int t = 0; t < 9; ++t) k[t] = taps[cc * 10 + t];
          const float bias = taps[cc * 10 + 9];
#pragma unroll
          for (int r = 0; r < kTileH + 2; ++r) {
#pragma unroll
            for (int dj = 0; dj < 3; ++dj) {
              gv[r][dj] = __bfloat162float(gp[r * kHaloW + dj]);
            }
          }
#pragma unroll
          for (int row = 0; row < kTileH; ++row) {
            float s = 0.0f;
#pragma unroll
            for (int di = 0; di < 3; ++di) {
#pragma unroll
              for (int dj = 0; dj < 3; ++dj) {
                s = fmaf(k[di * 3 + dj], gv[row + di][dj], s);
              }
            }
            o[e][row] = s + bias;
          }
        }
#pragma unroll
        for (int row = 0; row < kTileH; ++row) {
          *reinterpret_cast<unsigned*>(A + (row * kTileW + col) * L.lda + c0 +
                                       c) = pack(o[0][row], o[1][row]);
        }
      }
    }
    __syncthreads();  // A is complete; the halo is no longer read
    if (L.gdn) {      // Y's pad columns (K of the second product) are zero
      for (int idx = tid; idx < kP * (Np - N); idx += kThreads) {
        Y[idx / (Np - N) * L.ldy + N + idx % (Np - N)] =
            __float2bfloat16_rn(0.0f);
      }
    }

    // out = staged value + skip, for the pass's nc channels from n0: all
    // of a thread's skip loads are issued before the first is used.
    auto write_out = [&](int n0, int nc) {
      if (vec) {
        uint4 s[kOutVecs];
#pragma unroll
        for (int u = 0; u < kOutVecs; ++u) {
          const int idx = tid + u * kThreads;
          const int v = idx & 3, r = (idx >> 2) % kTileH;
          const int nl = idx / (4 * kTileH);
          const int hh = h0 + r, ww = w0 + 8 * v;
          s[u] = make_uint4(0, 0, 0, 0);
          if (nl < nc && hh < H && ww < W) {
            s[u] = __ldg(reinterpret_cast<const uint4*>(
                skip + out_b + (n0 + nl) * plane +
                static_cast<long long>(hh) * W + ww));
          }
        }
#pragma unroll
        for (int u = 0; u < kOutVecs; ++u) {
          const int idx = tid + u * kThreads;
          const int v = idx & 3, r = (idx >> 2) % kTileH;
          const int nl = idx / (4 * kTileH);
          const int hh = h0 + r, ww = w0 + 8 * v;
          if (nl < nc && hh < H && ww < W) {
            const uint4 y = *reinterpret_cast<const uint4*>(
                O + nl * kLdo + r * kTileW + 8 * v);
            *reinterpret_cast<uint4*>(out + out_b + (n0 + nl) * plane +
                                      static_cast<long long>(hh) * W + ww) =
                add8(y, s[u]);
          }
        }
      } else {
        for (int idx = tid; idx < nc * kP; idx += kThreads) {
          const int col = idx % kTileW, r = idx / kTileW % kTileH;
          const int nl = idx / kP;
          const int hh = h0 + r, ww = w0 + col;
          if (hh >= H || ww >= W) continue;
          const long long o = out_b + (n0 + nl) * plane +
                              static_cast<long long>(hh) * W + ww;
          out[o] = __float2bfloat16_rn(
              __bfloat162float(O[nl * kLdo + r * kTileW + col]) +
              __bfloat162float(skip[o]));
        }
      }
    };

    // 2. h = A @ pw^T + bpw: GELU tails finish, GDN tails keep y = bf16(h).
    for (int n0 = 0; n0 < N; n0 += kNC) {
      const int nc = min(kNC, N - n0), n_tiles = (nc + 7) / 8;
      float acc[2][kNT][4] = {};
      if (L.resident) {
        mma_pass<false>(A, L.lda, Wsm, L.ldw1, Cp / 16, n_tiles, wm, wn,
                        lane, acc);
      } else {
        for (int k0 = 0; k0 < C; k0 += kKC) {
          __syncthreads();  // the previous stage's readers are done
          stage(Wsm, L.ldw1, pw, C, 1, n0, kNC, N, k0, kKC, C);
          __syncthreads();
          mma_pass<false>(A + k0, L.lda, Wsm, L.ldw1,
                          min(kKC, Cp - k0) / 16, n_tiles, wm, wn, lane, acc);
        }
      }
      if (L.gdn) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int i = 0; i < kNT; ++i) {
            if (kWarpsN * i + wn >= n_tiles) continue;
#pragma unroll
            for (int e = 0; e < 4; e += 2) {
              const int m = frag_m(wm, mt, lane, e);
              const int n = n0 + frag_n(wn, i, lane, e);
              const float y0 = n < N ? acc[mt][i][e] + __ldg(bpw + n) : 0.0f;
              const float y1 =
                  n + 1 < N ? acc[mt][i][e + 1] + __ldg(bpw + n + 1) : 0.0f;
              *reinterpret_cast<unsigned*>(Y + m * L.ldy + n) = pack(y0, y1);
            }
          }
        }
        continue;
      }
      __syncthreads();  // the previous pass's output has been read from O
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int i = 0; i < kNT; ++i) {
          if (kWarpsN * i + wn >= n_tiles) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int nl = frag_n(wn, i, lane, e);
            if (n0 + nl >= N) continue;
            O[nl * kLdo + frag_m(wm, mt, lane, e)] = __float2bfloat16_rn(
                gelu_tanh(acc[mt][i][e] + __ldg(bpw + n0 + nl)));
          }
        }
      }
      __syncthreads();
      write_out(n0, nc);
    }
    if (!L.gdn) continue;

    // 3. norm = bf16(y*y) @ gamma + beta; out = bf16(y * bf16((r)sqrt(norm)))
    //    + skip.
    __syncthreads();  // Y is complete; A is no longer read
    for (int n0 = 0; n0 < N; n0 += kNC) {
      const int nc = min(kNC, N - n0), n_tiles = (nc + 7) / 8;
      float acc[2][kNT][4] = {};
      if (L.resident) {
        mma_pass<true>(Y, L.ldy, Wg, L.ldw2, Np / 16, n_tiles, wm, wn, lane,
                       acc);
      } else {
        for (int k0 = 0; k0 < N; k0 += kKC) {
          __syncthreads();
          stage(Wsm, L.ldw2, gamma, 1, N, n0, kNC, N, k0, kKC, N);
          __syncthreads();
          mma_pass<true>(Y + k0, L.ldy, Wsm, L.ldw2, min(kKC, Np - k0) / 16,
                         n_tiles, wm, wn, lane, acc);
        }
      }
      __syncthreads();  // the previous pass's output has been read from O
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int i = 0; i < kNT; ++i) {
          if (kWarpsN * i + wn >= n_tiles) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int nl = frag_n(wn, i, lane, e);
            const int n = n0 + nl;
            if (n >= N) continue;
            const int m = frag_m(wm, mt, lane, e);
            const float norm = acc[mt][i][e] + __ldg(beta + n);
            const float fac = act == kIgdn ? sqrtf(norm) : rsqrtf(norm);
            O[nl * kLdo + m] = __float2bfloat16_rn(
                __bfloat162float(Y[m * L.ldy + n]) * rnd<bf16>(fac));
          }
        }
      }
      __syncthreads();
      write_out(n0, nc);
    }
  }
}

}  // namespace tc

// Dynamic shared memory of one block, in bytes.
long long smem_bytes(long long C, long long N, int act, int is_bf16) {
  if (is_bf16) return tc::plan(C, N, act).total;
  const long long p = kTileH * kTileW;
  const long long a_rows = (act == kGelu || C > N) ? C : N;
  const long long y_rows = act == kGelu ? 0 : N;
  const long long halo = (kTileH + 2) * (kTileW + 2);
  return 4 * ((a_rows + y_rows) * p + kChunkC * halo + kChunkC * kStrideW);
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, long long bytes,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller gets the code
    return err;
  }
  kernel<<<grid, threads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// Shared memory of one block for these widths, in bytes: what the entry
// point below holds against 227 KB (the wrapper asks it, to raise first).
extern "C" long long fused_block_tail_smem_bytes(int C, int N, int act,
                                                 int is_bf16) {
  return smem_bytes(C, N, act, is_bf16);
}

// Returns a cudaError.  Widths whose tile needs more shared memory than a
// block may have (227 KB) are refused here and never launched.
extern "C" int fused_block_tail_launch(
    const void* mid, const void* skip, void* out, const float* dw,
    const float* bdw, const float* pw, const float* bpw, const float* gamma,
    const float* beta, int B, int C, int N, int H, int W, int act,
    int is_bf16, void* stream) {
  if (B < 1 || C < 1 || N < 1 || H < 1 || W < 1 || act < kGdn ||
      act > kGelu || B > 65535 || (H + kTileH - 1) / kTileH > 65535 ||
      (act != kGelu && (gamma == nullptr || beta == nullptr)) ||
      smem_bytes(C, N, act, is_bf16) > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long bytes = smem_bytes(C, N, act, is_bf16);
  if (!is_bf16) {
    const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
    return static_cast<int>(launch(
        fused_block_tail_kernel<float>, grid, kThreads, bytes, s,
        static_cast<const float*>(mid), static_cast<const float*>(skip),
        static_cast<float*>(out), dw, bdw, pw, bpw, gamma, beta, C, N, H, W,
        act));
  }
  using tc::bf16;
  auto kernel = tc::fused_block_tail_tc_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  int dev = 0, n_sm = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, tc::kThreads, static_cast<size_t>(bytes));
  }
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = W % 8 == 0 &&
                  ((reinterpret_cast<uintptr_t>(mid) |
                    reinterpret_cast<uintptr_t>(skip) |
                    reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  // Persistent blocks: as many as the card holds at once, each walking the
  // tiles, so the weights are staged once per block.
  const long long tiles = static_cast<long long>(B) *
                          ((H + tc::kTileH - 1) / tc::kTileH) *
                          ((W + tc::kTileW - 1) / tc::kTileW);
  const int grid = static_cast<int>(
      tiles < static_cast<long long>(per_sm) * n_sm ? tiles
                                                    : per_sm * n_sm);
  kernel<<<grid, tc::kThreads, bytes, s>>>(
      static_cast<const bf16*>(mid), static_cast<const bf16*>(skip),
      static_cast<bf16*>(out), dw, bdw, pw, bpw, gamma, beta, B, C, N, H, W,
      act, vec);
  return static_cast<int>(cudaGetLastError());
}

MLIC_DEVICE_LAUNCH_COUNTER(fused_block_tail)
