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
// This kernel does its products as f32 FMA loops, so the f32 rate bounds it;
// the card's own bound in bf16 is the bytes.  Measured there by
// chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W: 2.2 ms a call, against
// 3.4 ms for the same tail as separate PyTorch ops.
//
// Design.  One block of 256 threads owns a 4 x 16 pixel tile of one image
// and all channels of it (74 KB of shared memory at C = N = 96 with GDN, so
// three blocks share an SM):
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
// Rounding in bf16 (T = bf16; shared memory holds f32 values that were
// rounded to bf16 at these points, the ones of the Pallas body :96-118):
// gelu(mid) is computed in f32 and rounded; the 9 taps and the depthwise
// bias accumulate in f32 and are rounded ONCE (the Pallas body rounds after
// every tap; one rounding is what a bf16 convolution with f32 accumulation
// gives); the weights dw, bdw, pw and gamma are rounded to bf16; both
// contractions accumulate in f32; bpw and beta stay f32; y = h, y*y, the
// (r)sqrt factor, y*factor and the sum with skip are each rounded.  In f32
// nothing is rounded and the taps use fused multiply-adds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// Dynamic shared memory of one block, in bytes.
long long smem_bytes(int C, int N, int act) {
  const long long p = kTileH * kTileW;
  const long long a_rows = (act == kGelu || C > N) ? C : N;
  const long long y_rows = act == kGelu ? 0 : N;
  const long long halo = (kTileH + 2) * (kTileW + 2);
  return 4 * ((a_rows + y_rows) * p + kChunkC * halo + kChunkC * kStrideW);
}

template <typename T>
cudaError_t launch(const void* mid, const void* skip, void* out,
                   const float* dw, const float* bdw, const float* pw,
                   const float* bpw, const float* gamma, const float* beta,
                   int B, int C, int N, int H, int W, int act,
                   cudaStream_t stream) {
  const int bytes = static_cast<int>(smem_bytes(C, N, act));
  auto kernel = fused_block_tail_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller gets the code
    return err;
  }
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(mid), static_cast<const T*>(skip),
      static_cast<T*>(out), dw, bdw, pw, bpw, gamma, beta, C, N, H, W, act);
  return cudaGetLastError();
}

}  // namespace

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
      smem_bytes(C, N, act) > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? launch<__nv_bfloat16>(mid, skip, out, dw, bdw, pw, bpw, gamma,
                                      beta, B, C, N, H, W, act, s)
              : launch<float>(mid, skip, out, dw, bdw, pw, bpw, gamma, beta,
                              B, C, N, H, W, act, s));
}
