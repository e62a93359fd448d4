// K6: the format-v4 compaction of the rANS encode, from K3's outputs to the
// per-image word blocks and escape side channel.
//
// Replaces compact_streams_global (mlic_tpu/entropy/device_rans.py:602; XLA
// there, a cumsum and scatters with boolean masks in the port's plain
// version).  Per image b, with the positions of rans_layout.cuh:
//   img_n[b]  = 2 * n_lanes + the image's emitted words;
//   buf       = image blocks back to back: 2 * n_lanes state words ([hi, lo]
//               of each lane), then the emitted words in (step, lane)
//               order: a word's place is its image's begin + 2 * n_lanes +
//               its rank, an exclusive scan of the popcounts of K3's
//               (step, 32-lane word) masks plus popc(mask & lanes below);
//   ebuf      = each image's escaped symbols in position order, ecount[b]
//               of them, images back to back.
//
// One cooperative launch, no atomics, nothing read back to the host:
//  1. every block takes work items (an image's run of steps, one mask word a
//     thread), ballots the items' escape flags into masks of their own
//     (scratch ``emasks``) and writes each item's (words, escapes) count;
//  2. grid barrier;
//  3. every block scans all item counts (a few hundred pairs) for its own
//     items' offsets, block 0 writes img_n and ecount, and each item writes
//     its words, its escapes and, for an image's first item, the state
//     words.
// Bound on this card: bytes (masks, the emitted words and escaped symbols,
// one escape flag a position), a few microseconds; the grid barrier and the
// two passes cost about as much again.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rans_layout.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kOwnMax = 32;            // items a block carries over the barrier
constexpr int kBatch = 8;              // mask words a warp loads at once
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

struct Plan {
  int steps_per_item, items_per_image, n_items, word_shift;
};

__device__ __forceinline__ int2 add2(int2 a, int2 b) {
  return make_int2(a.x + b.x, a.y + b.y);
}

// Exclusive scan of one pair a thread over the block, in thread order;
// ``*total`` receives the block's sum.  Every thread of the block calls it.
__device__ int2 block_exclusive_scan(int2 v, int2* total) {
  __shared__ int2 warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int2 inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int a = __shfl_up_sync(kFull, inc.x, o);
    const int b = __shfl_up_sync(kFull, inc.y, o);
    if (lane >= o) inc = add2(inc, make_int2(a, b));
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  int2 base = make_int2(0, 0), tot = make_int2(0, 0);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int2 s = warp_sums[w];
    if (w < warp) base = add2(base, s);
    tot = add2(tot, s);
  }
  __syncthreads();                    // warp_sums is reused by the next call
  *total = tot;
  return make_int2(base.x + inc.x - v.x, base.y + inc.y - v.y);
}

__global__ void __launch_bounds__(kThreads)
rans_compact_kernel(EncodeLayout lay, Plan plan,
                    const uint32_t* __restrict__ masks,
                    const uint16_t* __restrict__ words,
                    const long long* __restrict__ x,
                    const bool* __restrict__ z_esc,
                    const int32_t* __restrict__ z_sym,
                    const bool* __restrict__ y_esc,
                    const int32_t* __restrict__ y_sym, uint32_t* emasks,
                    int2* agg, uint16_t* __restrict__ buf,
                    int* __restrict__ img_n, int* __restrict__ ebuf,
                    int* __restrict__ ecount) {
  __shared__ int2 own[kOwnMax];
  __shared__ int2 part[kWarps];
  __shared__ uint32_t tile_mask[kThreads];
  __shared__ uint32_t tile_emask[kThreads];
  __shared__ int2 tile_base[kThreads];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t below = (1u << lane) - 1u;
  const int W = lay.words_per_step;
  const int nl = lay.n_lanes;
  const int word_lanes = nl < 32 ? nl : 32;
  const int S = lay.steps;
  const int ipi = plan.items_per_image;

  // 1. escape masks and each item's counts; a warp takes its mask words
  // kBatch at a time, all loads first
  for (int item = blockIdx.x; item < plan.n_items; item += gridDim.x) {
    const int b = item / ipi;
    const int s_lo = (item - b * ipi) * plan.steps_per_item;
    const int n_words = min(plan.steps_per_item, S - s_lo) * W;
    int2 cnt = make_int2(0, 0);
    for (int m0 = warp; m0 < n_words; m0 += kWarps * kBatch) {
      bool e[kBatch];
      uint32_t mk[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int m = m0 + u * kWarps;
        e[u] = false;
        mk[u] = 0;
        if (m >= n_words) continue;
        const int s = s_lo + (m >> plan.word_shift);
        const int w = m & (W - 1);
        if (lane < word_lanes) {
          bool in_y;
          const int idx = encode_source(lay, s, b, w * 32 + lane, &in_y);
          if (idx >= 0) e[u] = (in_y ? y_esc : z_esc)[idx];
        }
        if (lane == 0)
          mk[u] = masks[(static_cast<size_t>(s) * lay.n_images + b) * W + w];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int m = m0 + u * kWarps;
        if (m >= n_words) break;
        const uint32_t em = __ballot_sync(kFull, e[u]);
        if (lane == 0) {
          const int s = s_lo + (m >> plan.word_shift);
          emasks[(static_cast<size_t>(s) * lay.n_images + b) * W +
                 (m & (W - 1))] = em;
          cnt = add2(cnt, make_int2(__popc(mk[u]), __popc(em)));
        }
      }
    }
    if (lane == 0) part[warp] = cnt;
    __syncthreads();
    if (threadIdx.x == 0) {
      int2 t = make_int2(0, 0);
      for (int w = 0; w < kWarps; ++w) t = add2(t, part[w]);
      agg[item] = t;
    }
    __syncthreads();
  }

  cg::this_grid().sync();

  // 2. offsets of this block's items: an exclusive scan over all items
  int2 carry = make_int2(0, 0);
  for (int t0 = 0; t0 < plan.n_items; t0 += kThreads) {
    const int i = t0 + threadIdx.x;
    const int2 v = i < plan.n_items ? agg[i] : make_int2(0, 0);
    int2 tot;
    const int2 ex = add2(block_exclusive_scan(v, &tot), carry);
    if (i < plan.n_items && i % gridDim.x == blockIdx.x)
      own[i / gridDim.x] = ex;
    carry = add2(carry, tot);
  }
  if (blockIdx.x == 0) {
    for (int b = threadIdx.x; b < lay.n_images; b += kThreads) {
      int2 t = make_int2(0, 0);
      for (int c = 0; c < ipi; ++c) t = add2(t, agg[b * ipi + c]);
      img_n[b] = 2 * nl + t.x;
      ecount[b] = t.y;
    }
  }
  __syncthreads();

  // 3. each item's words, escapes and (first item of an image) states
  for (int k = 0, item = blockIdx.x; item < plan.n_items;
       ++k, item += gridDim.x) {
    const int b = item / ipi;
    const int s_lo = (item - b * ipi) * plan.steps_per_item;
    const int n_words = min(plan.steps_per_item, S - s_lo) * W;
    const int2 pre = own[k];
    const int w_base = 2 * nl * (b + 1) + pre.x;   // first renorm word's place
    if (s_lo == 0) {
      const int img_begin = w_base - 2 * nl;
      for (int l = threadIdx.x; l < nl; l += kThreads) {
        const uint32_t xv = static_cast<uint32_t>(x[b * nl + l]);
        buf[img_begin + 2 * l] = static_cast<uint16_t>(xv >> 16);
        buf[img_begin + 2 * l + 1] = static_cast<uint16_t>(xv);
      }
    }
    int2 run = make_int2(0, 0);
    for (int m0 = 0; m0 < n_words; m0 += kThreads) {
      const int m = m0 + threadIdx.x;
      uint32_t mk = 0, ek = 0;
      if (m < n_words) {
        const int s = s_lo + (m >> plan.word_shift);
        const size_t gi = (static_cast<size_t>(s) * lay.n_images + b) * W +
                          (m & (W - 1));
        mk = masks[gi];
        ek = emasks[gi];
      }
      int2 tot;
      const int2 ex = block_exclusive_scan(make_int2(__popc(mk), __popc(ek)),
                                           &tot);
      tile_mask[threadIdx.x] = mk;
      tile_emask[threadIdx.x] = ek;
      tile_base[threadIdx.x] = add2(ex, run);
      __syncthreads();
      const int nm = min(kThreads, n_words - m0);
      for (int j0 = warp; j0 < nm; j0 += kWarps * kBatch) {
        uint16_t wv[kBatch];
        int ev[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {           // loads first
          const int j = j0 + u * kWarps;
          if (j >= nm) break;
          const int mm = m0 + j;
          const int s = s_lo + (mm >> plan.word_shift);
          const int l = (mm & (W - 1)) * 32 + lane;
          if ((tile_mask[j] >> lane) & 1u)
            wv[u] = words[static_cast<size_t>(s) * lay.lanes + b * nl + l];
          if ((tile_emask[j] >> lane) & 1u) {
            bool in_y;
            const int idx = encode_source(lay, s, b, l, &in_y);
            ev[u] = (in_y ? y_sym : z_sym)[idx];
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {           // then the stores
          const int j = j0 + u * kWarps;
          if (j >= nm) break;
          const uint32_t bits = tile_mask[j];
          const uint32_t ebits = tile_emask[j];
          const int2 base = tile_base[j];
          if ((bits >> lane) & 1u)
            buf[w_base + base.x + __popc(bits & below)] = wv[u];
          if ((ebits >> lane) & 1u)
            ebuf[pre.y + base.y + __popc(ebits & below)] = ev[u];
        }
      }
      run = add2(run, tot);
      __syncthreads();
    }
  }
}

}  // namespace

// Scratch: emasks uint32 [S * B * W]; agg int32 [2 * B * max(S, 1)].
// Outputs: buf uint16 [S * L + 2 * L], img_n int32 [B], ebuf int32
// [max(S * L, 1)], ecount int32 [B].
extern "C" int rans_compact_launch(const uint32_t* masks, const uint16_t* words,
                                   const long long* x, const bool* z_esc,
                                   const int32_t* z_sym, const bool* y_esc,
                                   const int32_t* y_sym, uint32_t* emasks,
                                   int* agg, uint16_t* buf, int* img_n,
                                   int* ebuf, int* ecount, int n_images,
                                   int n_lanes, int n_z, int n_per,
                                   int n_phases, void* stream) {
  EncodeLayout lay;
  if (!make_encode_layout(&lay, n_images, n_lanes, n_z, n_per, n_phases))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  static int resident_of[kMaxDevices];     // blocks that fit the card at once
  int resident = resident_of[dev];
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, rans_compact_kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = resident_of[dev] = sms * per_sm;
  }
  if (resident < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);

  Plan plan;
  plan.word_shift = 0;
  while ((1 << plan.word_shift) < lay.words_per_step) ++plan.word_shift;
  plan.steps_per_item = kThreads / lay.words_per_step;   // >= 8 (W <= 32)
  for (;;) {
    const int ipi = (lay.steps + plan.steps_per_item - 1) / plan.steps_per_item;
    plan.items_per_image = ipi > 0 ? ipi : 1;
    plan.n_items = lay.n_images * plan.items_per_image;
    if (plan.n_items <= resident * kOwnMax) break;
    plan.steps_per_item *= 2;
    if (plan.items_per_image == 1)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = plan.n_items < resident ? plan.n_items : resident;
  int2* agg2 = reinterpret_cast<int2*>(agg);
  void* args[] = {&lay,   &plan,  &masks, &words,  &x,    &z_esc,
                  &z_sym, &y_esc, &y_sym, &emasks, &agg2, &buf,
                  &img_n, &ebuf,  &ecount};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(rans_compact_kernel), dim3(grid),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
