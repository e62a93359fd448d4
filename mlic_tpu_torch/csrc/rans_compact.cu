// K6: the format-v4 compaction of the rANS encode, from K3's outputs to the
// per-image word blocks and escape side channel.
//
// Replaces compact_streams_global (mlic_tpu/entropy/device_rans.py:602; XLA
// there, a cumsum and scatters with boolean masks in the port's plain
// version).  Per image b, with the positions of rans_layout.cuh:
//   img_n[b]  = 2 * n_lanes + the image's emitted words;
//   buf       = image blocks back to back: 2 * n_lanes state words ([hi, lo]
//               of each lane), then the emitted words in (step, lane)
//               order;
//   ebuf      = each image's escaped symbols in position order, ecount[b]
//               of them, images back to back.
//
// Bound on this card: bytes (K3's masks, the emitted words and escaped
// symbols, one escape flag a position), about 0.0016 ms at the serving
// batch.  The first version (one cooperative launch: a pass that counted
// each work item and wrote escape masks to scratch, a grid barrier, then
// every block scanning all item counts and re-reading everything) took
// 0.0299 ms, 19 times that: the barrier, the second read and the scans,
// not the bytes.
//
// Design: one pass, a scan with decoupled look-back (Merrill and Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016).
// A work item is an image's run of 256 / W steps (W mask words a step), one
// mask word -- 32 positions -- a thread; items are numbered image-major
// and one block takes one.  Each block
//  1. takes its item id from a ticket counter (atomicAdd), in the order in
//     which blocks start, so that it waits only on items that started
//     before it (forward progress without a cooperative launch);
//  2. loads, a thread its mask word: the mask, the 32 escape flags (two
//     16-byte loads) and the 32 words (four), all independent, so that
//     one memory latency covers them; the escape mask comes from the flag
//     bytes themselves.  Runs that are not 16-byte aligned or end in a pad
//     (ragged sections, fewer than 32 lanes) load element by element.  (A
//     warp that walked its 32 mask words a word at a time, loading each
//     word's flags and ballotting them, was slower than the old kernel:
//     the compiler put each ballot right after its load, so a block waited
//     out one memory latency a word);
//  3. scans the (words, escapes) counts of its mask words over the block
//     and stages each emitted word in shared memory at its rank within
//     the item: an item's words are one run of buf;
//  4. publishes the item's total as its aggregate and walks back over its
//     predecessors' statuses, 256 at a time (one a thread), summing
//     aggregates until it meets an inclusive prefix; then publishes its own
//     inclusive prefix;
//  5. copies its words to buf at 2 * n_lanes * (b + 1) + the exclusive word
//     prefix (all images' words before it), coalesced, and writes its
//     escaped symbols at the exclusive escape prefix + their rank; an
//     image's first item writes the state words, its last img_n[b] and
//     ecount[b].
//
// Statuses and their epoch.  The wrapper owns, per device and stream, a
// control block (ticket, done count, epoch) and one status per item, zeroed
// when they are made: nothing is reset by a launch of its own.  A status
// is {tag, aggregate (words, escapes), inclusive prefix (words, escapes)};
// tag = epoch << 2 | flag (1 aggregate, 2 inclusive prefix, 0 never
// published).  The counts are stored first and the tag after them with
// release semantics; a reader loads the tag with acquire semantics and
// takes only a tag of the current epoch, so a status left from an earlier
// launch (or zeroed memory) is never read as ready, and the aggregate and
// prefix live apart, so a reader that saw the aggregate's tag never reads
// a half-written prefix.  Words and escapes are below 2^31 each (the
// layout's position limit); the epoch has 62 bits and never wraps.  The
// last block to finish (done count) sets the ticket and the done count
// back to 0 and advances the epoch.  A launch's arguments are thus the
// same on every call: replayed from a CUDA graph, each replay still sees a
// ticket of 0 and a fresh epoch, which a host-side counter baked into the
// arguments would not give.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rans_layout.cuh"

namespace {

constexpr int kThreads = 256;           // one mask word a thread
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kAggregate = 1, kPrefix = 2;

struct Control {
  unsigned int ticket;                  // the next item id
  unsigned int done;                    // blocks finished in this launch
  unsigned long long epoch;             // launches finished
};

struct Status {
  unsigned long long tag;               // epoch << 2 | flag
  int2 aggregate;                       // the item's (words, escapes)
  int2 prefix;                          // inclusive, over all items
};

__device__ __forceinline__ int2 add2(int2 a, int2 b) {
  return make_int2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// Stores the counts, then the tag that makes them visible.
__device__ __forceinline__ void publish(Status* st, unsigned long long epoch,
                                        unsigned long long flag, int2 v) {
  __stcg(flag == kPrefix ? &st->prefix : &st->aggregate, v);
  store_release(&st->tag, (epoch << 2) | flag);
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
  *total = tot;
  return make_int2(base.x + inc.x - v.x, base.y + inc.y - v.y);
}

// The whole block: publishes the item's aggregate, looks back for its
// exclusive prefix, kThreads predecessors a round (thread t the t-th
// nearest), and publishes its inclusive prefix; returns the exclusive
// prefix (in every thread).
__device__ int2 look_back(Status* status, int item, unsigned long long epoch,
                          int2 agg) {
  __shared__ int s_stop[kWarps];
  __shared__ int2 s_sum[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int2 excl = make_int2(0, 0);
  if (item > 0) {
    if (tid == 0) publish(status + item, epoch, kAggregate, agg);
    for (int end = item - 1;; end -= kThreads) {
      const int i = end - tid;
      unsigned long long flag = kPrefix; // before item 0: a prefix of 0
      int2 v = make_int2(0, 0);
      if (i >= 0) {
        unsigned long long t;
        do {
          t = load_acquire(&status[i].tag);
        } while ((t >> 2) != epoch || (t & 3) == 0);
        flag = t & 3;
        v = __ldcg(flag == kPrefix ? &status[i].prefix
                                   : &status[i].aggregate);
      }
      // the nearest inclusive prefix ends the walk: sum up to it
      const int w_stop =
          __reduce_min_sync(kFull, flag == kPrefix ? tid : kThreads);
      if (lane == 0) s_stop[warp] = w_stop;
      __syncthreads();
      int stop = kThreads;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) stop = min(stop, s_stop[w]);
      if (tid > stop) v = make_int2(0, 0);
      const int sx = __reduce_add_sync(kFull, v.x);
      const int sy = __reduce_add_sync(kFull, v.y);
      if (lane == 0) s_sum[warp] = make_int2(sx, sy);
      __syncthreads();
#pragma unroll
      for (int w = 0; w < kWarps; ++w) excl = add2(excl, s_sum[w]);
      __syncthreads();                   // s_stop and s_sum are reused
      if (stop < kThreads) break;
    }
  }
  if (tid == 0) publish(status + item, epoch, kPrefix, add2(excl, agg));
  return excl;
}

// 4 flag bytes (0 or 1 each) -> 4 bits
__device__ __forceinline__ uint32_t flag_bits(uint32_t v) {
  return (v & 1u) | ((v >> 7) & 2u) | ((v >> 14) & 4u) | ((v >> 21) & 8u);
}

// 16 flag bytes -> 16 bits
__device__ __forceinline__ uint32_t flag_bits(uint4 v) {
  return flag_bits(v.x) | (flag_bits(v.y) << 4) | (flag_bits(v.z) << 8) |
         (flag_bits(v.w) << 12);
}

__global__ void __launch_bounds__(kThreads, 2)
rans_compact_kernel(EncodeLayout lay, int steps_per_item, int items_per_image,
                    int word_shift, const uint32_t* __restrict__ masks,
                    const uint16_t* __restrict__ words,
                    const long long* __restrict__ x,
                    const bool* __restrict__ z_esc,
                    const int32_t* __restrict__ z_sym,
                    const bool* __restrict__ y_esc,
                    const int32_t* __restrict__ y_sym, Control* ctl,
                    Status* status, uint16_t* __restrict__ buf,
                    int* __restrict__ img_n, int* __restrict__ ebuf,
                    int* __restrict__ ecount) {
  __shared__ int s_item;
  __shared__ unsigned long long s_epoch;
  __shared__ uint16_t s_out[kThreads * 32];    // the item's emitted words

  const int tid = threadIdx.x;
  if (tid == 0) {
    s_item = static_cast<int>(atomicAdd(&ctl->ticket, 1u));
    s_epoch = *reinterpret_cast<volatile unsigned long long*>(&ctl->epoch);
  }
  __syncthreads();
  const int item = s_item;
  const unsigned long long epoch = s_epoch;
  const int ipi = items_per_image;
  const int b = item / ipi;
  const int s_lo = (item - b * ipi) * steps_per_item;
  const int W = lay.words_per_step;
  const int nl = lay.n_lanes;
  const int n_words = max(0, min(steps_per_item, lay.steps - s_lo)) * W;

  // 1. this thread's mask word: its mask, its 32 words (word i in half
  // i & 1 of wp[i / 2]) and its escape mask
  uint32_t mk = 0, ek = 0;
  int src = 0;
  bool in_y = false;
  uint32_t wp[16] = {};
  if (tid < n_words) {
    const int s = s_lo + (tid >> word_shift);
    const int w = tid & (W - 1);
    mk = masks[(static_cast<size_t>(s) * lay.n_images + b) * W + w];
    const int wb = s * lay.lanes + b * nl + w * 32;
    if (wb + 32 <= lay.steps * lay.lanes && (wb & 7) == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(words + wb) + k);
        wp[4 * k] = q.x;
        wp[4 * k + 1] = q.y;
        wp[4 * k + 2] = q.z;
        wp[4 * k + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if ((mk >> i) & 1u)
          wp[i >> 1] |= static_cast<uint32_t>(words[wb + i]) << (16 * (i & 1));
    }
    int valid;
    src = encode_run(lay, s, b, w * 32, &in_y, &valid);
    const uint8_t* fp =
        reinterpret_cast<const uint8_t*>(in_y ? y_esc : z_esc) + src;
    const long long sec = static_cast<long long>(lay.n_images) *
                          (in_y ? lay.n_y : lay.n_z);
    if (valid > 0 && src + 32 <= sec &&
        (reinterpret_cast<uintptr_t>(fp) & 15) == 0) {
      const uint4 f0 = __ldg(reinterpret_cast<const uint4*>(fp));
      const uint4 f1 = __ldg(reinterpret_cast<const uint4*>(fp) + 1);
      ek = flag_bits(f0) | (flag_bits(f1) << 16);
      if (valid < 32) ek &= (1u << valid) - 1u;
    } else {
      for (int i = 0; i < valid; ++i) ek |= static_cast<uint32_t>(fp[i]) << i;
    }
  }

  // 2. ranks within the item; the emitted words staged at theirs
  int2 tot;
  const int2 ex = block_exclusive_scan(make_int2(__popc(mk), __popc(ek)),
                                       &tot);
  {
    int k = ex.x;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if ((mk >> i) & 1u)
        s_out[k++] = static_cast<uint16_t>(wp[i >> 1] >> (16 * (i & 1)));
  }
  __syncthreads();

  // 3. the item's place among all items
  const int2 pre = look_back(status, item, epoch, tot);

  // 4. the writes
  const int w_base = 2 * nl * (b + 1) + pre.x;   // first renorm word's place
  if (s_lo == 0) {
    const int img_begin = w_base - 2 * nl;
    for (int l = tid; l < nl; l += kThreads) {
      const uint32_t xv = static_cast<uint32_t>(x[b * nl + l]);
      buf[img_begin + 2 * l] = static_cast<uint16_t>(xv >> 16);
      buf[img_begin + 2 * l + 1] = static_cast<uint16_t>(xv);
    }
  }
  if (item == b * ipi + ipi - 1 && tid == 0) {
    // the image's totals: this item's inclusive prefix less the one at the
    // end of the previous image (an earlier item: it publishes in time)
    int2 before = make_int2(0, 0);
    if (b > 0) {
      Status* prev = status + b * ipi - 1;
      unsigned long long t;
      do {
        t = load_acquire(&prev->tag);
      } while (t != ((epoch << 2) | kPrefix));
      before = __ldcg(&prev->prefix);
    }
    img_n[b] = 2 * nl + pre.x + tot.x - before.x;
    ecount[b] = pre.y + tot.y - before.y;
  }
  for (int j = tid; j < tot.x; j += kThreads) buf[w_base + j] = s_out[j];
  const int32_t* sp = (in_y ? y_sym : z_sym) + src;
  for (int k = pre.y + ex.y; ek; ek &= ek - 1u, ++k)
    ebuf[k] = sp[__ffs(ek) - 1];

  // the last block to finish leaves the control block for the next launch
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(&ctl->done, 1u) == gridDim.x - 1) {
      ctl->ticket = 0;
      ctl->done = 0;
      ctl->epoch = epoch + 1;
    }
  }
}

}  // namespace

// control: 16 B the caller zeroes once and passes to every launch on one
// stream; status: 24 B an item, zeroed when allocated, for at least
// n_images * items_per_image items.  The plan (steps_per_item = 256 / W
// steps, items_per_image = ceil(steps / steps_per_item), at least 1) is the
// caller's, checked here.  Outputs: buf uint16 [S * L + 2 * L], img_n int32
// [B], ebuf int32 [max(S * L, 1)], ecount int32 [B].
extern "C" int rans_compact_launch(const uint32_t* masks, const uint16_t* words,
                                   const long long* x, const bool* z_esc,
                                   const int32_t* z_sym, const bool* y_esc,
                                   const int32_t* y_sym, void* control,
                                   void* status, uint16_t* buf, int* img_n,
                                   int* ebuf, int* ecount, int n_images,
                                   int n_lanes, int n_z, int n_per,
                                   int n_phases, int steps_per_item,
                                   int items_per_image, void* stream) {
  EncodeLayout lay;
  if (!make_encode_layout(&lay, n_images, n_lanes, n_z, n_per, n_phases))
    return static_cast<int>(cudaErrorInvalidValue);
  if (steps_per_item * lay.words_per_step != kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int want = (lay.steps + steps_per_item - 1) / steps_per_item;
  if (
      items_per_image != (want > 0 ? want : 1) ||
      static_cast<long long>(n_images) * items_per_image >= (1ll << 31) ||
      control == nullptr || status == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  int word_shift = 0;
  while ((1 << word_shift) < lay.words_per_step) ++word_shift;
  rans_compact_kernel<<<n_images * items_per_image, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      lay, steps_per_item, items_per_image, word_shift, masks, words, x,
      z_esc, z_sym, y_esc, y_sym, static_cast<Control*>(control),
      static_cast<Status*>(status), buf, img_n, ebuf, ecount);
  return static_cast<int>(cudaGetLastError());
}
