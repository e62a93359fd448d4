// K3: the interleaved rans16 encode scan of format v4, read straight from
// the prep's [B, n] layout.
//
// Replaces the reverse lax.scan of mlic_tpu/entropy/device_rans.py:525
// (encode_scan_prepped) and the phase_order layout in front of it.  One
// thread walks one lane from step S-1 down to 0 (rANS is LIFO): the state x
// (uint32) starts at 2^16; a step emits x & 0xffff iff x >= freq << 16
// (uint32, so freq = 2^16 always emits), shifts it out, then sets
// x = (x / freq) << 16 + x % freq + start.  Positions and pads follow
// rans_layout.cuh; a pad codes (start 0, freq 2^16 - 1) and never escapes.
//
// Outputs: the final states x (int64 [L], L = B * n_lanes), the word of
// every position before its emit test (uint16 [S, L]) and, per (step,
// image, 32-lane word), the __ballot_sync mask of the lanes that emitted
// (uint32 [S, B, W], W = ceil(n_lanes / 32); below 32 lanes an image's
// bits sit at 0..n_lanes-1 of its own word).  K6 (rans_compact.cu) ranks
// the emitted words from the masks alone.
//
// Bound on this card: the S-step dependent chain of each lane, not bytes
// (about 10 B a position: 8 read, 2 written).  The design keeps only x on
// the chain of the one warp that runs it:
//  * warps: a block serves 32 lanes with one consumer warp, which runs the
//    chain and writes words and masks, and kProducers producer warps,
//    which prepare the steps; one warp doing both issued about 600 cycles
//    a step, ten times its chain;
//  * loads: producers stage the next chunk of kChunk steps of (start,
//    freq - 1) into shared memory with cp.async (two buffers; a pad is a
//    plain shared store) while they prepare the current one; each walks
//    its steps with a cursor, no division;
//  * stores: the consumer keeps a chunk's words in registers and its
//    ballots one a lane, puts them in shared memory after the chunk, and
//    the producers write them to device memory (a global store by the
//    consumer held x's register on the chain and made its next barrier
//    wait for the store);
//  * divide: a producer turns each frequency into a 52-bit reciprocal M
//    (make_prep), and the consumer computes q = (x * M) >> 52 as
//    (x * Mh + umulhi(x, Ml)) >> 20, exact for every x < 2^32 and freq in
//    [1, 2^16] (the proof is in device_rans.divmod_magic_plain); a step's
//    chain is a compare, a select, IMAD.HI, a 64-bit add, a funnel shift
//    and one IMAD (x + start + q * (2^16 - freq));
//  * hand-off: prepared chunks go through kSlots slots of shared memory,
//    each with a "full" and an "empty" named barrier (bar.arrive by the
//    side that hands over, bar.sync by the side that waits); "empty"
//    also hands the slot's words and ballots back to the producers;
//  * fill: 4096 lanes are 128 blocks, one an SM.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "rans_layout.cuh"
#include "launch_count.cuh"

namespace {

constexpr int kChunk = 32;            // steps prepared at a time
static_assert(kChunk == 32, "lane i of the consumer keeps step i's ballot");
constexpr int kSlots = 3;             // prepared chunks in flight
constexpr int kProducers = 8;         // producer warps a block
constexpr uint32_t kPadFreqm1 = 0xfffeu;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

struct __align__(16) Prep {   // one step of one lane, ready for the chain
  uint32_t m_lo, m_hi, start, freq;
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The reciprocal of freq for q = (x * M) >> 52.  Any M in (2^52 / freq,
// 2^52 / freq + 16) gives the exact quotient of every x < 2^32
// (device_rans.divmod_magic_plain); here M = floor(w) + 4 with w = 2^52 /
// freq from rcp.approx and two Newton steps, within a few units of 2^52 /
// freq and free of the slow-path branch of a correctly rounded reciprocal.
// chip_smoke.py holds the result against // for every freq in [1, 2^16]
// at the largest x of each remainder class that can fail first.
__device__ __forceinline__ Prep make_prep(uint32_t start, uint32_t freqm1) {
  const uint32_t freq = (freqm1 & 0xffffu) + 1u;
  const double d = static_cast<double>(freq);
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(d));
  y = fma(y, fma(-d, y, 1.0), y);
  y = fma(y, fma(-d, y, 1.0), y);
  const unsigned long long m =
      static_cast<unsigned long long>(y * 4503599627370496.0) + 4ull;
  return Prep{static_cast<uint32_t>(m), static_cast<uint32_t>(m >> 32),
              start & 0xffffu, freq};
}

// x / freq for any x < 2^32: (x * M) >> 52 = (x * Mh + umulhi(x, Ml)) >> 20.
__device__ __forceinline__ uint32_t quotient(uint32_t x, const Prep& p) {
  const unsigned long long t = __umulhi(x, p.m_lo);
  unsigned long long w;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(w) : "r"(x), "r"(p.m_hi), "l"(t));
  return static_cast<uint32_t>(w >> 20);
}

// One rans16 step after the emit test: shift out the emitted word, then
// x = (x / freq) << 16 + x % freq + start = x + start + q * (2^16 - freq).
__device__ __forceinline__ uint32_t encode_step(uint32_t x, bool emit,
                                                const Prep& p) {
  if (emit) x >>= 16;
  return x + p.start + quotient(x, p) * (65536u - p.freq);
}

// Named barriers: 1 + slot "full", 1 + kSlots + slot "empty".  Producer
// warp p takes rows p, p + kProducers, ... of every chunk, unrolled.
__global__ void __launch_bounds__(32 * (kProducers + 1))
rans_encode_kernel(EncodeLayout lay, const int32_t* __restrict__ z_start,
                   const int32_t* __restrict__ z_freqm1,
                   const int32_t* __restrict__ y_start,
                   const int32_t* __restrict__ y_freqm1,
                   long long* __restrict__ x_out,
                   uint16_t* __restrict__ words,
                   uint32_t* __restrict__ masks) {
  count_device_launch();
  extern __shared__ __align__(16) unsigned char smem[];
  int2* raw = reinterpret_cast<int2*>(smem);        // [2][kChunk][32]
  Prep* prep = reinterpret_cast<Prep*>(             // [kSlots][kChunk][32]
      smem + 2 * kChunk * 32 * sizeof(int2));
  uint32_t* out_words = reinterpret_cast<uint32_t*>(  // [kSlots][kChunk/2][32]
      prep + kSlots * kChunk * 32);
  uint32_t* out_masks =                              // [kSlots][kChunk]
      out_words + kSlots * (kChunk / 2) * 32;
  const int NT = blockDim.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * 32 + lane;
  const bool live = g < lay.lanes;         // lanes past L code pads only
  const int b = g >> lay.lane_shift;
  const int l = g & (lay.n_lanes - 1);
  const int S = lay.steps;
  const int n_chunks = (S + kChunk - 1) / kChunk;

  if (warp == 0) {                         // the consumer: the chain
    uint32_t x = 1u << 16;
    for (int c = 0; c < n_chunks; ++c) {
      const int slot = c % kSlots;
      const int n = min(kChunk, S - c * kChunk);
      named_sync(1 + slot, NT);
      const Prep* pr = prep + slot * kChunk * 32 + lane;
      // The chunk's words stay packed in registers and lane i keeps the
      // ballot of step i; both go to shared memory after the chunk, and the
      // producers write them out (a global store here would hold x's
      // register, and the next barrier would wait for the store).
      uint32_t packed[kChunk / 2] = {};
      uint32_t ballot_i = 0;
      auto step = [&](int i, const Prep& p) {
        const bool emit = x >= (p.freq << 16);
        const uint32_t ball = __ballot_sync(kFull, emit);
        if (lane == i) ballot_i = ball;
        packed[i >> 1] |= (x & 0xffffu) << (16 * (i & 1));
        x = encode_step(x, emit, p);
      };
      if (n == kChunk) {                   // the next step's load ahead
        Prep next = pr[0];
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          const Prep p = next;
          if (i + 1 < kChunk) next = pr[(i + 1) * 32];
          step(i, p);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kChunk; ++i)
          if (i < n) step(i, pr[i * 32]);
      }
      uint32_t* ow = out_words + slot * (kChunk / 2) * 32 + lane;
#pragma unroll
      for (int k = 0; k < kChunk / 2; ++k) ow[k * 32] = packed[k];
      out_masks[slot * kChunk + lane] = ballot_i;
      named_arrive(1 + kSlots + slot, NT);
    }
    if (live) x_out[g] = static_cast<long long>(x);
    return;
  }

  // a producer: rows i = p + P r of every chunk, for the block's lanes.
  // Its steps S - 1 - p, S - 1 - p - P, ... are walked by a cursor (k, js):
  // section k (-1 for z, else the y phase) and step js within it.
  constexpr int P = kProducers;
  constexpr int R = kChunk / P;
  const int p = warp - 1;
  const bool wide = lay.n_lanes >= 32;
  const uint32_t low = wide ? 0xffffffffu : (1u << lay.n_lanes) - 1u;
  const size_t L = lay.lanes;
  const size_t mask_stride =
      static_cast<size_t>(lay.n_images) * lay.words_per_step;
  const int b0 = (blockIdx.x * 32) >> lay.lane_shift;   // first image here
  int k = -1, js = S - 1 - p;
  if (js >= lay.steps_z && lay.steps_per > 0) {
    const int t = js - lay.steps_z;
    k = t / lay.steps_per;
    js = t - k * lay.steps_per;
  }
  auto stage = [&](int c, int buf) {       // cp.async a chunk's raw inputs
    const int n = min(kChunk, S - c * kChunk);
    int2* dst = raw + buf * kChunk * 32 + lane;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = p + P * r;
      if (i >= n) break;
      const int j = (js << lay.lane_shift) + l;
      int idx = -1;
      if (live) {
        if (k < 0)
          idx = j < lay.n_z ? b * lay.n_z + j : -1;
        else
          idx = j < lay.n_per ? b * lay.n_y + k * lay.n_per + j : -1;
      }
      int2* d = dst + i * 32;
      if (idx < 0) {
        *d = make_int2(0, static_cast<int>(kPadFreqm1));
      } else {
        cp_async4(&d->x, (k < 0 ? z_start : y_start) + idx);
        cp_async4(&d->y, (k < 0 ? z_freqm1 : y_freqm1) + idx);
      }
      js -= P;                             // the next row: P steps down
      while (js < 0 && k >= 0) {
        if (k > 0) {
          --k;
          js += lay.steps_per;
        } else {
          k = -1;
          js += lay.steps_z;
        }
      }
    }
    cp_async_commit();
  };
  auto write_out = [&](int c, int slot) {  // chunk c's words and masks
    const int s0 = S - 1 - c * kChunk;
    const int n = min(kChunk, s0 + 1);
    const uint32_t* ow = out_words + slot * (kChunk / 2) * 32 + lane;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = p + P * r;
      if (i >= n) break;
      const size_t row = static_cast<size_t>(s0 - i);
      if (live)
        words[row * L + g] =
            static_cast<uint16_t>(ow[(i >> 1) * 32] >> (16 * (i & 1)));
      const uint32_t ball = out_masks[slot * kChunk + i];
      uint32_t* mrow = masks + row * mask_stride;
      if (wide) {
        if (lane == 0 && live) mrow[g >> 5] = ball;
      } else if (lane < (32 >> lay.lane_shift) && b0 + lane < lay.n_images) {
        mrow[b0 + lane] = (ball >> (lane << lay.lane_shift)) & low;
      }
    }
  };
  if (n_chunks > 0) stage(0, 0);
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      stage(c + 1, (c + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const int slot = c % kSlots;
    const int n = min(kChunk, S - c * kChunk);
    const int2* src = raw + (c & 1) * kChunk * 32 + lane;
    Prep out[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int2 sf = src[(p + P * r) * 32];
      out[r] = make_prep(static_cast<uint32_t>(sf.x),
                         static_cast<uint32_t>(sf.y));
    }
    if (c >= kSlots) {                     // the slot's last chunk is done
      named_sync(1 + kSlots + slot, NT);
      write_out(c - kSlots, slot);
    }
    Prep* dst = prep + slot * kChunk * 32 + lane;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (p + P * r < n) dst[(p + P * r) * 32] = out[r];
    named_arrive(1 + slot, NT);
  }
  for (int c = max(0, n_chunks - kSlots); c < n_chunks; ++c) {
    named_sync(1 + kSlots + c % kSlots, NT);
    write_out(c, c % kSlots);
  }
}

// The divide of a step alone, for the check on the card: q = x / freq.
__global__ void divmod_kernel(const uint32_t* __restrict__ x,
                              const uint32_t* __restrict__ freq,
                              uint32_t* __restrict__ q, long long n) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i < n) q[i] = quotient(x[i], make_prep(0, freq[i] - 1u));
}

// raw, prep, out_words and out_masks of rans_encode_kernel
constexpr size_t kSmemBytes =
    kChunk * 32 * (2 * sizeof(int2) + kSlots * sizeof(Prep)) +
    kSlots * kChunk * (kChunk / 2 + 1) * sizeof(uint32_t);

}  // namespace

extern "C" int rans_encode_launch(const int32_t* z_start,
                                  const int32_t* z_freqm1,
                                  const int32_t* y_start,
                                  const int32_t* y_freqm1, long long* x_out,
                                  uint16_t* words, uint32_t* masks,
                                  int n_images, int n_lanes, int n_z,
                                  int n_per, int n_phases, void* stream) {
  EncodeLayout lay;
  if (!make_encode_layout(&lay, n_images, n_lanes, n_z, n_per, n_phases))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool ready[kMaxDevices];          // the shared-memory attribute set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(rans_encode_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  rans_encode_kernel<<<(lay.lanes + 31) / 32, 32 * (kProducers + 1),
                       kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      lay, z_start, z_freqm1, y_start, y_freqm1, x_out, words, masks);
  return static_cast<int>(cudaGetLastError());
}

// q = x / freq by K3's reciprocal, n entries (freq in [1, 2^16]).
extern "C" int rans_divmod_launch(const uint32_t* x, const uint32_t* freq,
                                  uint32_t* q, long long n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  divmod_kernel<<<static_cast<unsigned>((n + threads - 1) / threads), threads,
                  0, static_cast<cudaStream_t>(stream)>>>(x, freq, q, n);
  return static_cast<int>(cudaGetLastError());
}

MLIC_DEVICE_LAUNCH_COUNTER(rans_encode_scan)
