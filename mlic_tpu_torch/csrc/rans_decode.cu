// Interleaved rans16 decode of one coding phase, stream format v3/v4
// (global emission order).
//
// Replaces the lax.scan of mlic_tpu/entropy/device_rans.py:169
// (make_decoder, fmt="global"): the parametric step (_step_parametric :277),
// the integer-row step of the v4 z section (_step_rowtab :237) and the
// renormalization (_renorm_global :152).  The escape patch stays in PyTorch.
//
// Both modes read one row index a position (rows, int32 [S, B*n_lanes]).
// Per step and lane:
//  * parametric mode: the row's six constants (m, b, A, C, B, L), selected
//    from the Gaussian row-parameter table that each block stages in its
//    shared memory (<= 128 rows x 6 f32; rows outside the table take row 0,
//    as select_rows does), give the slot of cf on the shared cdf_eval
//    (cdf.cuh) over [0, L]; cf == 2^16-1 is the escape (its cdf slot has
//    frequency 1 in every row).  Selecting in shared memory reads 4 B a
//    position, where six selected f32 planes in device memory would be
//    24 B, and needs no row-select launch before each phase;
//  * row-table mode: the slot of cf in the integer CDF row cdf_rows[row]
//    (factorized-prior rows of the z section);
//  * x = freq * (x >> 16) + cf - start (uint32), then the lanes whose state
//    fell below 2^16 read one 16-bit word each.  Words are stored in
//    (step, lane) consumption order per image, so a lane's word sits at the
//    image pointer plus its exclusive rank among this step's reading lanes.
// The carry (x per lane, word pointer per image) is read from x_in/ptr_in
// and written to x_out/ptr_out, so one decode chains the z section and the
// y phases through device tensors.
//
// Bound on this card: bytes, 9 B per position (a row index, the symbol
// and escape flag written, a share of the words); the f32 work is as
// small.  What sets the time is the
// latency of the serial chain: S steps, each a search of the CDF and a
// rank across the image's lanes.  The first version searched by a
// 12-level bisection per lane and ran one block per image, on 8 of 132
// SMs: 0.165 ms per y phase (NVIDIA H100 80GB HBM3, 700 W).
//
// Design.  Both CDFs are strictly increasing in the slot, so the slot is
// the unique largest k in [0, hi) with cdf(k) <= cf, and any search that
// finds it gives the bisection's result bit for bit:
//  * a group of T threads serves one lane and searches T-ways: each round
//    the T-1 inner split points of [lo, hi] are evaluated in parallel and
//    a ballot within the group picks the sub-interval, so the n_steps
//    levels of the bisection take ceil(n_steps / log2 T) rounds (12
//    levels: 4 rounds at T = 8).  The first round does not depend on cf,
//    so it is evaluated a step ahead, in the same straight-line code as the
//    previous step's second round.  The points lo and hi themselves are
//    never used, as in the bisection, whose cdf(0) and cdf(hi) are the
//    conventions v_lo = 0 and v_hi = 2^16-1 (parametric) or 2^16 (rows).
//    Every thread of a group keeps the same state, so the update and the
//    word read need no broadcast; the group's first thread stores.
//  * an image's lanes span a thread-block cluster of up to 8 blocks of at
//    most 512 threads (cluster_blocks()), so that the evaluations spread
//    over 8 SMs: T = 8 up to 512 lanes (16 lanes: one block; 256: 4; 512:
//    8), T = 4 at 1024 lanes (8 blocks; T = 8 there would put 32 warps on
//    an SM, and a round would wait on all of their issue slots).  The rank
//    of a reading lane is its rank in its warp (ballot and popcount over
//    the groups' first threads) plus the readers of the block's lower warps
//    (shared memory and a warp reduction) plus those of the cluster's
//    lower blocks: each block stores its count, tagged with the step, into
//    every block's shared memory (distributed shared memory), and waits on
//    its own copy -- no cluster-wide barrier a step.
//  * blocks are whole warps, so every ballot and shuffle names the full
//    warp by a constant mask (a computed one costs each of them a
//    convergence check in the loop).
// Latency floor per step: ceil(n_steps / log2 T) - 1 dependent rounds,
// each one cdf_eval (erfcf: a polynomial, two reciprocals and an
// exponential, one dependent chain) plus a ballot and two shuffles, then
// a block barrier and one exchange of counts across the cluster, and the
// word read.  At 512 lanes and T = 8 there are 16 warps on each SM, so a
// round waits for the issue slots of all of them as much as for its own
// chain.  Measured (chip_smoke.py, same card): 0.108-0.115 ms per y phase
// by CUDA events (0.083-0.107 by the profiler, whose readings move between
// hosts), about 2.3 us a step.  The plain PyTorch statement of the search
// is kary_search_plain in mlic_tpu_torch/entropy/device_rans.py.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cdf.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;   // per block
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kMaxParamRows = 128; // rows of the Gaussian row-parameter table
constexpr int kCols = 6;           // m, b, A, C, B, L
constexpr unsigned kFullWarp = 0xffffffffu;

// Threads a lane: 8 where an image's lanes fit a cluster that way (up to
// 512 lanes), else 4.
int lane_group(int n_lanes) {
  return n_lanes * 8 <= kMaxCluster * kMaxThreads ? 8 : 4;
}

// Blocks per image: one below 32 lanes, else the fewest of 1, 2, 4, 8 whose
// blocks split the lanes evenly and hold at most kMaxThreads threads each;
// 0 if none does.
int cluster_blocks(int n_lanes, int group) {
  if (n_lanes < 32) return 1;
  for (int b = 1; b <= kMaxCluster; b *= 2) {
    if (n_lanes % b == 0 && n_lanes / b * group <= kMaxThreads) return b;
  }
  return 0;
}

int log2_int(int v) {
  int r = 0;
  while ((1 << (r + 1)) <= v) ++r;
  return r;
}

// The split point p_t = lo + span * t / T of thread t (span < 2^17).
template <int T>
__device__ __forceinline__ int split(int lo, int span, int t) {
  return lo + static_cast<int>(static_cast<unsigned>(span * t) / T);
}

// One round of the T-way search: thread t of a group holds the split point
// p_t of [lo, hi] and c, its cdf value (p_0 = lo and points that fall on lo
// take v_lo: lo and hi themselves are never evaluated, so the bisection's
// conventions for cdf(0) and cdf(hi) hold).  The predicate cdf(p_t) <= cf
// is monotone in t; the true ones are t <= J, and [p_J, p_J+1] (p_T = hi)
// is the new interval.
template <int T>
__device__ __forceinline__ void kary_round(int c, int cf, int t, int base,
                                           int& lo, int& v_lo, int& hi,
                                           int& v_hi) {
  const int span = hi - lo;
  const int p = split<T>(lo, span, t);
  const int v = (t > 0 && p > lo) ? c : v_lo;
  const unsigned bits = __ballot_sync(kFullWarp, t == 0 || v <= cf) >> base;
  const int J = __popc(bits & ((1u << T) - 1u)) - 1;
  const int nvlo = __shfl_sync(kFullWarp, v, J, T);
  const int nvhi = __shfl_sync(kFullWarp, v, J + 1 < T ? J + 1 : J, T);
  if (J + 1 < T) {
    hi = split<T>(lo, span, J + 1);
    v_hi = nvhi;
  }
  lo = split<T>(lo, span, J);
  v_lo = nvlo;
}

// The T-way search.  On entry [lo, hi] brackets the slot with v_lo =
// cdf(lo) <= cf < v_hi = cdf(hi), lo = 0; on exit hi - lo <= 1 if `rounds`
// rounds suffice.  A round changes nothing once hi - lo <= 1 (all split
// points are lo), so a warp stops as soon as all of its lanes are there,
// and leaves its issue slots to the warps that still search; within a
// warp every group runs every round, so no ballot or shuffle diverges.  The
// first round's split points do not depend on cf: `v_first` is cdf at this
// thread's, evaluated a step ahead.  The next step's (`next()`, returned in
// `v_next`) is evaluated in the same straight-line code as the second
// round's point, so that the two latencies overlap.  `t` is the thread's
// index in its group, `base` the warp lane of the group's thread 0.
template <int T, typename Cdf, typename Next>
__device__ __forceinline__ void kary_search(const Cdf& cdf, const Next& next,
                                            int cf, int rounds, int t,
                                            int base, int v_first,
                                            int& v_next, int& lo, int& v_lo,
                                            int& hi, int& v_hi) {
  if (rounds > 0) kary_round<T>(v_first, cf, t, base, lo, v_lo, hi, v_hi);
  int c = cdf(split<T>(lo, hi - lo, t));
  v_next = next();
  for (int r = 1; r < rounds; ++r) {
    if (!__any_sync(kFullWarp, hi - lo > 1)) break;
    kary_round<T>(c, cf, t, base, lo, v_lo, hi, v_hi);
    if (r + 1 < rounds) c = cdf(split<T>(lo, hi - lo, t));
  }
}

// cdf at this thread's first-round split point of [0, hi] (0 where the
// point is 0: the bisection's convention cdf(0) = 0, never evaluated).
template <int T, typename Cdf>
__device__ __forceinline__ int first_round(const Cdf& cdf, int hi, int t) {
  const int p = split<T>(0, hi, t);
  const int c = cdf(p);
  return (t > 0 && p > 0) ? c : 0;
}

// One launch decodes S steps of every lane of every image: parametric
// (kRows false: row_params) or by integer rows (kRows true: cdf_rows).
template <int T, bool kRows>
__global__ void __launch_bounds__(kMaxThreads) rans_decode_kernel(
    const uint16_t* __restrict__ words, long long n_words,
    const long long* __restrict__ x_in, const int* __restrict__ ptr_in,
    long long* __restrict__ x_out, int* __restrict__ ptr_out,
    int* __restrict__ sym, bool* __restrict__ esc, int S, int n_lanes,
    int n_images, const int* __restrict__ rows, int rounds,
    const float* __restrict__ row_params, int n_param_rows,
    const int* __restrict__ cdf_rows, int width,
    const int* __restrict__ max_value_t, const int* __restrict__ offsets_t) {
  // Readers per warp, double-buffered by the step's parity so that one
  // block barrier a step orders their writes and reads.  slots[parity][r]
  // holds block r's readers of a step, tagged with the step: block r
  // stores it into every block of the cluster, and each block waits on
  // its own copy until all tags match (no cluster-wide barrier a step).
  __shared__ int warp_counts[2][kMaxThreads / 32];
  __shared__ unsigned slots[2][kMaxCluster];
  __shared__ float tab[kRows ? 1 : kMaxParamRows * kCols];
  cg::cluster_group cluster = cg::this_cluster();
  const int n_blocks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / n_blocks;  // the image
  const int tid = threadIdx.x;
  const int t = tid % T;
  // The block is whole warps, so that every ballot and shuffle names all
  // 32 threads; groups past the block's share of lanes (only where that
  // share is not whole warps) run the last lane's step and store nothing.
  const int lanes_per_block = n_lanes / n_blocks;
  const bool live = tid / T < lanes_per_block;
  const int l = rank * lanes_per_block + min(tid / T, lanes_per_block - 1);
  const int wl = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int base = wl - t;
  // live group leaders (t == 0) of the warp, and those below this group
  unsigned leaders = 0;
  for (int i = 0; i < 32; i += T) leaders |= 1u << i;
  leaders &= __ballot_sync(kFullWarp, live);
  const unsigned below = leaders & ((1u << base) - 1u);
  const long long BL = static_cast<long long>(n_images) * n_lanes;
  const long long g = static_cast<long long>(b) * n_lanes + l;
  if constexpr (!kRows) {
    for (int i = tid; i < n_param_rows * kCols; i += blockDim.x)
      tab[i] = row_params[i];
    __syncthreads();
  }
  if (n_blocks > 1) {
    if (tid < 2 * kMaxCluster) (&slots[0][0])[tid] = 0xffffffffu;
    cluster.sync();  // every block's slots are set before any store
  }

  // Row indexes of the next two steps, loaded two steps ahead (the last
  // step's stand in past the end), the next step's constants from the
  // table in shared memory, and this thread's first-round cdf value of the
  // coming step.
  float nxt[kCols] = {};
  int row_nxt = 0, row_nn = 0;
  auto fetch = [&](int s) {
    return rows[static_cast<long long>(min(s, S - 1)) * BL + g];
  };
  auto select_row = [&](int row, float (&c)[kCols]) {
    if (row < 0 || row >= n_param_rows) row = 0;
#pragma unroll
    for (int k = 0; k < kCols; ++k) c[k] = tab[row * kCols + k];
  };
  auto first = [&]() {
    if constexpr (kRows) {
      const int* crow = cdf_rows + static_cast<long long>(row_nxt) * width;
      return first_round<T>([&](int k) { return crow[k]; },
                            max_value_t[row_nxt] + 1, t);
    } else {
      return first_round<T>(
          [&](int k) {
            return cdf_eval(k, nxt[0], nxt[1], nxt[2], nxt[3], nxt[4]);
          },
          static_cast<int>(nxt[5]), t);
    }
  };
  int v_first = 0, v_next;
  if (S > 0) {
    row_nxt = fetch(0);
    row_nn = fetch(1);
    if constexpr (!kRows) select_row(row_nxt, nxt);
    v_first = first();
  }

  uint32_t x = static_cast<uint32_t>(x_in[g]);
  long long ptr = ptr_in[b];
  // Words are read in order: bring the lines two to three steps ahead into
  // L2 (one prefetch per 64 words), the first steps' lines at the start.
  auto prefetch = [&](long long from) {
    if (t == T - 1 && (l & 63) == 0) {
      const long long p = min(from + l, n_words - 1);
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(words + p));
    }
  };
  prefetch(ptr);
  prefetch(ptr + n_lanes);
  for (int s = 0; s < S; ++s) {
    const long long i = static_cast<long long>(s) * BL + g;
    const int cf = static_cast<int>(x & 0xffffu);
    // this step's entries; the next one's move up (its constants from
    // shared memory, its row loaded a step ago), the one after is loaded
    float cur[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) cur[k] = nxt[k];
    const int row = row_nxt;
    row_nxt = row_nn;
    if constexpr (!kRows) select_row(row_nxt, nxt);
    row_nn = fetch(s + 2);
    int lo = 0, v_lo = 0, hi, v_hi, out_sym;
    uint32_t start, freq;
    bool e;
    if constexpr (kRows) {
      const int max_value = max_value_t[row];
      const int* crow = cdf_rows + static_cast<long long>(row) * width;
      hi = max_value + 1;
      v_hi = 1 << 16;
      kary_search<T>([&](int k) { return crow[k]; }, first, cf, rounds, t,
                     base, v_first, v_next, lo, v_lo, hi, v_hi);
      start = static_cast<uint32_t>(v_lo);
      freq = static_cast<uint32_t>(v_hi - v_lo);
      e = lo == max_value;
      out_sym = lo + offsets_t[row];
    } else {
      const int max_value = static_cast<int>(cur[5]);
      e = cf == 0xffff;
      hi = max_value;
      v_hi = 0xffff;
      kary_search<T>(
          [&](int k) {
            return cdf_eval(k, cur[0], cur[1], cur[2], cur[3], cur[4]);
          },
          first, cf, rounds, t, base, v_first, v_next, lo, v_lo, hi, v_hi);
      start = e ? 0xffffu : static_cast<uint32_t>(v_lo);
      freq = e ? 1u : static_cast<uint32_t>(v_hi - v_lo);
      out_sym = lo - ((max_value - 1) >> 1);
    }
    v_first = v_next;
    x = freq * (x >> 16) + static_cast<uint32_t>(cf) - start;
    if (t == 0 && live) {
      sym[i] = out_sym;
      esc[i] = e;
    }

    // Rank of this lane's read among the image's reading lanes.
    const int buf = s & 1;
    const bool need = live && x < (1u << 16);
    const unsigned ballot = __ballot_sync(kFullWarp, need) & leaders;
    if (wl == 0) warp_counts[buf][warp] = __popc(ballot);
    __syncthreads();
    // lane w of every warp takes warp w's count (block r's, below), and
    // one warp reduction each gives the sums below this one and in all
    const int wc = wl < n_warps ? warp_counts[buf][wl] : 0;
    int before = __popc(ballot & below) +
                 __reduce_add_sync(kFullWarp, wl < warp ? wc : 0);
    int total = __reduce_add_sync(kFullWarp, wc);
    if (n_blocks > 1) {
      const unsigned tag = static_cast<unsigned>(s + 1);
      if (tid < n_blocks) {
        volatile unsigned* dst =
            cluster.map_shared_rank(&slots[buf][rank], tid);
        *dst = (tag << 11) | static_cast<unsigned>(total);
      }
      int bc = 0;
      if (wl < n_blocks) {
        const volatile unsigned* src = &slots[buf][wl];
        unsigned v = *src;
        while ((v >> 11) != tag) v = *src;
        bc = static_cast<int>(v & 0x7ffu);
      }
      before += __reduce_add_sync(kFullWarp, wl < rank ? bc : 0);
      total = __reduce_add_sync(kFullWarp, bc);
    }
    if (need) {
      long long pos = ptr + before;
      if (pos > n_words - 1) pos = n_words - 1;
      x = (x << 16) | __ldg(words + pos);
    }
    ptr += total;
    prefetch(ptr + 2 * n_lanes);
  }
  if (t == 0 && live) x_out[g] = static_cast<long long>(x);
  if (tid == 0 && rank == 0) ptr_out[b] = static_cast<int>(ptr);
  // No block leaves while another may still store into its slots.
  if (n_blocks > 1) cluster.sync();
}

template <int T>
cudaError_t launch(const uint16_t* words, long long n_words,
                   const long long* x_in, const int* ptr_in, long long* x_out,
                   int* ptr_out, int* sym, bool* esc, int S, int n_images,
                   int n_lanes, int mode, const int* rows, int n_steps,
                   const float* row_params, int n_param_rows,
                   const int* cdf_rows, int width, const int* max_value,
                   const int* offsets, cudaStream_t stream) {
  const int blocks = cluster_blocks(n_lanes, T);
  if (blocks == 0) return cudaErrorInvalidValue;
  const int rounds = (n_steps + log2_int(T) - 1) / log2_int(T);
  auto kernel = mode == 1 ? rans_decode_kernel<T, true>
                          : rans_decode_kernel<T, false>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_images * blocks);
  cfg.blockDim = dim3((n_lanes / blocks * T + 31) / 32 * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // A cluster the card cannot place is refused before any launch (asked
  // once per kernel and cluster shape, 0 unknown, 1 yes, -1 no; the answer
  // does not change within a process).
  static int placeable[2][kMaxCluster + 1][kMaxThreads / 32 + 1] = {};
  int& ok = placeable[mode][blocks][cfg.blockDim.x / 32];
  if (ok == 0) {
    int n_clusters = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveClusters(&n_clusters, kernel, &cfg);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return err;
    }
    ok = n_clusters > 0 ? 1 : -1;
  }
  if (ok < 0) return cudaErrorLaunchOutOfResources;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, words, n_words, x_in, ptr_in, x_out, ptr_out, sym, esc, S,
      n_lanes, n_images, rows, rounds, row_params, n_param_rows, cdf_rows,
      width, max_value, offsets);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  return cudaGetLastError();
}

int check_args(long long n_words, int S, int n_images, int n_lanes, int mode,
               const int* rows, const float* row_params, int n_param_rows,
               const int* cdf_rows, int width, const int* max_value,
               const int* offsets) {
  // Lane counts: below 32, or whole warps up to 1024 (the codec's rule).
  const bool lanes_ok = n_lanes >= 1 && n_lanes <= 1024 &&
                        (n_lanes < 32 || n_lanes % 32 == 0);
  const bool tables_ok =
      mode == 0 ? row_params != nullptr && n_param_rows >= 1 &&
                      n_param_rows <= kMaxParamRows
                : mode == 1 && cdf_rows != nullptr && width >= 2 &&
                      max_value != nullptr && offsets != nullptr;
  if (!lanes_ok || !tables_ok || rows == nullptr || n_images < 1 ||
      n_words < 1 || S < 0 || S >= (1 << 21) - 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// mode 0: parametric (row_params f32 [n_param_rows, 6]); mode 1: integer
// rows (cdf_rows int32 [*, width], max_value, offsets).  rows int32
// [S, n_images * n_lanes] in both.
extern "C" int rans_decode_launch(
    const uint16_t* words, long long n_words, const long long* x_in,
    const int* ptr_in, long long* x_out, int* ptr_out, int* sym, bool* esc,
    int S, int n_images, int n_lanes, int mode, const int* rows, int n_steps,
    const float* row_params, int n_param_rows, const int* cdf_rows, int width,
    const int* max_value, const int* offsets, void* stream) {
  const int rc = check_args(n_words, S, n_images, n_lanes, mode, rows,
                            row_params, n_param_rows, cdf_rows, width,
                            max_value, offsets);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto fn) {
    return static_cast<int>(fn(words, n_words, x_in, ptr_in, x_out, ptr_out,
                               sym, esc, S, n_images, n_lanes, mode, rows,
                               n_steps, row_params, n_param_rows, cdf_rows,
                               width, max_value, offsets, s));
  };
  return lane_group(n_lanes) == 8 ? run(launch<8>) : run(launch<4>);
}
