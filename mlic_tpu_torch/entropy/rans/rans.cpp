// Host rANS range coder of the PyTorch port (its own copy of the
// compressai-style single-stream coder the JAX package keeps in
// mlic_tpu/entropy/rans/rans.cpp): the coder of the ``steps`` and ``fused``
// codec backends, one stream per image, symbols addressed by per-symbol
// CDF rows, as the reference's BufferedRansEncoder / RansDecoder.
//
// A 64-bit rANS: 64-bit state, 32-bit renormalization words, 16-bit
// probabilities.  Stream format:
//   * words are emitted back-to-front during (reverse-order) encoding; the
//     final flush prepends the 64-bit state as [lo32, hi32].
//   * per-context integer CDFs have cdf[0] == 0, cdf[len-1] == 1 << 16; the
//     last interval (slot len-2) is the escape slot.
//   * out-of-range values are coded as: escape slot, then a zigzag-encoded
//     magnitude in 4-bit digits, each carried in a uniform 5-bit symbol
//     (4 data bits + 1 continuation bit).
//
// A plain C ABI for ctypes (mlic_tpu_torch/entropy/rans/coder.py builds it
// with g++ at first use).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kProbBits = 16;
constexpr uint64_t kRansL = 1ull << 31;          // lower bound of the state
constexpr uint32_t kBypassBits = 5;              // 4 data + 1 continuation
constexpr uint32_t kBypassFreq = 1u << (kProbBits - kBypassBits);  // 2048

struct Encoder {
  uint64_t x = kRansL;
  std::vector<uint32_t> words;  // collected in reverse stream order

  inline void put(uint32_t start, uint32_t freq) {
    uint64_t x_max = ((kRansL >> kProbBits) << 32) * freq;
    while (x >= x_max) {
      words.push_back(static_cast<uint32_t>(x));
      x >>= 32;
    }
    x = ((x / freq) << kProbBits) + (x % freq) + start;
  }

  inline void put_bypass5(uint32_t s5) {
    put(s5 << (kProbBits - kBypassBits), kBypassFreq);
  }

  // Encode one out-of-range value: decoder will see the escape slot first,
  // then digits low-to-high.  rANS is LIFO, so push digits high-to-low, then
  // the escape slot (the caller pushes the escape via the regular put()).
  inline void put_escape_payload(int64_t value, int32_t max_value) {
    uint64_t u = value < 0 ? static_cast<uint64_t>(-2 * value - 1)
                           : static_cast<uint64_t>(2 * (value - max_value));
    // Split into 4-bit digits with continuation flags, low to high.
    uint32_t digits[17];
    int n = 0;
    do {
      digits[n++] = static_cast<uint32_t>(u & 0xF);
      u >>= 4;
    } while (u != 0);
    for (int i = n - 1; i >= 0; --i) {
      uint32_t s5 = digits[i] | (i + 1 < n ? 0x10u : 0u);
      put_bypass5(s5);
    }
  }
};

struct Decoder {
  uint64_t x = 0;
  const uint32_t* ptr = nullptr;
  const uint32_t* end = nullptr;
  std::vector<uint32_t> owned;

  void init(const uint8_t* stream, int64_t len) {
    int64_t n_words = len / 4;
    owned.resize(static_cast<size_t>(n_words));
    std::memcpy(owned.data(), stream, static_cast<size_t>(n_words) * 4);
    ptr = owned.data();
    end = owned.data() + n_words;
    uint32_t lo = ptr < end ? *ptr++ : 0;
    uint32_t hi = ptr < end ? *ptr++ : 0;
    x = (static_cast<uint64_t>(hi) << 32) | lo;
  }

  inline void renorm() {
    while (x < kRansL && ptr < end) {
      x = (x << 32) | *ptr++;
    }
  }

  inline uint32_t peek() const { return static_cast<uint32_t>(x & ((1u << kProbBits) - 1)); }

  inline void advance(uint32_t start, uint32_t freq) {
    uint32_t cf = peek();
    x = freq * (x >> kProbBits) + cf - start;
    renorm();
  }

  inline uint32_t get_bypass5() {
    uint32_t s5 = peek() >> (kProbBits - kBypassBits);
    advance(s5 << (kProbBits - kBypassBits), kBypassFreq);
    return s5;
  }

  inline int64_t get_escape_payload(int32_t max_value) {
    uint64_t u = 0;
    int shift = 0;
    uint32_t s5;
    do {
      s5 = get_bypass5();
      u |= static_cast<uint64_t>(s5 & 0xF) << shift;
      shift += 4;
    } while ((s5 & 0x10) && shift < 68);
    if (u & 1) return -static_cast<int64_t>((u + 1) >> 1);
    return static_cast<int64_t>(u >> 1) + max_value;
  }
};

// Binary search: largest s with cdf[s] <= cf  (cdf strictly increasing).
inline int32_t find_symbol(const int32_t* cdf, int32_t n_sym, uint32_t cf) {
  int32_t lo = 0, hi = n_sym;  // invariant: cdf[lo] <= cf < cdf[hi]
  while (hi - lo > 1) {
    int32_t mid = (lo + hi) >> 1;
    if (static_cast<uint32_t>(cdf[mid]) <= cf) lo = mid; else hi = mid;
  }
  return lo;
}

}  // namespace

extern "C" {

// Encode n symbols.  cdfs is a row-major [n_ctx, cdf_stride] int32 table;
// row i is valid up to cdf_lengths[i].  Returns bytes written, or -1 if
// out_capacity is insufficient.
int64_t mlic_rans_encode(const int32_t* symbols, const int32_t* indexes, int64_t n,
                         const int32_t* cdfs, int64_t cdf_stride,
                         const int32_t* cdf_lengths, const int32_t* offsets,
                         uint8_t* out, int64_t out_capacity) {
  Encoder enc;
  enc.words.reserve(static_cast<size_t>(n / 2 + 4));
  // Decoder consumes symbols first-to-last; rANS is LIFO, so encode last-to-first.
  for (int64_t k = n - 1; k >= 0; --k) {
    const int32_t i = indexes[k];
    const int32_t* cdf = cdfs + static_cast<int64_t>(i) * cdf_stride;
    const int32_t len = cdf_lengths[i];
    const int32_t max_value = len - 2;
    const int64_t value = static_cast<int64_t>(symbols[k]) - offsets[i];
    int32_t slot;
    if (value >= 0 && value < max_value) {
      slot = static_cast<int32_t>(value);
    } else {
      enc.put_escape_payload(value, max_value);
      slot = max_value;  // escape slot
    }
    enc.put(static_cast<uint32_t>(cdf[slot]),
            static_cast<uint32_t>(cdf[slot + 1] - cdf[slot]));
  }
  // Flush the final state: stream begins [lo32, hi32].
  const uint64_t xf = enc.x;
  const int64_t n_words = static_cast<int64_t>(enc.words.size()) + 2;
  const int64_t n_bytes = n_words * 4;
  if (n_bytes > out_capacity) return -1;
  uint32_t* w = reinterpret_cast<uint32_t*>(out);
  w[0] = static_cast<uint32_t>(xf);
  w[1] = static_cast<uint32_t>(xf >> 32);
  // Words were collected in reverse stream order.
  for (int64_t j = 0; j < n_words - 2; ++j) {
    w[2 + j] = enc.words[enc.words.size() - 1 - static_cast<size_t>(j)];
  }
  return n_bytes;
}

void* mlic_rans_decoder_new(const uint8_t* stream, int64_t len) {
  Decoder* dec = new Decoder();
  dec->init(stream, len);
  return dec;
}

void mlic_rans_decoder_free(void* dec) { delete static_cast<Decoder*>(dec); }

// Decode n symbols from the stream (stateful; call repeatedly for interleaved
// decoding as the model reveals more context).  Returns 0 on success.
int32_t mlic_rans_decode(void* dec_ptr, const int32_t* indexes, int64_t n,
                         const int32_t* cdfs, int64_t cdf_stride,
                         const int32_t* cdf_lengths, const int32_t* offsets,
                         int32_t* out_symbols) {
  Decoder* dec = static_cast<Decoder*>(dec_ptr);
  for (int64_t k = 0; k < n; ++k) {
    const int32_t i = indexes[k];
    const int32_t* cdf = cdfs + static_cast<int64_t>(i) * cdf_stride;
    const int32_t len = cdf_lengths[i];
    const int32_t max_value = len - 2;
    const uint32_t cf = dec->peek();
    const int32_t slot = find_symbol(cdf, len - 1, cf);
    dec->advance(static_cast<uint32_t>(cdf[slot]),
                 static_cast<uint32_t>(cdf[slot + 1] - cdf[slot]));
    int64_t value;
    if (slot == max_value) {
      value = dec->get_escape_payload(max_value);
    } else {
      value = slot;
    }
    out_symbols[k] = static_cast<int32_t>(value + offsets[i]);
  }
  return 0;
}

}  // extern "C"
