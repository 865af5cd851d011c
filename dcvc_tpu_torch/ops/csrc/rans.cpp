// dcvc-tpu native entropy-coding core.
//
// A from-scratch 64-bit rANS (range asymmetric numeral system) coder with
//   * escape/bypass coding for out-of-support symbols,
//   * N-way stream partitioning (parallel encode/decode worker threads),
//   * a compact container format: 1 flag byte (hi nibble = numParts-1,
//     lo nibble = 1 if per-part sizes are u16 else u32) + per-part sizes
//     (all but last) + concatenated part payloads,
//   * a fixed-point CDF quantizer.
//
// Behavioural parity targets (re-implemented, not copied):
//   reference DCVC-DC/src/cpp/rans/rans.cpp (coder semantics),
//   DCVC-DC/src/cpp/py_rans/py_rans.cpp (container format),
//   DCVC-DC/src/cpp/ops/ops.cpp (CDF quantizer).
// The rANS renormalisation scheme follows the public-domain ryg_rans
// construction (F. Giesen, "rANS in practice").
//
// Exposed as a plain C ABI for ctypes binding (no pybind11 dependency).

#include <algorithm>
#include <atomic>
#include <cassert>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kPrecision = 16;             // probability scale bits
constexpr uint64_t kRansL = 1ull << 31;         // lower renormalisation bound
constexpr uint32_t kBypassBits = 4;             // bypass chunk width
constexpr uint32_t kMaxBypass = (1u << kBypassBits) - 1;

// Precomputed encoder symbol (ryg_rans rans64.h construction, public
// domain): division by freq done exactly with a 128-bit multiply-high by a
// ceiling reciprocal (Alverson, "Integer division using reciprocals") —
// x/f == mulhi(x, rcp_freq) >> rcp_shift for every 64-bit x. Removes the
// per-symbol u64 divide from the flush loop (~2x flush).
struct EncSym {
  uint64_t rcp_freq;
  uint32_t bias;       // start (start + 2^16 - 1 in the freq<2 special case)
  uint32_t cmpl_freq;  // 2^16 - freq
  uint16_t freq;       // kept for the renormalisation bound
  uint8_t rcp_shift;
};

inline void enc_sym_init(EncSym* s, uint32_t start, uint32_t freq) {
  s->freq = static_cast<uint16_t>(freq);
  s->cmpl_freq = (1u << kPrecision) - freq;
  if (freq < 2) {
    // freq=1: q = mulhi(x, 2^64-1) = x-1 for x >= 1; bias folds the +1 back
    s->rcp_freq = ~0ull;
    s->rcp_shift = 0;
    s->bias = start + (1u << kPrecision) - 1;
  } else {
    uint32_t shift = 0;
    while (freq > (1u << shift)) shift++;
    s->rcp_freq = static_cast<uint64_t>(
        ((static_cast<__uint128_t>(1) << (shift + 63)) + freq - 1) / freq);
    s->rcp_shift = static_cast<uint8_t>(shift - 1);
    s->bias = start;
  }
}

// Buffered coding decision: 4 bytes per symbol. Bit 31 set => bypass entry
// (low bits carry the raw chunk value); otherwise an index into the
// per-encoder EncSym arena (small, cache-resident — the buffer itself stays
// compact so the flush replay streams at memory speed).
constexpr uint32_t kBypassFlag = 1u << 31;

// ---- 64-bit rANS primitives (state in [L, L*2^32)) ----

inline void enc_put_bits(uint64_t* x, uint32_t** pptr, uint32_t val, uint32_t nbits) {
  uint32_t freq = 1u << (kPrecision - nbits);
  uint64_t x_max = ((kRansL >> kPrecision) << 32) * freq;
  if (*x >= x_max) {
    *pptr -= 1;
    **pptr = static_cast<uint32_t>(*x);
    *x >>= 32;
  }
  *x = (*x << nbits) | val;
}

inline void enc_flush(uint64_t x, uint32_t** pptr) {
  *pptr -= 2;
  (*pptr)[0] = static_cast<uint32_t>(x >> 0);
  (*pptr)[1] = static_cast<uint32_t>(x >> 32);
}

inline void dec_init(uint64_t* x, uint32_t** pptr) {
  *x = static_cast<uint64_t>((*pptr)[0]) | (static_cast<uint64_t>((*pptr)[1]) << 32);
  *pptr += 2;
}

inline uint32_t dec_get(uint64_t x) {
  return static_cast<uint32_t>(x & ((1ull << kPrecision) - 1));
}

inline void dec_advance(uint64_t* x, uint32_t** pptr, uint32_t start, uint32_t freq) {
  uint64_t mask = (1ull << kPrecision) - 1;
  *x = freq * (*x >> kPrecision) + (*x & mask) - start;
  if (*x < kRansL) {
    *x = (*x << 32) | **pptr;
    *pptr += 1;
  }
}

inline uint32_t dec_get_bits(uint64_t* x, uint32_t** pptr, uint32_t nbits) {
  uint32_t val = static_cast<uint32_t>(*x & ((1ull << nbits) - 1));
  *x >>= nbits;
  if (*x < kRansL) {
    *x = (*x << 32) | **pptr;
    *pptr += 1;
  }
  return val;
}

// ---- single-stream encoder/decoder ----

struct StreamEncoder {
  std::vector<uint32_t> syms;   // buffered decisions, 4 B/symbol
  std::vector<EncSym> arena;    // precomputed rows, appended per encode call
  std::vector<int32_t> row_start;
  std::vector<uint8_t> row_built;
  std::vector<uint8_t> stream;

  void reset() {
    syms.clear();
    arena.clear();
    stream.clear();
  }

  // Buffer precomputed coding decisions; flush() replays them in reverse.
  // EncSym rows are (re)built per call on first use — the CDF table may
  // differ between encode calls feeding one flush, so rows are appended to
  // the arena rather than keyed globally.
  void encode(const int16_t* symbols, const int16_t* indexes, int64_t n,
              const int32_t* cdfs, int64_t cdf_num, int64_t cdf_stride,
              const int32_t* cdf_sizes, const int32_t* offsets) {
    syms.reserve(syms.size() + static_cast<size_t>(n) * 3 / 2);
    // tiny calls (per-wavefront AR substreams) don't amortise building
    // whole EncSym rows: append ONE EncSym per symbol instead (same
    // per-symbol cost as the old divide-at-flush, no O(rows*entries) work)
    const bool memo_rows = n >= cdf_num * 4;
    if (memo_rows) {
      row_start.assign(static_cast<size_t>(cdf_num), 0);
      row_built.assign(static_cast<size_t>(cdf_num), 0);
    }
    for (int64_t i = 0; i < n; ++i) {
      const int32_t cdf_idx = indexes[i];
      if (cdf_idx < 0) continue;  // index < 0 means "skip" (known value)
      const int32_t max_value = cdf_sizes[cdf_idx] - 2;
      if (memo_rows && !row_built[cdf_idx]) {
        const int32_t* cdf = cdfs + cdf_idx * cdf_stride;
        row_start[cdf_idx] = static_cast<int32_t>(arena.size());
        arena.resize(arena.size() + static_cast<size_t>(max_value) + 1);
        EncSym* row = arena.data() + row_start[cdf_idx];
        for (int32_t s = 0; s <= max_value; ++s) {
          enc_sym_init(row + s, static_cast<uint32_t>(cdf[s]),
                       static_cast<uint32_t>(cdf[s + 1] - cdf[s]));
        }
        row_built[cdf_idx] = 1;
      }
      int32_t value = symbols[i] - offsets[cdf_idx];

      uint32_t raw_val = 0;
      if (value < 0) {
        raw_val = static_cast<uint32_t>(-2 * value - 1);
        value = max_value;
      } else if (value >= max_value) {
        raw_val = static_cast<uint32_t>(2 * (value - max_value));
        value = max_value;
      }

      if (memo_rows) {
        syms.push_back(static_cast<uint32_t>(row_start[cdf_idx] + value));
      } else {
        const int32_t* cdf = cdfs + cdf_idx * cdf_stride;
        syms.push_back(static_cast<uint32_t>(arena.size()));
        arena.emplace_back();
        enc_sym_init(&arena.back(), static_cast<uint32_t>(cdf[value]),
                     static_cast<uint32_t>(cdf[value + 1] - cdf[value]));
      }

      if (value == max_value) {
        // escape: emit bypass chunk count, then the raw value in 4-bit chunks
        int32_t n_bypass = 0;
        while ((raw_val >> (n_bypass * kBypassBits)) != 0) ++n_bypass;

        int32_t v = n_bypass;
        while (v >= static_cast<int32_t>(kMaxBypass)) {
          syms.push_back(kBypassFlag | kMaxBypass);
          v -= kMaxBypass;
        }
        syms.push_back(kBypassFlag | static_cast<uint32_t>(v));
        for (int32_t j = 0; j < n_bypass; ++j) {
          syms.push_back(kBypassFlag |
                         ((raw_val >> (j * kBypassBits)) & kMaxBypass));
        }
      }
    }
  }

  void flush() {
    uint64_t x = kRansL;
    std::vector<uint32_t> out(syms.size() + 2);
    uint32_t* ptr = out.data() + out.size();
    const EncSym* ar = arena.data();
    for (auto it = syms.rbegin(); it != syms.rend(); ++it) {
      const uint32_t packed = *it;
      if (!(packed & kBypassFlag)) {
        // renormalise, then x' = (x/f << 16) + x%f + start via the
        // reciprocal: q = x/f exactly, x' = x + q*(2^16 - f) + bias
        const EncSym& es = ar[packed];
        const uint64_t x_max =
            ((kRansL >> kPrecision) << 32) * static_cast<uint64_t>(es.freq);
        if (x >= x_max) {
          ptr -= 1;
          *ptr = static_cast<uint32_t>(x);
          x >>= 32;
        }
        const uint64_t q = static_cast<uint64_t>(
            (static_cast<__uint128_t>(x) * es.rcp_freq) >> 64) >> es.rcp_shift;
        x = x + es.bias + q * es.cmpl_freq;
      } else {
        enc_put_bits(&x, &ptr, packed & kMaxBypass, kBypassBits);
      }
    }
    enc_flush(x, &ptr);
    const size_t nbytes =
        static_cast<size_t>(out.data() + out.size() - ptr) * sizeof(uint32_t);
    stream.resize(nbytes);
    std::memcpy(stream.data(), ptr, nbytes);
    syms.clear();
    arena.clear();
  }
};

// Coarse search-acceleration LUT for CDF inversion: for each CDF row,
// lut[b] = the largest symbol s with cdf[s] <= (b << kLutShift). Starting the
// linear search there instead of at 0 makes the per-symbol scan O(entries per
// 256-wide cum bucket) — ~1 step in practice — while producing bit-identical
// results (the start point is always <= the answer since cdf is increasing
// and (cum >> kLutShift) << kLutShift <= cum).
constexpr uint32_t kLutBits = 8;
constexpr uint32_t kLutShift = kPrecision - kLutBits;
constexpr uint32_t kLutSize = 1u << kLutBits;

void build_decode_lut(const int32_t* cdfs, int64_t cdf_num, int64_t cdf_stride,
                      const int32_t* cdf_sizes, std::vector<uint16_t>* lut) {
  lut->resize(static_cast<size_t>(cdf_num) * kLutSize);
  for (int64_t r = 0; r < cdf_num; ++r) {
    const int32_t* cdf = cdfs + r * cdf_stride;
    const int32_t cdf_size = cdf_sizes[r];
    uint16_t* row = lut->data() + r * kLutSize;
    int32_t s = 0;
    for (uint32_t b = 0; b < kLutSize; ++b) {
      const uint32_t target = b << kLutShift;
      while (s + 1 < cdf_size && static_cast<uint32_t>(cdf[s + 1]) <= target) ++s;
      row[b] = static_cast<uint16_t>(s);
    }
  }
}

struct StreamDecoder {
  std::vector<uint8_t> stream;
  uint64_t x = 0;
  uint32_t* ptr = nullptr;

  void set_stream(const uint8_t* data, int64_t n) {
    stream.assign(data, data + n);
    ptr = reinterpret_cast<uint32_t*>(stream.data());
    dec_init(&x, &ptr);
  }

  // Decode ONE symbol (state advances; index < 0 means "skip", no state
  // change — mirrors the encoder's skip semantics).
  inline int16_t step(int32_t cdf_idx, const int32_t* cdfs, int64_t cdf_stride,
                      const int32_t* cdf_sizes, const int32_t* offsets,
                      const uint16_t* lut) {
    if (cdf_idx < 0) return 0;
    const int32_t offset = offsets[cdf_idx];
    const int32_t* cdf = cdfs + cdf_idx * cdf_stride;
    const int32_t cdf_size = cdf_sizes[cdf_idx];
    const int32_t max_value = cdf_size - 2;
    const uint32_t cum = dec_get(x);

    // LUT-seeded linear CDF search: first entry strictly greater than cum,
    // minus one (identical result to a from-zero scan, see build_decode_lut)
    int32_t s = lut[cdf_idx * static_cast<int32_t>(kLutSize) +
                    static_cast<int32_t>(cum >> kLutShift)];
    while (s + 1 < cdf_size && static_cast<uint32_t>(cdf[s + 1]) <= cum) ++s;

    dec_advance(&x, &ptr, cdf[s], cdf[s + 1] - cdf[s]);

    int32_t value = s;
    if (value == max_value) {
      uint32_t val = dec_get_bits(&x, &ptr, kBypassBits);
      uint32_t n_bypass = val;
      while (val == kMaxBypass) {
        val = dec_get_bits(&x, &ptr, kBypassBits);
        n_bypass += val;
      }
      uint32_t raw_val = 0;
      for (uint32_t j = 0; j < n_bypass; ++j) {
        raw_val |= dec_get_bits(&x, &ptr, kBypassBits) << (j * kBypassBits);
      }
      value = static_cast<int32_t>(raw_val >> 1);
      if (raw_val & 1) {
        value = -value - 1;
      } else {
        value += max_value;
      }
    }
    return static_cast<int16_t>(value + offset);
  }

  void decode(const int16_t* indexes, int64_t n,
              const int32_t* cdfs, int64_t cdf_stride,
              const int32_t* cdf_sizes, const int32_t* offsets,
              const uint16_t* lut, int16_t* out) {
    for (int64_t i = 0; i < n; ++i) {
      out[i] = step(indexes[i], cdfs, cdf_stride, cdf_sizes, offsets, lut);
    }
  }
};

// ---- multi-part wrappers ----

struct Encoder {
  std::vector<StreamEncoder> parts;
  std::vector<uint8_t> container;

  explicit Encoder(int n) : parts(static_cast<size_t>(n)) {}

  void reset() {
    for (auto& p : parts) p.reset();
    container.clear();
  }

  void encode(const int16_t* symbols, const int16_t* indexes, int64_t n,
              const int32_t* cdfs, int64_t cdf_num, int64_t cdf_stride,
              const int32_t* cdf_sizes, const int32_t* offsets) {
    const int64_t np = static_cast<int64_t>(parts.size());
    const int64_t each = n / np;
    for (int64_t i = 0; i < np; ++i) {
      const int64_t off = i * each;
      const int64_t cnt = (i == np - 1) ? (n - off) : each;
      parts[i].encode(symbols + off, indexes + off, cnt, cdfs, cdf_num,
                      cdf_stride, cdf_sizes, offsets);
    }
  }

  int64_t flush() {
    if (parts.size() == 1) {
      parts[0].flush();
    } else {
      std::vector<std::thread> threads;
      threads.reserve(parts.size());
      for (auto& p : parts) threads.emplace_back([&p] { p.flush(); });
      for (auto& t : threads) t.join();
    }

    // container: flag byte + sizes of all but the last part + payloads
    size_t max_size = 0, total = 0;
    for (size_t i = 0; i < parts.size(); ++i) {
      const size_t nbytes = parts[i].stream.size();
      if (i + 1 < parts.size()) max_size = std::max(max_size, nbytes);
      total += nbytes;
    }
    const int per_header = max_size > 65535 ? 4 : 2;
    size_t overhead = 1;
    if (parts.size() > 1) overhead += (parts.size() - 1) * per_header;

    container.resize(total + overhead);
    container[0] = static_cast<uint8_t>(((parts.size() - 1) << 4) +
                                        (per_header == 2 ? 1 : 0));
    for (size_t i = 0; i + 1 < parts.size(); ++i) {
      if (per_header == 2) {
        uint16_t sz = static_cast<uint16_t>(parts[i].stream.size());
        std::memcpy(container.data() + 1 + 2 * i, &sz, 2);
      } else {
        uint32_t sz = static_cast<uint32_t>(parts[i].stream.size());
        std::memcpy(container.data() + 1 + 4 * i, &sz, 4);
      }
    }
    size_t off = overhead;
    for (auto& p : parts) {
      std::memcpy(container.data() + off, p.stream.data(), p.stream.size());
      off += p.stream.size();
    }
    return static_cast<int64_t>(container.size());
  }
};

struct Decoder {
  std::vector<StreamDecoder> parts;
  std::vector<uint16_t> lut;       // rebuilt per decode call (large calls)
  std::vector<uint16_t> zero_lut;  // persistent all-zero LUT (tiny calls);
                                   // never written, so no per-call memset

  explicit Decoder(int n) : parts(static_cast<size_t>(n)) {}

  void set_stream(const uint8_t* data, int64_t n) {
    const uint8_t flag = data[0];
    const int num = (flag >> 4) + 1;
    const int per_header = (flag & 0x0f) == 1 ? 2 : 4;
    std::vector<int64_t> sizes;
    int64_t off = 1, declared = 0;
    for (int i = 0; i + 1 < num; ++i) {
      if (per_header == 2) {
        uint16_t sz;
        std::memcpy(&sz, data + off, 2);
        sizes.push_back(sz);
        off += 2;
      } else {
        uint32_t sz;
        std::memcpy(&sz, data + off, 4);
        sizes.push_back(sz);
        off += 4;
      }
      declared += sizes.back();
    }
    sizes.push_back(n - off - declared);
    // the container self-describes its part count — adapt instead of
    // requiring the constructor's stream_part to match (the reference
    // indexes a fixed decoder array here and would read out of bounds)
    if (static_cast<size_t>(num) != parts.size()) {
      parts.assign(static_cast<size_t>(num), StreamDecoder());
    }
    for (int i = 0; i < num; ++i) {
      parts[static_cast<size_t>(i)].set_stream(data + off, sizes[static_cast<size_t>(i)]);
      off += sizes[static_cast<size_t>(i)];
    }
  }

  void decode(const int16_t* indexes, int64_t n,
              const int32_t* cdfs, int64_t cdf_num, int64_t cdf_stride,
              const int32_t* cdf_sizes, const int32_t* offsets, int16_t* out) {
    const uint16_t* lp;
    if (n >= cdf_num * 4) {
      build_decode_lut(cdfs, cdf_num, cdf_stride, cdf_sizes, &lut);
      lp = lut.data();
    } else {
      // Tiny decode calls (e.g. per-wavefront AR substreams) don't amortise
      // the LUT build; a zero start point reproduces the plain from-zero
      // search exactly. zero_lut only ever grows with zeros — no memset.
      const size_t needed = static_cast<size_t>(cdf_num) * kLutSize;
      if (zero_lut.size() < needed) zero_lut.resize(needed, 0);
      lp = zero_lut.data();
    }
    const int64_t np = static_cast<int64_t>(parts.size());
    const int64_t each = n / np;
    if (np == 1) {
      parts[0].decode(indexes, n, cdfs, cdf_stride, cdf_sizes, offsets, lp, out);
      return;
    }
    if (std::thread::hardware_concurrency() <= 1) {
      // Single core: threads cannot help, but the part streams are
      // independent rANS states — interleave them in ONE loop so their
      // serial state-update chains overlap in the pipeline (~1.6x measured
      // on the 1-vCPU bench host vs sequential part decode).
      for (int64_t k = 0; k < each; ++k) {
        for (int64_t p = 0; p < np; ++p) {
          const int64_t i = p * each + k;
          out[i] = parts[static_cast<size_t>(p)].step(
              indexes[i], cdfs, cdf_stride, cdf_sizes, offsets, lp);
        }
      }
      // tail of the last part (it holds the remainder symbols)
      for (int64_t i = np * each; i < n; ++i) {
        out[i] = parts[static_cast<size_t>(np - 1)].step(
            indexes[i], cdfs, cdf_stride, cdf_sizes, offsets, lp);
      }
      return;
    }
    std::vector<std::thread> threads;
    threads.reserve(static_cast<size_t>(np));
    for (int64_t i = 0; i < np; ++i) {
      const int64_t off = i * each;
      const int64_t cnt = (i == np - 1) ? (n - off) : each;
      StreamDecoder* p = &parts[static_cast<size_t>(i)];
      threads.emplace_back([=] {
        p->decode(indexes + off, cnt, cdfs, cdf_stride, cdf_sizes, offsets, lp,
                  out + off);
      });
    }
    for (auto& t : threads) t.join();
  }
};

}  // namespace

extern "C" {

void* rans_encoder_new(int stream_parts) { return new Encoder(stream_parts); }
void rans_encoder_delete(void* h) { delete static_cast<Encoder*>(h); }
void rans_encoder_reset(void* h) { static_cast<Encoder*>(h)->reset(); }

void rans_encoder_encode(void* h, const int16_t* symbols, const int16_t* indexes,
                         int64_t n, const int32_t* cdfs, int64_t cdf_num,
                         int64_t cdf_stride, const int32_t* cdf_sizes,
                         const int32_t* offsets) {
  static_cast<Encoder*>(h)->encode(symbols, indexes, n, cdfs, cdf_num,
                                   cdf_stride, cdf_sizes, offsets);
}

int64_t rans_encoder_flush(void* h) { return static_cast<Encoder*>(h)->flush(); }

void rans_encoder_get_stream(void* h, uint8_t* out) {
  Encoder* e = static_cast<Encoder*>(h);
  std::memcpy(out, e->container.data(), e->container.size());
}

void* rans_decoder_new(int stream_parts) { return new Decoder(stream_parts); }
void rans_decoder_delete(void* h) { delete static_cast<Decoder*>(h); }

void rans_decoder_set_stream(void* h, const uint8_t* data, int64_t n) {
  static_cast<Decoder*>(h)->set_stream(data, n);
}

void rans_decoder_decode(void* h, const int16_t* indexes, int64_t n,
                         const int32_t* cdfs, int64_t cdf_num, int64_t cdf_stride,
                         const int32_t* cdf_sizes, const int32_t* offsets,
                         int16_t* out) {
  static_cast<Decoder*>(h)->decode(indexes, n, cdfs, cdf_num, cdf_stride,
                                   cdf_sizes, offsets, out);
}

// Quantize a float pmf into a strictly-increasing fixed-point CDF summing to
// 2^precision (every symbol keeps frequency >= 1). Mirrors the semantics of
// the reference CDF quantizer (DCVC-DC/src/cpp/ops/ops.cpp:24-91).
int pmf_to_quantized_cdf(const float* pmf, int64_t n, int precision, int32_t* out) {
  std::vector<uint64_t> cdf(static_cast<size_t>(n) + 1);
  cdf[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    cdf[static_cast<size_t>(i) + 1] = static_cast<uint64_t>(
        std::lround(static_cast<double>(pmf[i]) * (1 << precision)));
  }
  uint64_t total = std::accumulate(cdf.begin(), cdf.end(), uint64_t{0});
  if (total == 0) return -1;
  for (auto& c : cdf) c = ((1ull << precision) * c) / total;
  std::partial_sum(cdf.begin(), cdf.end(), cdf.begin());
  cdf.back() = 1ull << precision;

  for (size_t i = 0; i + 1 < cdf.size(); ++i) {
    if (cdf[i] == cdf[i + 1]) {
      uint64_t best_freq = ~0ull;
      int64_t best_steal = -1;
      for (size_t j = 0; j + 1 < cdf.size(); ++j) {
        uint64_t freq = cdf[j + 1] - cdf[j];
        if (freq > 1 && freq < best_freq) {
          best_freq = freq;
          best_steal = static_cast<int64_t>(j);
        }
      }
      if (best_steal < 0) return -1;
      if (best_steal < static_cast<int64_t>(i)) {
        for (int64_t j = best_steal + 1; j <= static_cast<int64_t>(i); ++j) cdf[static_cast<size_t>(j)]--;
      } else {
        for (int64_t j = static_cast<int64_t>(i) + 1; j <= best_steal; ++j) cdf[static_cast<size_t>(j)]++;
      }
    }
  }
  for (int64_t i = 0; i <= n; ++i) out[i] = static_cast<int32_t>(cdf[static_cast<size_t>(i)]);
  return 0;
}

}  // extern "C"
