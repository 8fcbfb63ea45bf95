// Native pair generator — the multithreaded C++ hot path of the host data pipeline.
//
// Produces the exact (bit-identical) pair stream of the numpy reference
// implementation `data/pipeline.py::_block_pairs`: frequency subsampling
// (mllib:371-379 semantics) + per-position dynamic context windows (mllib:384-388),
// with every random decision position-keyed through the murmur3-finalizer lattice
// defined in `data/hashrng.py` (the shared contract — keep the constants in sync).
//
// Why native: the numpy path needs a handful of full-block temporaries (repeat /
// cumsum / bincount) per block; this is one fused pass per sentence with zero
// allocation in the steady state, parallel over sentence ranges. Position-keyed
// randomness means any thread can draw for any token with no sequential RNG state,
// so the stream is independent of the thread count.
//
// Built as a shared library (no Python headers — plain C ABI consumed via ctypes):
//   g++ -O3 -shared -fPIC -pthread -o libpairgen.so pairgen.cpp

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline uint32_t mix32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// must match data/hashrng.py::stream_base
inline uint32_t stream_base(uint32_t seed, uint32_t stream, uint32_t iteration,
                            uint32_t shard) {
  uint32_t s = seed * 0x9E3779B9u;
  uint32_t t = stream * 0x7FEB352Du + 0x68E31DA4u;
  uint32_t c = iteration * 0x85EBCA6Bu + shard * 0xC2B2AE35u;
  return mix32(c ^ mix32(s ^ t));
}

// must match data/hashrng.py::hash_bits_at
inline uint32_t bits_at(uint32_t base, uint64_t ordinal) {
  uint32_t lo = static_cast<uint32_t>(ordinal & 0xFFFFFFFFull);
  uint32_t hi = static_cast<uint32_t>(ordinal >> 32);
  return mix32(lo ^ mix32(hi ^ 0xDEADBEEFu) ^ base);
}

// must match data/hashrng.py::hash_u01_at — (bits >> 8) is <= 2^24 (exact in f32)
// and the scale is a power of two, so this equals the numpy value bit-for-bit
inline float u01_at(uint32_t base, uint64_t ordinal) {
  return static_cast<float>(bits_at(base, ordinal) >> 8) * (1.0f / 16777216.0f);
}

constexpr uint32_t kStreamSubsample = 101;  // data/hashrng.py STREAM_SUBSAMPLE
constexpr uint32_t kStreamWindow = 102;     // data/hashrng.py STREAM_WINDOW

struct ThreadOut {
  std::vector<int32_t> centers;
  std::vector<int32_t> contexts;
  std::vector<int64_t> clock;  // kept-word ordinal LOCAL to this thread (0-based)
  int64_t kept = 0;
};

// Process sentences [s_lo, s_hi): subsample, draw windows, emit pairs.
// tok_off is the block-local index of sentence s_lo's first token.
void process_range(const int32_t* tokens, const int64_t* lengths, int64_t s_lo,
                   int64_t s_hi, int64_t tok_off, const float* keep, int32_t window,
                   bool legacy, uint32_t sub_base, uint32_t win_base,
                   uint64_t token_base, ThreadOut* out) {
  std::vector<int32_t> kept_toks;
  std::vector<int32_t> kept_b;  // window draw per kept token
  for (int64_t s = s_lo; s < s_hi; ++s) {
    const int64_t len = lengths[s];
    kept_toks.clear();
    kept_b.clear();
    for (int64_t i = 0; i < len; ++i) {
      const uint64_t ord = token_base + static_cast<uint64_t>(tok_off + i);
      const int32_t w = tokens[tok_off + i];
      if (u01_at(sub_base, ord) <= keep[w]) {
        kept_toks.push_back(w);
        kept_b.push_back(
            static_cast<int32_t>(bits_at(win_base, ord) % static_cast<uint32_t>(window)));
      }
    }
    const int64_t nk = static_cast<int64_t>(kept_toks.size());
    for (int64_t p = 0; p < nk; ++p) {
      const int32_t b = kept_b[p];
      const int64_t left = b < p ? b : p;
      int64_t right = legacy ? b - 1 : b;
      const int64_t avail = nk - 1 - p;
      if (right > avail) right = avail;
      if (right < 0) right = 0;
      const int32_t center = kept_toks[p];
      const int64_t my_clock = out->kept + p;  // kept ordinal of this center
      for (int64_t q = p - left; q < p; ++q) {
        out->centers.push_back(center);
        out->contexts.push_back(kept_toks[q]);
        out->clock.push_back(my_clock);
      }
      for (int64_t q = p + 1; q <= p + right; ++q) {
        out->centers.push_back(center);
        out->contexts.push_back(kept_toks[q]);
        out->clock.push_back(my_clock);
      }
    }
    out->kept += nk;
    tok_off += len;
  }
}

}  // namespace

extern "C" {

// Returns the number of pairs written (>= 0), or -1 if `cap` was too small.
// `out_kept` receives the number of tokens surviving subsampling.
// Caller guarantees cap >= n_tokens * max(2 * window - 2, 1) (the per-token pair bound).
int64_t glint_block_pairs(const int32_t* tokens, int64_t n_tokens,
                          const int64_t* lengths, int64_t n_sents, const float* keep,
                          int32_t window, int32_t legacy, uint32_t seed,
                          uint32_t iteration, uint32_t shard, uint64_t token_base,
                          int32_t n_threads, int32_t* out_centers,
                          int32_t* out_contexts, int64_t* out_clock, int64_t cap,
                          int64_t* out_kept) {
  if (n_tokens == 0 || n_sents == 0) {
    *out_kept = 0;
    return 0;
  }
  const uint32_t sub_base = stream_base(seed, kStreamSubsample, iteration, shard);
  const uint32_t win_base = stream_base(seed, kStreamWindow, iteration, shard);
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_sents) n_threads = static_cast<int32_t>(n_sents);

  // Partition whole sentences into ~equal-token ranges.
  std::vector<int64_t> range_lo(n_threads + 1, n_sents);
  std::vector<int64_t> range_tok(n_threads, 0);
  {
    range_lo[0] = 0;
    int64_t acc = 0, t = 1;
    const int64_t target = (n_tokens + n_threads - 1) / n_threads;
    for (int64_t s = 0; s < n_sents && t < n_threads; ++s) {
      acc += lengths[s];
      if (acc >= target * t) {
        range_lo[t] = s + 1;
        ++t;
      }
    }
    int64_t tok = 0, s = 0;
    for (int64_t i = 0; i < n_threads; ++i) {
      for (; s < range_lo[i]; ++s) tok += lengths[s];
      range_tok[i] = tok;
    }
  }

  std::vector<ThreadOut> outs(n_threads);
  {
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int32_t t = 0; t < n_threads; ++t) {
      threads.emplace_back(process_range, tokens, lengths, range_lo[t],
                           range_lo[t + 1], range_tok[t], keep, window,
                           legacy != 0, sub_base, win_base, token_base, &outs[t]);
    }
    for (auto& th : threads) th.join();
  }

  int64_t n_pairs = 0, kept = 0;
  for (const auto& o : outs) {
    n_pairs += static_cast<int64_t>(o.centers.size());
    kept += o.kept;
  }
  *out_kept = kept;
  if (n_pairs > cap) return -1;

  int64_t pair_off = 0, kept_off = 0;
  for (const auto& o : outs) {
    const int64_t n = static_cast<int64_t>(o.centers.size());
    std::memcpy(out_centers + pair_off, o.centers.data(), n * sizeof(int32_t));
    std::memcpy(out_contexts + pair_off, o.contexts.data(), n * sizeof(int32_t));
    for (int64_t i = 0; i < n; ++i)
      out_clock[pair_off + i] = o.clock[i] + kept_off + 1;  // 1-based global ordinal
    pair_off += n;
    kept_off += o.kept;
  }
  return n_pairs;
}

// ABI version stamp so the Python wrapper can detect stale cached builds.
int32_t glint_pairgen_abi_version() { return 1; }

}  // extern "C"
