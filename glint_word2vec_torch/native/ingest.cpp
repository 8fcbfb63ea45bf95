// Native corpus ingestion: the tokenize+count and tokenize+encode passes of the
// streaming data loader (data/corpus.py / data/vocab.py), ~4-5x the pure-Python
// throughput. Replaces the hot inner loops only — vocabulary filter/sort rules
// and metadata stay in Python (data/ingest_native.py) so the ordering contract
// (count desc, stable on first occurrence — the reference's sortWith,
// mllib:266) lives in exactly one place.
//
// Tokenization contract: BIT-IDENTICAL to the Python path
// (TokenFileCorpus: text-mode line iteration + line.split()) or REFUSE.
// Each buffer is scanned first; if it contains anything whose semantics differ
// between this ASCII tokenizer and Python — unicode whitespace (U+00A0,
// U+2000-200A, ...), C0 separators 0x1C-0x1F, a lone \r (a Python universal-
// newline line break), or invalid UTF-8 (Python substitutes U+FFFD) — the call
// returns NEEDS_PYTHON and the wrapper silently falls back. Valid multi-byte
// UTF-8 (accents etc.) is fine: byte-level tokens match Python's str tokens.
//
// Memory contract: same as the Python pass — O(wave) not O(file). The file is
// processed in line-aligned ~64 MB ranges, n_threads at a time; each wave's
// buffers and outputs are written and freed before the next starts (the count
// pass's vocabulary map is the only thing that grows with corpus size, exactly
// like Python's Counter).
//
// Plain C ABI over files (no Python headers): the count pass writes words in
// FIRST-SEEN order (+ int64 counts), the encode pass writes the exact
// tokens.bin/offsets.bin layout EncodedCorpus mmaps.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr int64_t kChunk = 64 << 20;  // per-range text budget (wave = T ranges)
constexpr int64_t kNeedsPython = -2;  // tokenization semantics differ: fall back

struct WordStat {
  int64_t count = 0;
  int64_t first_pos = 0;  // byte offset of first occurrence (global order key)
};

// transparent hashing: the hot loops look words up by string_view (no per-token
// allocation); std::string keys are built only on first insertion
struct SvHash {
  using is_transparent = void;
  size_t operator()(std::string_view sv) const {
    return std::hash<std::string_view>{}(sv);
  }
};
struct SvEq {
  using is_transparent = void;
  bool operator()(std::string_view a, std::string_view b) const {
    return a == b;
  }
};
template <typename V>
using SvMap = std::unordered_map<std::string, V, SvHash, SvEq>;

inline bool is_space(unsigned char c) {
  return c == ' ' || c == '\t' || c == '\r' || c == '\v' || c == '\f';
}

// True iff Python's text-mode + line.split() would tokenize [p, end) exactly
// like the ASCII tokenizer below. Checks: C0 separators 0x1C-0x1F (Python
// str.split whitespace), lone \r (universal-newline line break), invalid
// UTF-8 (errors="replace" merges distinct byte strings), and every unicode
// whitespace code point Python splits on (0x85, 0xA0, 0x1680, 0x2000-0x200A,
// 0x2028, 0x2029, 0x202F, 0x205F, 0x3000 — the full set str.isspace() accepts
// beyond ASCII, cross-checked against CPython).
bool python_semantics_match(const unsigned char* p, const unsigned char* end) {
  while (p < end) {
    unsigned char c = *p;
    if (c < 0x80) {
      if (c >= 0x1C && c <= 0x1F) return false;
      if (c == '\r' && (p + 1 == end || p[1] != '\n')) return false;
      ++p;
      continue;
    }
    // decode one UTF-8 sequence (strict: no overlong, no surrogates)
    uint32_t cp;
    int n;
    if ((c & 0xE0) == 0xC0) { cp = c & 0x1F; n = 1; }
    else if ((c & 0xF0) == 0xE0) { cp = c & 0x0F; n = 2; }
    else if ((c & 0xF8) == 0xF0) { cp = c & 0x07; n = 3; }
    else return false;                       // stray continuation / invalid
    if (end - p <= n) return false;          // truncated sequence
    for (int i = 1; i <= n; ++i) {
      if ((p[i] & 0xC0) != 0x80) return false;
      cp = (cp << 6) | (p[i] & 0x3F);
    }
    if (n == 1 && cp < 0x80) return false;             // overlong
    if (n == 2 && cp < 0x800) return false;            // overlong
    if (n == 3 && cp < 0x10000) return false;          // overlong
    if (cp >= 0xD800 && cp <= 0xDFFF) return false;    // surrogate
    if (cp > 0x10FFFF) return false;
    if (cp == 0x85 || cp == 0xA0 || cp == 0x1680 ||
        (cp >= 0x2000 && cp <= 0x200A) || cp == 0x2028 || cp == 0x2029 ||
        cp == 0x202F || cp == 0x205F || cp == 0x3000)
      return false;                                    // unicode whitespace
    p += n + 1;
  }
  return true;
}

// 64-bit seek/tell everywhere: plain fseek takes a long, which is 32-bit on
// Windows/ILP32 and would truncate offsets past 2 GiB in exactly the multi-GB
// corpora this loader targets.
int seek64(std::FILE* f, int64_t pos, int whence) {
#ifdef _WIN32
  return _fseeki64(f, pos, whence);
#else
  return fseeko(f, static_cast<off_t>(pos), whence);
#endif
}

int64_t tell64(std::FILE* f) {
#ifdef _WIN32
  return _ftelli64(f);
#else
  return static_cast<int64_t>(ftello(f));
#endif
}

// Read [lo, hi) of the file, already line-aligned by the caller.
std::vector<char> read_range(std::FILE* f, int64_t lo, int64_t hi) {
  std::vector<char> buf(static_cast<size_t>(hi - lo));
  if (!buf.empty()) {
    seek64(f, lo, SEEK_SET);
    size_t got = std::fread(buf.data(), 1, buf.size(), f);
    buf.resize(got);
  }
  return buf;
}

// Split [0, size) into ~(size/kChunk) line-aligned ranges (each ends just
// after a '\n'), so waves of n_threads ranges bound peak memory.
std::vector<int64_t> line_aligned_cuts(std::FILE* f, int64_t size) {
  int n = static_cast<int>(std::max<int64_t>(1, (size + kChunk - 1) / kChunk));
  std::vector<int64_t> cuts{0};
  for (int i = 1; i < n; ++i) {
    int64_t target = size * i / n;
    if (target <= cuts.back()) continue;
    seek64(f, target, SEEK_SET);
    int c;
    int64_t pos = target;
    while ((c = std::fgetc(f)) != EOF) {
      ++pos;
      if (c == '\n') break;
    }
    if (pos < size && pos > cuts.back()) cuts.push_back(pos);
  }
  cuts.push_back(size);
  return cuts;
}

int64_t file_size(std::FILE* f) {
  seek64(f, 0, SEEK_END);
  int64_t n = tell64(f);
  seek64(f, 0, SEEK_SET);
  return n;
}

}  // namespace

extern "C" {

int32_t glint_ingest_abi_version() { return 2; }

// Pass 1: count words. Writes out_words (newline-separated, FIRST-SEEN file
// order) and out_counts (int64[n], same order). Returns the number of distinct
// words, -1 on I/O error, or -2 when the corpus needs Python tokenization
// semantics (caller falls back).
int64_t glint_ingest_count(const char* corpus_path, const char* out_words,
                           const char* out_counts, int32_t n_threads) {
  std::FILE* f = std::fopen(corpus_path, "rb");
  if (!f) return -1;
  int64_t size = file_size(f);
  auto cuts = line_aligned_cuts(f, size);
  std::fclose(f);
  int R = static_cast<int>(cuts.size()) - 1;
  int T = std::max(1, static_cast<int>(n_threads));

  SvMap<WordStat> all;
  std::atomic<bool> io_error{false};
  std::atomic<bool> mismatch{false};
  for (int w0 = 0; w0 < R && !io_error && !mismatch; w0 += T) {
    int nw = std::min(T, R - w0);
    std::vector<SvMap<WordStat>> maps(nw);
    std::vector<std::thread> threads;
    for (int i = 0; i < nw; ++i) {
      threads.emplace_back([&, i]() {
        int r = w0 + i;
        std::FILE* fr = std::fopen(corpus_path, "rb");
        if (!fr) { io_error = true; return; }
        auto buf = read_range(fr, cuts[r], cuts[r + 1]);
        std::fclose(fr);
        const unsigned char* ub =
            reinterpret_cast<const unsigned char*>(buf.data());
        if (!python_semantics_match(ub, ub + buf.size())) {
          mismatch = true;
          return;
        }
        auto& m = maps[i];
        m.reserve(1 << 16);
        const char* p = buf.data();
        const char* end = p + buf.size();
        const char* base = buf.data();
        while (p < end) {
          while (p < end &&
                 (is_space(static_cast<unsigned char>(*p)) || *p == '\n'))
            ++p;
          const char* w = p;
          while (p < end && !is_space(static_cast<unsigned char>(*p)) &&
                 *p != '\n')
            ++p;
          if (p > w) {
            std::string_view sv(w, static_cast<size_t>(p - w));
            auto it = m.find(sv);
            if (it == m.end()) {
              it = m.emplace(std::string(sv),
                             WordStat{0, cuts[r] + (w - base)}).first;
            }
            ++it->second.count;
          }
        }
      });
    }
    for (auto& t : threads) t.join();
    if (io_error || mismatch) break;
    // merge this wave in range order; keep the globally-first position
    for (auto& m : maps) {
      for (auto& kv : m) {
        auto ins = all.emplace(kv.first, kv.second);
        if (!ins.second) {
          ins.first->second.count += kv.second.count;
          ins.first->second.first_pos = std::min(ins.first->second.first_pos,
                                                 kv.second.first_pos);
        }
      }
    }
  }
  if (io_error) return -1;
  if (mismatch) return kNeedsPython;

  // first-seen file order == ascending first_pos
  std::vector<std::pair<const std::string*, const WordStat*>> order;
  order.reserve(all.size());
  for (auto& kv : all) order.emplace_back(&kv.first, &kv.second);
  std::sort(order.begin(), order.end(),
            [](const auto& a, const auto& b) {
              return a.second->first_pos < b.second->first_pos;
            });

  std::FILE* fw = std::fopen(out_words, "wb");
  std::FILE* fc = std::fopen(out_counts, "wb");
  if (!fw || !fc) {
    if (fw) std::fclose(fw);
    if (fc) std::fclose(fc);
    return -1;
  }
  for (auto& e : order) {
    std::fwrite(e.first->data(), 1, e.first->size(), fw);
    std::fputc('\n', fw);
    std::fwrite(&e.second->count, sizeof(int64_t), 1, fc);
  }
  std::fclose(fw);
  std::fclose(fc);
  return static_cast<int64_t>(order.size());
}

// Pass 2: encode. vocab_words is the FINAL vocabulary (newline-separated, line
// index == id). Writes tokens.bin (int32) and offsets.bin (int64, leading 0,
// one entry per emitted sentence chunk) exactly as data/corpus.py's
// encode_corpus does: OOV dropped, empty sentences skipped, chunked to
// max_sentence_length. Returns total tokens written (>= 0), -1 on error, -2
// when the corpus needs Python tokenization semantics. out_n_sents receives
// the number of sentence chunks.
int64_t glint_ingest_encode(const char* corpus_path, const char* vocab_words,
                            int32_t max_sentence_length,
                            const char* out_tokens, const char* out_offsets,
                            int32_t n_threads, int64_t* out_n_sents) {
  // vocabulary: word -> id
  SvMap<int32_t> index;
  {
    std::FILE* fv = std::fopen(vocab_words, "rb");
    if (!fv) return -1;
    auto buf = read_range(fv, 0, file_size(fv));
    std::fclose(fv);
    const char* p = buf.data();
    const char* end = p + buf.size();
    int32_t id = 0;
    index.reserve(1 << 16);
    while (p < end) {
      const char* w = p;
      while (p < end && *p != '\n') ++p;
      if (p > w) index.emplace(std::string(w, p - w), id++);
      if (p < end) ++p;
    }
  }

  std::FILE* f = std::fopen(corpus_path, "rb");
  if (!f) return -1;
  int64_t size = file_size(f);
  auto cuts = line_aligned_cuts(f, size);
  std::fclose(f);
  int R = static_cast<int>(cuts.size()) - 1;
  int T = std::max(1, static_cast<int>(n_threads));
  const int32_t msl = std::max(1, max_sentence_length);

  std::FILE* ft = std::fopen(out_tokens, "wb");
  std::FILE* fo = std::fopen(out_offsets, "wb");
  if (!ft || !fo) {
    if (ft) std::fclose(ft);
    if (fo) std::fclose(fo);
    return -1;
  }
  int64_t total = 0, nsents = 0;
  std::fwrite(&total, sizeof(int64_t), 1, fo);  // leading 0

  struct RangeOut {
    std::vector<int32_t> tokens;
    std::vector<int32_t> sent_lens;  // per emitted chunk
  };
  std::atomic<bool> io_error{false};
  std::atomic<bool> mismatch{false};
  for (int w0 = 0; w0 < R && !io_error && !mismatch; w0 += T) {
    int nw = std::min(T, R - w0);
    std::vector<RangeOut> outs(nw);
    std::vector<std::thread> threads;
    for (int i = 0; i < nw; ++i) {
      threads.emplace_back([&, i]() {
        int r = w0 + i;
        std::FILE* fr = std::fopen(corpus_path, "rb");
        if (!fr) { io_error = true; return; }
        auto buf = read_range(fr, cuts[r], cuts[r + 1]);
        std::fclose(fr);
        const unsigned char* ub =
            reinterpret_cast<const unsigned char*>(buf.data());
        if (!python_semantics_match(ub, ub + buf.size())) {
          mismatch = true;
          return;
        }
        auto& out = outs[i];
        std::vector<int32_t> ids;
        const char* p = buf.data();
        const char* end = p + buf.size();
        while (p <= end) {
          bool line_end = (p == end) || (*p == '\n');
          if (line_end) {
            for (size_t s = 0; s < ids.size(); s += msl) {
              size_t n = std::min(ids.size() - s, static_cast<size_t>(msl));
              out.tokens.insert(out.tokens.end(), ids.begin() + s,
                                ids.begin() + s + n);
              out.sent_lens.push_back(static_cast<int32_t>(n));
            }
            ids.clear();
            if (p == end) break;
            ++p;
            continue;
          }
          while (p < end && is_space(static_cast<unsigned char>(*p))) ++p;
          const char* w = p;
          while (p < end && !is_space(static_cast<unsigned char>(*p)) &&
                 *p != '\n')
            ++p;
          if (p > w) {
            auto it = index.find(
                std::string_view(w, static_cast<size_t>(p - w)));
            if (it != index.end()) ids.push_back(it->second);
          }
        }
      });
    }
    for (auto& t : threads) t.join();
    if (io_error || mismatch) break;
    for (auto& out : outs) {  // write this wave in range order, then free it
      if (!out.tokens.empty())
        std::fwrite(out.tokens.data(), sizeof(int32_t), out.tokens.size(), ft);
      for (int32_t len : out.sent_lens) {
        total += len;
        ++nsents;
        std::fwrite(&total, sizeof(int64_t), 1, fo);
      }
    }
  }
  std::fclose(ft);
  std::fclose(fo);
  if (io_error) return -1;
  if (mismatch) return kNeedsPython;
  if (out_n_sents) *out_n_sents = nsents;
  return total;
}

}  // extern "C"
