// Native libsvm/libffm batch parser for fast_tffm_tpu_torch: the port's own
// copy of the JAX package's csrc/libsvm_parser.cpp, unchanged in behaviour.
//
// In-kind replacement for the reference's FmParser C++ TensorFlow op
// (renyi533/fast_tffm :: cc/ parser kernel: libsvm text -> labels, feature
// ids, values, row offsets, with optional feature-id hashing).  Rather than
// a TF op, this is a plain C ABI consumed through ctypes
// (fast_tffm_tpu_torch/data/native.py), producing the framework's padded dense
// batch directly into caller-allocated NumPy buffers.
//
// Contract (must stay bit-identical with the Python reference parser in
// fast_tffm_tpu_torch/data/libsvm.py):
//   * line grammar: "label feat:val ..." or "label field:feat:val ..."
//   * labels <= 0 map to 0.0, otherwise 1.0
//   * hashing: 64-bit FNV-1a over the raw feature token bytes, mod vocab
//   * padding: ids/vals/fields zero-filled beyond each row's nnz
//   * floats: decimal -> double -> float32, matching Python float() + the
//     np.float32 cast (NOT strtof, whose single-rounding direct-to-float
//     result can differ in the last ulp)
//
// The number parsers are hand-rolled because strtod/strtoll dominate the
// profile on CTR-style data (~40 numeric tokens per line): the fast path
// (Clinger's bound — mantissa value <= 2^53, |decimal exponent| <= 22,
// which covers the 16-17 digit shortest-repr of float32 values) computes
// mantissa * 10^e in one correctly-rounded double operation — provably
// identical to strtod there — and anything else falls back to strtod.
// Scanning is fused with parsing: the hot (non-hash) path touches each
// token's characters once, except that a fractional value's integer digits
// are seen twice (scan_int tries them before scan_double_fast re-reads).
//
// Build: fast_tffm_tpu_torch/ops/kernel_build.py::load_host, at first use:
//   g++ -O2 -fPIC -std=c++17 -pthread -shared -o _build/liblibsvm_parser.so

#include <atomic>
#include <cctype>
#include <cerrno>
#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <utility>
#include <vector>

namespace {

constexpr uint64_t kFnvOffset = 0xcbf29ce484222325ULL;
constexpr uint64_t kFnvPrime = 0x100000001b3ULL;

inline uint64_t fnv1a64(const char* data, int64_t len) {
  uint64_t h = kFnvOffset;
  for (int64_t i = 0; i < len; ++i) {
    h = (h ^ static_cast<uint8_t>(data[i])) * kFnvPrime;
  }
  return h;
}

// Matches Python str.split() whitespace for the characters that can appear
// inside a line ('\n' is always a terminator before tokenization).
inline bool is_space(char c) {
  return c == ' ' || c == '\t' || c == '\r' || c == '\v' || c == '\f';
}

// Error codes mirrored in data/native.py.
enum ErrorCode {
  kOk = 0,
  kEmptyLine = 1,
  kBadLabel = 2,
  kBadToken = 3,
  kIdOutOfRange = 4,
  kRowTooWide = 5,
  kReadError = 6,
};

// Powers of ten exactly representable in double (10^0 .. 10^22).
const double kPow10[] = {1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,
                         1e8,  1e9,  1e10, 1e11, 1e12, 1e13, 1e14, 1e15,
                         1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};

// Everything the Clinger fast path declines (16+ digit mantissas above
// 2^53, |exp10| > 22, inf/nan): first std::from_chars — correctly rounded,
// Eisel-Lemire-class speed, no NUL-copy — then strtod as the semantic
// backstop for what from_chars doesn't accept (leading '+' is skipped
// manually since Python float() allows it; overflow/underflow tokens like
// "1e999"/"1e-999" fall through to strtod, which maps them to ±inf/±0
// exactly as Python does).
inline bool slow_double(const char* p, const char* end, double* out) {
  size_t len = static_cast<size_t>(end - p);
  if (len == 0) return false;
  const char* q = p;
  if (*q == '+') ++q;  // from_chars rejects an explicit plus; Python doesn't
  if (q < end) {
    double v;
    auto [ptr, ec] = std::from_chars(q, end, v, std::chars_format::general);
    if (ec == std::errc() && ptr == end) {
      *out = v;
      return true;
    }
  }
  char stackbuf[64];
  std::string heapbuf;
  char* tmp;
  if (len < sizeof(stackbuf)) {
    tmp = stackbuf;
  } else {
    heapbuf.resize(len + 1);
    tmp = heapbuf.data();
  }
  memcpy(tmp, p, len);
  tmp[len] = '\0';
  char* after = nullptr;
  errno = 0;
  double v = strtod(tmp, &after);
  // Python float() accepts "1e999" as inf; strtod sets ERANGE but returns
  // HUGE_VAL, which is the same inf — only reject on no-parse.
  if (after != tmp + len) return false;
  *out = v;
  return true;
}

// Parse a full-token decimal integer (optional sign, digits only — the
// subset Python int(tok) accepts that feature-id tokens use).
inline bool parse_int(const char* p, const char* end, int64_t* out) {
  const char* q = p;
  bool neg = false;
  if (q < end && (*q == '+' || *q == '-')) {
    neg = (*q == '-');
    ++q;
  }
  if (q >= end) return false;
  uint64_t v = 0;
  while (q < end) {
    if (*q < '0' || *q > '9') return false;
    if (v > (UINT64_MAX - 9) / 10) return false;  // uint64 overflow
    v = v * 10 + static_cast<uint64_t>(*q - '0');
    ++q;
  }
  // Values beyond int64 range are rejected, never wrapped (Python's big
  // ints fail the range check / numpy cast downstream; both paths error).
  if (v > static_cast<uint64_t>(INT64_MAX)) return false;
  *out = neg ? -static_cast<int64_t>(v) : static_cast<int64_t>(v);
  return true;
}

// Scan a decimal number starting at p, stopping at the first character that
// cannot extend it (single fused pass — scanning IS parsing; tokens are
// never re-walked).  Returns the cursor after the number with *out set, or
// nullptr when the fast path cannot guarantee Python-float() bit-parity
// (no digits, 16+ digits, |exp10| > 22, malformed exponent) — the caller
// then re-parses the full whitespace-delimited token through slow_double.
inline const char* scan_double_fast(const char* p, const char* end,
                                    double* out) {
  const char* q = p;
  bool neg = false;
  if (q < end && (*q == '+' || *q == '-')) {
    neg = (*q == '-');
    ++q;
  }
  // Clinger's exactness bound: the fast path is provably correctly rounded
  // whenever the mantissa is exactly representable in a double (<= 2^53)
  // and the scaling power of ten is exact (|exp10| <= 22).  Accumulating
  // up to 19 digits (vs. stopping at 15 significant) matters in practice:
  // shortest-repr float32 values round-trip through 16-17 digit decimals.
  constexpr uint64_t kMantNoOverflow = (UINT64_MAX - 9) / 10;
  constexpr uint64_t kMantExact = 1ULL << 53;
  const char* d0 = q;
  uint64_t mant = 0;
  while (q < end) {
    unsigned c = static_cast<unsigned char>(*q) - '0';
    if (c > 9) break;
    if (mant > kMantNoOverflow) return nullptr;  // 20+ digits: slow path
    mant = mant * 10 + c;
    ++q;
  }
  const char* d1 = q;
  int frac = 0;
  if (q < end && *q == '.') {
    ++q;
    const char* f0 = q;
    while (q < end) {
      unsigned c = static_cast<unsigned char>(*q) - '0';
      if (c > 9) break;
      if (mant > kMantNoOverflow) return nullptr;
      mant = mant * 10 + c;
      ++q;
    }
    frac = static_cast<int>(q - f0);
  }
  int ndig = static_cast<int>(d1 - d0) + frac;
  if (ndig == 0 || mant > kMantExact) return nullptr;
  int exp10 = -frac;
  if (q < end && (*q == 'e' || *q == 'E')) {
    ++q;
    bool eneg = false;
    if (q < end && (*q == '+' || *q == '-')) {
      eneg = (*q == '-');
      ++q;
    }
    const char* e0 = q;
    int e = 0;
    while (q < end) {
      unsigned c = static_cast<unsigned char>(*q) - '0';
      if (c > 9) break;
      if (e < 100000) e = e * 10 + static_cast<int>(c);
      ++q;
    }
    if (q == e0) return nullptr;  // "1e" / "1e+": slow path rejects
    exp10 += eneg ? -e : e;
  }
  double d;
  if (exp10 >= 0) {
    if (exp10 > 22) return nullptr;
    d = static_cast<double>(mant) * kPow10[exp10];  // one rounding: exact
  } else {
    if (exp10 < -22) return nullptr;
    d = static_cast<double>(mant) / kPow10[-exp10];  // one rounding: exact
  }
  *out = neg ? -d : d;
  return q;
}

// Scan an optionally-signed decimal integer, stopping at the first
// non-digit.  Returns the cursor after the digits, or nullptr on no digits
// or int64 overflow (matching parse_int's rejection).
inline const char* scan_int(const char* p, const char* end, int64_t* out) {
  const char* q = p;
  bool neg = false;
  if (q < end && (*q == '+' || *q == '-')) {
    neg = (*q == '-');
    ++q;
  }
  const char* d0 = q;
  uint64_t v = 0;
  while (q < end) {
    unsigned c = static_cast<unsigned char>(*q) - '0';
    if (c > 9) break;
    if (v > (UINT64_MAX - 9) / 10) return nullptr;
    v = v * 10 + c;
    ++q;
  }
  if (q == d0) return nullptr;
  if (v > static_cast<uint64_t>(INT64_MAX)) return nullptr;
  *out = neg ? -static_cast<int64_t>(v) : static_cast<int64_t>(v);
  return q;
}

struct LineSpan {
  const char* begin;
  const char* end;
};

// Whitespace-separated token count of one line (the shared tokenizer for
// the shape scans; parse_line has its own fused scan).
inline int64_t count_tokens(const char* q, const char* end) {
  int64_t toks = 0;
  while (q < end) {
    while (q < end && is_space(*q)) ++q;
    if (q >= end) break;
    ++toks;
    while (q < end && !is_space(*q)) ++q;
  }
  return toks;
}

// Collect non-blank line spans (at most n when n >= 0).
inline void collect_lines(const char* buf, int64_t n,
                          std::vector<LineSpan>* out) {
  const char* p = buf;
  while (*p && (n < 0 || static_cast<int64_t>(out->size()) < n)) {
    const char* eol = static_cast<const char*>(strchr(p, '\n'));
    const char* end = eol ? eol : p + strlen(p);
    const char* q = p;
    while (q < end && is_space(*q)) ++q;
    if (q < end) out->push_back({p, end});
    p = eol ? eol + 1 : end;
  }
}

// Parse one line into row `li` of the output buffers.  Returns an ErrorCode.
// IdT is the feature-id output type: int64_t mirrors the Python parser's
// dtype; int32_t feeds the device batch directly (device ids are int32), which
// halves the largest host->device transfer.  The vocabulary bound check
// keeps either type exact (callers pick int32 only when vocab fits).
template <typename IdT>
inline int32_t parse_line(const char* p, const char* end, int64_t li,
                          int64_t width, int64_t vocabulary_size,
                          int32_t hash_feature_id, float* labels, IdT* ids,
                          float* vals, int32_t* fields, int32_t* nnz) {
  const char* q = p;
  while (q < end && is_space(*q)) ++q;
  if (q >= end) return kEmptyLine;

  // Label: fused scan; anything the fast scan can't finish (or that does
  // not end at whitespace) re-parses the whole token via the slow path.
  double y;
  {
    const char* tok = q;
    const char* after = scan_double_fast(q, end, &y);
    if (after && (after >= end || is_space(*after))) {
      q = after;
    } else {
      while (q < end && !is_space(*q)) ++q;
      if (!slow_double(tok, q, &y)) return kBadLabel;
    }
  }
  labels[li] = y <= 0.0 ? 0.0f : 1.0f;

  // Feature tokens: "feat:val" or "field:feat:val".  The hot (non-hash)
  // path walks each token exactly once — the digit scans both segment and
  // parse; only exotic tokens fall back to a find-token-end + slow re-parse.
  int64_t m = 0;
  IdT* row_ids = ids + li * width;
  float* row_vals = vals + li * width;
  int32_t* row_fields = fields + li * width;
  while (q < end) {
    while (q < end && is_space(*q)) ++q;
    if (q >= end) break;
    int64_t field = 0;
    int64_t fid;
    if (!hash_feature_id) {
      int64_t a;
      const char* p1 = scan_int(q, end, &a);
      if (!p1 || p1 >= end || *p1 != ':') return kBadToken;
      ++p1;  // past ':'
      int64_t b;
      const char* p2 = scan_int(p1, end, &b);
      if (p2 && p2 < end && *p2 == ':') {
        field = a;  // field:feat:val
        fid = b;
        q = p2 + 1;
      } else {
        fid = a;  // feat:val
        q = p1;
      }
      if (fid < 0 || fid >= vocabulary_size) return kIdOutOfRange;
    } else {
      // Hash mode: feature tokens are raw bytes, so the colon structure
      // needs one explicit pass to the token end.
      const char* tok = q;
      const char* c1 = nullptr;
      const char* c2 = nullptr;
      const char* t = q;
      while (t < end && !is_space(*t)) {
        if (*t == ':') {
          if (!c1) {
            c1 = t;
          } else if (!c2) {
            c2 = t;
          }
        }
        ++t;
      }
      // An empty feature name is ACCEPTED (hashed as zero bytes) in both
      // the ':val' and 'field::val' forms — Python's tok.split(':') does
      // the same; only an empty VALUE segment is a bad token.
      if (!c1 || c1 + 1 >= t) return kBadToken;
      const char* feat_begin;
      const char* feat_end;
      if (c2) {
        if (c2 + 1 >= t) return kBadToken;
        if (!parse_int(tok, c1, &field)) return kBadToken;
        feat_begin = c1 + 1;
        feat_end = c2;
      } else {
        feat_begin = tok;
        feat_end = c1;
      }
      fid = static_cast<int64_t>(fnv1a64(feat_begin, feat_end - feat_begin) %
                                 static_cast<uint64_t>(vocabulary_size));
      q = (c2 ? c2 : c1) + 1;  // value begins after the last split colon
    }
    double v;
    {
      const char* vtok = q;
      const char* va = scan_double_fast(q, end, &v);
      if (va && (va >= end || is_space(*va))) {
        q = va;
      } else {
        while (q < end && !is_space(*q)) ++q;
        if (!slow_double(vtok, q, &v)) return kBadToken;
      }
    }
    if (m >= width) return kRowTooWide;
    row_ids[m] = static_cast<IdT>(fid);
    row_vals[m] = static_cast<float>(v);
    row_fields[m] = static_cast<int32_t>(field);
    ++m;
  }
  nnz[li] = static_cast<int32_t>(m);
  return kOk;
}

template <typename IdT>
int32_t parse_span_range(const std::vector<LineSpan>& spans, int64_t lo,
                         int64_t hi, int64_t width, int64_t vocabulary_size,
                         int32_t hash_feature_id, float* labels, IdT* ids,
                         float* vals, int32_t* fields, int32_t* nnz,
                         int64_t* error_line) {
  for (int64_t li = lo; li < hi; ++li) {
    int32_t code =
        parse_line(spans[li].begin, spans[li].end, li, width, vocabulary_size,
                   hash_feature_id, labels, ids, vals, fields, nnz);
    if (code != kOk) {
      *error_line = li;
      return code;
    }
  }
  return kOk;
}

// Parse every span, spreading rows over a std::thread pool when it pays.
// Threads write disjoint row ranges; the FIRST error by line index wins,
// matching single-threaded reporting order.
template <typename IdT>
int32_t parse_spans_mt(const std::vector<LineSpan>& spans, int64_t width,
                       int64_t vocabulary_size, int32_t hash_feature_id,
                       int32_t threads, float* labels, IdT* ids,
                       float* vals, int32_t* fields, int32_t* nnz,
                       int64_t* error_line) {
  const int64_t rows = static_cast<int64_t>(spans.size());
  if (threads <= 1 || rows < 2 * threads) {
    return parse_span_range(spans, 0, rows, width, vocabulary_size,
                            hash_feature_id, labels, ids, vals, fields, nnz,
                            error_line);
  }
  std::atomic<int64_t> first_bad(INT64_MAX);
  std::vector<int32_t> codes(static_cast<size_t>(threads), kOk);
  std::vector<int64_t> errs(static_cast<size_t>(threads), -1);
  std::vector<std::thread> pool;
  pool.reserve(static_cast<size_t>(threads));
  const int64_t chunk = (rows + threads - 1) / threads;
  for (int32_t t = 0; t < threads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = lo + chunk < rows ? lo + chunk : rows;
    if (lo >= hi) break;
    pool.emplace_back([&, t, lo, hi]() {
      int64_t err = -1;
      int32_t code = parse_span_range(spans, lo, hi, width, vocabulary_size,
                                      hash_feature_id, labels, ids, vals,
                                      fields, nnz, &err);
      if (code != kOk) {
        codes[static_cast<size_t>(t)] = code;
        errs[static_cast<size_t>(t)] = err;
        int64_t cur = first_bad.load();
        while (err < cur && !first_bad.compare_exchange_weak(cur, err)) {
        }
      }
    });
  }
  for (auto& th : pool) th.join();
  const int64_t bad = first_bad.load();
  if (bad == INT64_MAX) return kOk;
  for (size_t t = 0; t < errs.size(); ++t) {
    if (errs[t] == bad) {
      *error_line = bad;
      return codes[t];
    }
  }
  return kOk;  // unreachable
}

}  // namespace

extern "C" {

// Exposed for cross-checking the hash against the Python implementation.
uint64_t fm_fnv1a64(const char* data, int64_t len) { return fnv1a64(data, len); }

// Scan a NUL-terminated buffer of newline-separated lines; report the line
// count (blank lines skipped) and the widest row's nnz.
void fm_parse_shape(const char* buf, int64_t* n_lines, int64_t* widest) {
  int64_t lines = 0, wide = 0;
  const char* p = buf;
  while (*p) {
    const char* eol = strchr(p, '\n');
    const char* end = eol ? eol : p + strlen(p);
    const int64_t toks = count_tokens(p, end);
    if (toks > 0) {
      ++lines;
      if (toks - 1 > wide) wide = toks - 1;
    }
    p = eol ? eol + 1 : end;
  }
  *n_lines = lines;
  *widest = wide;
}

// Parse into caller-allocated buffers, optionally with a worker-thread pool
// (the in-kernel analog of the reference trainer's cfg-driven parse-thread
// count).  Returns an ErrorCode; on error, *error_line holds the (0-based,
// blank-skipped) first offending line index.
//
//   labels: float32[n]      ids: int64[n*width]   vals: float32[n*width]
//   fields: int32[n*width]  nnz: int32[n]
int32_t fm_parse_mt(const char* buf, int64_t n, int64_t width,
                    int64_t vocabulary_size, int32_t hash_feature_id,
                    int32_t threads, float* labels, int64_t* ids, float* vals,
                    int32_t* fields, int32_t* nnz, int64_t* error_line) {
  memset(ids, 0, sizeof(int64_t) * n * width);
  memset(vals, 0, sizeof(float) * n * width);
  memset(fields, 0, sizeof(int32_t) * n * width);
  memset(nnz, 0, sizeof(int32_t) * n);

  std::vector<LineSpan> spans;
  spans.reserve(static_cast<size_t>(n));
  collect_lines(buf, n, &spans);
  return parse_spans_mt(spans, width, vocabulary_size, hash_feature_id,
                        threads, labels, ids, vals, fields, nnz, error_line);
}

// Single-threaded entry kept for ABI compatibility with older bindings.
int32_t fm_parse(const char* buf, int64_t n, int64_t width,
                 int64_t vocabulary_size, int32_t hash_feature_id,
                 float* labels, int64_t* ids, float* vals, int32_t* fields,
                 int32_t* nnz, int64_t* error_line) {
  return fm_parse_mt(buf, n, width, vocabulary_size, hash_feature_id, 1,
                     labels, ids, vals, fields, nnz, error_line);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Streaming batch reader: the native data-loader.
//
// The reference fed its FmParser op from TF queue-runner threads doing the
// file reading and batching in Python/TF; here the WHOLE host input path —
// chunked file reads, line splitting, round-robin worker sharding, parsing
// into the padded batch — lives in C++ behind three C ABI calls, so the
// Python caller never touches individual lines (its per-line loop costs as
// much as the parse itself).  data/pipeline.py routes through this whenever
// the caller's parser is the native one.
// ---------------------------------------------------------------------------

namespace {

struct FmReader {
  FILE* f = nullptr;
  std::vector<char> buf;     // read window
  size_t pos = 0, len = 0;   // unconsumed span within buf
  std::string tail;          // partial line carried across refills
  bool tail_valid = false;   // tail holds a complete final unterminated line
  bool eof = false;
  bool read_error = false;   // fread failed mid-file (NOT clean EOF)
  int64_t shard_index = 0, shard_count = 1;
  int64_t shard_block = 1;   // lines per shard block (block-cyclic assignment)
  int64_t counter = 0;       // global non-blank line index (spans files)
  // Per-call arena for the selected lines (stable while parsing).
  std::string arena;
  std::vector<std::pair<size_t, size_t>> offsets;  // (offset, len) into arena
};

// First '\n' OR '\r' in [p, p+len) — universal-newline line terminators,
// matching the Python path's text-mode open().  A '\r\n' pair produces an
// empty second line, which the blank-line skip discards.
inline const char* find_eol(const char* p, size_t len) {
  const char* lf = static_cast<const char*>(memchr(p, '\n', len));
  const char* cr = static_cast<const char*>(
      memchr(p, '\r', lf ? static_cast<size_t>(lf - p) : len));
  return cr ? cr : lf;
}

// Pull the next raw line span out of the buffered file.  Returns false at
// EOF.  The returned span is valid until the next call (it may point into
// r->tail or r->buf).
bool next_line(FmReader* r, const char** begin, const char** end) {
  for (;;) {
    if (r->pos < r->len) {
      const char* base = r->buf.data();
      const char* nl = find_eol(base + r->pos, r->len - r->pos);
      if (nl) {
        size_t line_end = static_cast<size_t>(nl - base);
        if (!r->tail.empty()) {
          r->tail.append(base + r->pos, line_end - r->pos);
          *begin = r->tail.data();
          *end = r->tail.data() + r->tail.size();
          r->pos = line_end + 1;
          r->tail_valid = true;  // consumer must clear via consume_tail
          return true;
        }
        *begin = base + r->pos;
        *end = nl;
        r->pos = line_end + 1;
        return true;
      }
      // No newline in the window: stash the fragment and refill.
      r->tail.append(base + r->pos, r->len - r->pos);
      r->pos = r->len;
    }
    if (r->eof) {
      if (!r->tail.empty()) {
        *begin = r->tail.data();
        *end = r->tail.data() + r->tail.size();
        r->tail_valid = true;
        r->eof = true;
        // Mark consumed so the next call returns false.
        r->pos = r->len = 0;
        return true;
      }
      return false;
    }
    size_t got = fread(r->buf.data(), 1, r->buf.size(), r->f);
    r->pos = 0;
    r->len = got;
    if (got < r->buf.size() && ferror(r->f)) {
      // A transient I/O failure must NOT look like clean EOF — silently
      // truncating an epoch is the worst possible failure mode.
      r->read_error = true;
      r->eof = true;
      r->len = 0;  // drop the partial window; the caller aborts anyway
      return false;
    }
    if (got == 0) r->eof = true;
  }
}

inline bool is_blank(const char* b, const char* e) {
  while (b < e && is_space(*b)) ++b;
  return b >= e;
}

}  // namespace

extern "C" {

// Open a libsvm file for streamed batch reading.  shard_index/shard_count
// implement block-cyclic line sharding by GLOBAL non-blank line index:
// line i belongs to shard (i / shard_block) %% shard_count.  shard_block=1
// is classic round-robin; shard_block=local_batch gives each process the
// contiguous rows of its own slice of every global batch (the multi-host
// input split, where batch sharding is contiguous by process).  counter_start carries the index across files (data/pipeline.py
// threads it through a multi-file, multi-epoch schedule).  NULL on failure.
void* fm_reader_open2(const char* path, int64_t shard_index,
                      int64_t shard_count, int64_t shard_block,
                      int64_t counter_start) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  FmReader* r = new FmReader();
  r->f = f;
  r->buf.resize(1 << 22);  // 4 MiB read window
  r->shard_index = shard_index;
  r->shard_count = shard_count < 1 ? 1 : shard_count;
  r->shard_block = shard_block < 1 ? 1 : shard_block;
  r->counter = counter_start;
  return r;
}

// Round-robin entry kept for ABI compatibility with older bindings.
void* fm_reader_open(const char* path, int64_t shard_index,
                     int64_t shard_count, int64_t counter_start) {
  return fm_reader_open2(path, shard_index, shard_count, 1, counter_start);
}

// Stream a file once and report BOTH the non-blank line count and the
// widest row's nnz (token count minus the label).  Multi-host input
// sharding needs the global line count up front (same number of collective
// steps on every process) and the static-shape batch width needs the
// widest row — one C++ pass serves both instead of two Python passes.
// Returns 0, or -1 on open/read failure.
int32_t fm_scan_file(const char* path, int64_t* n_lines, int64_t* widest) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  FmReader r;
  r.f = f;
  r.buf.resize(1 << 22);
  int64_t n = 0, wide = 0;
  const char *b, *e;
  while (next_line(&r, &b, &e)) {
    const int64_t toks = count_tokens(b, e);
    if (toks > 0) {
      ++n;
      if (toks - 1 > wide) wide = toks - 1;
    }
    if (r.tail_valid) {
      r.tail.clear();
      r.tail_valid = false;
    }
  }
  fclose(f);
  r.f = nullptr;
  if (r.read_error) return -1;
  *n_lines = n;
  *widest = wide;
  return 0;
}

// Count non-blank lines of a file, streaming.  The narrow entry for
// count-only callers: checks only each line's leading whitespace
// (is_blank) instead of tokenizing every byte the way fm_scan_file must.
// Returns -1 on open or read failure.
int64_t fm_count_lines(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  FmReader r;
  r.f = f;
  r.buf.resize(1 << 22);
  int64_t n = 0;
  const char *b, *e;
  while (next_line(&r, &b, &e)) {
    if (!is_blank(b, e)) ++n;
    if (r.tail_valid) {
      r.tail.clear();
      r.tail_valid = false;
    }
  }
  fclose(f);
  r.f = nullptr;
  if (r.read_error) return -1;
  return n;
}

// Global non-blank line counter after the lines consumed so far.
int64_t fm_reader_counter(void* reader) {
  return static_cast<FmReader*>(reader)->counter;
}

void fm_reader_close(void* reader) {
  FmReader* r = static_cast<FmReader*>(reader);
  if (r->f) fclose(r->f);
  delete r;
}

}  // extern "C"

namespace {

// Shared body of fm_reader_next / fm_reader_next32 (IdT = id output dtype).
template <typename IdT>
int64_t reader_next_impl(void* reader, int64_t want, int64_t width,
                         int64_t vocabulary_size, int32_t hash_feature_id,
                         int32_t threads, float* labels, IdT* ids, float* vals,
                         int32_t* fields, int32_t* nnz, int32_t* error_code,
                         int64_t* error_line) {
  FmReader* r = static_cast<FmReader*>(reader);
  r->arena.clear();
  r->offsets.clear();

  const char *b, *e;
  while (static_cast<int64_t>(r->offsets.size()) < want && next_line(r, &b, &e)) {
    bool selected = false;
    if (!is_blank(b, e)) {
      selected =
          ((r->counter / r->shard_block) % r->shard_count) == r->shard_index;
      ++r->counter;
    }
    if (selected) {
      r->offsets.emplace_back(r->arena.size(), static_cast<size_t>(e - b));
      r->arena.append(b, static_cast<size_t>(e - b));
    }
    if (r->tail_valid) {
      r->tail.clear();
      r->tail_valid = false;
    }
  }

  if (r->read_error) {
    *error_code = kReadError;
    *error_line = -1;
    return -1;
  }

  const int64_t rows = static_cast<int64_t>(r->offsets.size());
  if (rows == 0) return 0;
  memset(ids, 0, sizeof(IdT) * rows * width);
  memset(vals, 0, sizeof(float) * rows * width);
  memset(fields, 0, sizeof(int32_t) * rows * width);
  memset(nnz, 0, sizeof(int32_t) * rows);

  std::vector<LineSpan> spans;
  spans.reserve(static_cast<size_t>(rows));
  for (const auto& [off, len] : r->offsets) {
    spans.push_back({r->arena.data() + off, r->arena.data() + off + len});
  }

  int64_t err = -1;
  int32_t code = parse_spans_mt(spans, width, vocabulary_size, hash_feature_id,
                                threads, labels, ids, vals, fields, nnz, &err);
  if (code != kOk) {
    *error_code = code;
    *error_line = err;
    return -1;
  }
  return rows;
}

}  // namespace

extern "C" {

// Fill up to `want` rows of the caller's batch buffers (each sized for at
// least `want` rows).  Returns the number of rows produced; fewer than
// `want` means the file is exhausted.  On a parse error returns -1 and sets
// *error_code (ErrorCode) and *error_line (this-shard row index within the
// current call).
int64_t fm_reader_next(void* reader, int64_t want, int64_t width,
                       int64_t vocabulary_size, int32_t hash_feature_id,
                       int32_t threads, float* labels, int64_t* ids,
                       float* vals, int32_t* fields, int32_t* nnz,
                       int32_t* error_code, int64_t* error_line) {
  return reader_next_impl(reader, want, width, vocabulary_size,
                          hash_feature_id, threads, labels, ids, vals, fields,
                          nnz, error_code, error_line);
}

// Same, writing int32 feature ids — the dtype the device batch wants (device
// gathers index with int32), halving the largest host->device transfer.
// Caller must ensure vocabulary_size <= INT32_MAX.
int64_t fm_reader_next32(void* reader, int64_t want, int64_t width,
                         int64_t vocabulary_size, int32_t hash_feature_id,
                         int32_t threads, float* labels, int32_t* ids,
                         float* vals, int32_t* fields, int32_t* nnz,
                         int32_t* error_code, int64_t* error_line) {
  return reader_next_impl(reader, want, width, vocabulary_size,
                          hash_feature_id, threads, labels, ids, vals, fields,
                          nnz, error_code, error_line);
}

// Parse-time constant detection for the packed wire format (wire v2
// elision flags): 1 iff every row of `vals` is exactly the all-ones
// pattern its nnz implies — 1.0f in the first nnz[i] slots, 0.0f in the
// padding.  Bit-exact comparisons on purpose: elision reconstructs with
// literal 1.0f/0.0f on device, so anything else must keep explicit vals.
int32_t fm_vals_all_ones(const float* vals, const int32_t* nnz, int64_t n,
                         int64_t width) {
  for (int64_t i = 0; i < n; ++i) {
    const float* row = vals + i * width;
    const int64_t m = nnz[i];
    if (m < 0 || m > width) return 0;  // corrupt nnz: not the pattern, never OOB
    for (int64_t j = 0; j < m; ++j) {
      if (row[j] != 1.0f) return 0;
    }
    for (int64_t j = m; j < width; ++j) {
      if (row[j] != 0.0f) return 0;
    }
  }
  return 1;
}

}  // extern "C"
