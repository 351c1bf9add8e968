// cs_native — native host-path kernels for codesearch_tpu.
//
// The reference offloads its host hot paths to native code (tree-sitter C
// parsers, tantivy, ort); this library is the equivalent tier here: the
// byte-level loops that dominate single-core host time during indexing.
//
//   cs_mask       — lexical masking (strings/comments → spaces) for the
//                   structural scanner (mirrors chunker/lexer.py exactly)
//   cs_featurize  — code tokenization + FNV-1a feature hashing + tf
//                   weighting for the hash embedder
//                   (mirrors models/tokenizer.py + hash_embedder.py)
//   cs_token_hashes — raw token-hash stream for FTS term counting
//
// Byte-for-byte parity with the Python implementations is enforced by
// tests/test_native.py. C ABI only (loaded via ctypes; no pybind11).
//
// Build: g++ -O3 -shared -fPIC -o cs_native.so cs_native.cpp

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <unordered_map>

namespace {

// ---------------------------------------------------------------------------
// lexical masking
// ---------------------------------------------------------------------------

void blank(char* out, long a, long b, long n) {
  if (b > n) b = n;
  for (long k = a; k < b; ++k)
    if (out[k] != '\n') out[k] = ' ';
}

void mask_c_family(const char* src, long n, char* out, bool nested_block,
                   bool raw_rust, bool backtick, bool template_lit,
                   bool lifetimes) {
  std::memcpy(out, src, (size_t)n);
  long i = 0;
  while (i < n) {
    char c = src[i];
    char nxt = (i + 1 < n) ? src[i + 1] : '\0';
    if (c == '/' && nxt == '/') {
      long j = i;
      while (j < n && src[j] != '\n') ++j;
      blank(out, i, j, n);
      i = j;
    } else if (c == '/' && nxt == '*') {
      int depth = 1;
      long j = i + 2;
      while (j < n && depth > 0) {
        if (nested_block && j + 1 < n && src[j] == '/' && src[j + 1] == '*') {
          depth += 1; j += 2;
        } else if (j + 1 < n && src[j] == '*' && src[j + 1] == '/') {
          depth -= 1; j += 2;
        } else {
          ++j;
        }
      }
      blank(out, i, j, n);
      i = j;
    } else if (raw_rust && c == 'r' && (nxt == '"' || nxt == '#')) {
      long j = i + 1;
      int hashes = 0;
      while (j < n && src[j] == '#') { ++hashes; ++j; }
      if (j < n && src[j] == '"') {
        long close = -1;
        for (long k = j + 1; k < n; ++k) {
          if (src[k] != '"') continue;
          bool ok = true;
          for (int h = 0; h < hashes; ++h)
            if (k + 1 + h >= n || src[k + 1 + h] != '#') { ok = false; break; }
          if (ok) { close = k + 1 + hashes; break; }
        }
        if (close < 0) close = n;
        blank(out, i + 1, close, n);  // keep the 'r'
        i = close;
      } else {
        ++i;
      }
    } else if (c == '"') {
      long j = i + 1;
      while (j < n) {
        if (src[j] == '\\') { j += 2; }
        else if (src[j] == '"' || src[j] == '\n') { ++j; break; }
        else { ++j; }
      }
      blank(out, i + 1, j - 1, n);
      i = j;
    } else if (backtick && c == '`') {
      long j = i + 1;
      while (j < n && src[j] != '`') ++j;
      long end = (j < n) ? j + 1 : n;
      blank(out, i + 1, end - 1, n);
      i = end;
    } else if (template_lit && c == '`') {
      long j = i + 1;
      while (j < n) {
        if (src[j] == '\\') { j += 2; }
        else if (src[j] == '`') { ++j; break; }
        else { ++j; }
      }
      blank(out, i + 1, j - 1, n);
      i = j;
    } else if (c == '\'') {
      if (lifetimes) {
        if (nxt == '\\') {
          long j = i + 2;
          while (j < n && src[j] != '\'') ++j;
          blank(out, i + 1, j, n);
          i = j + 1;
        } else if (i + 2 < n && src[i + 2] == '\'') {
          blank(out, i + 1, i + 2, n);
          i = i + 3;
        } else {
          ++i;  // lifetime
        }
      } else {
        long j = i + 1;
        while (j < n) {
          if (src[j] == '\\') { j += 2; }
          else if (src[j] == '\'' || src[j] == '\n') { ++j; break; }
          else { ++j; }
        }
        blank(out, i + 1, j - 1, n);
        i = j;
      }
    } else {
      ++i;
    }
  }
}

void mask_python(const char* src, long n, char* out) {
  std::memcpy(out, src, (size_t)n);
  long i = 0;
  while (i < n) {
    char c = src[i];
    if (c == '#') {
      long j = i;
      while (j < n && src[j] != '\n') ++j;
      blank(out, i, j, n);
      i = j;
    } else if (c == '"' || c == '\'') {
      char q = c;
      if (i + 2 < n && src[i + 1] == q && src[i + 2] == q) {
        long close = -1;
        for (long k = i + 3; k + 2 < n; ++k) {
          if (src[k] == q && src[k + 1] == q && src[k + 2] == q) {
            close = k + 3;
            break;
          }
        }
        if (close < 0) close = n;
        blank(out, i + 3, close - 3, n);
        i = close;
      } else {
        long j = i + 1;
        while (j < n) {
          if (src[j] == '\\') { j += 2; }
          else if (src[j] == q || src[j] == '\n') { ++j; break; }
          else { ++j; }
        }
        blank(out, i + 1, j - 1, n);
        i = j;
      }
    } else {
      ++i;
    }
  }
}

// ---------------------------------------------------------------------------
// tokenization
// ---------------------------------------------------------------------------

inline bool is_word_byte(unsigned char b) {
  return (b >= 'A' && b <= 'Z') || (b >= 'a' && b <= 'z') ||
         (b >= '0' && b <= '9') || b == '_' || b >= 0x80;
}
inline bool is_seg_byte(unsigned char b) {  // word byte minus '_'
  return (b >= 'A' && b <= 'Z') || (b >= 'a' && b <= 'z') ||
         (b >= '0' && b <= '9') || b >= 0x80;
}
inline bool is_lower_digit(unsigned char b) {
  return (b >= 'a' && b <= 'z') || (b >= '0' && b <= '9');
}
inline bool is_upper(unsigned char b) { return b >= 'A' && b <= 'Z'; }
inline bool is_lower(unsigned char b) { return b >= 'a' && b <= 'z'; }
inline unsigned char ascii_lower(unsigned char b) {
  return (b >= 'A' && b <= 'Z') ? (unsigned char)(b + 32) : b;
}

const uint64_t FNV_OFFSET = 0xCBF29CE484222325ULL;
const uint64_t FNV_PRIME = 0x100000001B3ULL;

struct Span {  // one emitted token, as a byte range (hashed lowercased)
  long start;
  long len;
  bool whole_flag;  // '_' in token or len > 12
};

// UTF-8 code-point count of a byte range (skips 0b10xxxxxx continuation
// bytes) — the whole-identifier flag must match Python's len(token) over
// the decoded string, not the byte length (parity bug: 'функция' is 14
// bytes but 7 chars).
inline long utf8_chars(const unsigned char* src, long start, long len) {
  long c = 0;
  for (long i = start; i < start + len; ++i)
    if ((src[i] & 0xC0) != 0x80) ++c;
  return c;
}

inline uint64_t hash_span(const unsigned char* src, const Span& s) {
  uint64_t h = FNV_OFFSET;
  for (long i = 0; i < s.len; ++i)
    h = (h ^ ascii_lower(src[s.start + i])) * FNV_PRIME;
  return h;
}

inline uint64_t hash_bigram(const unsigned char* src, const Span& a, const Span& b) {
  uint64_t h = FNV_OFFSET;
  for (long i = 0; i < a.len; ++i)
    h = (h ^ ascii_lower(src[a.start + i])) * FNV_PRIME;
  h = (h ^ 0x1Fu) * FNV_PRIME;
  for (long i = 0; i < b.len; ++i)
    h = (h ^ ascii_lower(src[b.start + i])) * FNV_PRIME;
  return h;
}

// Token spans for a text, mirroring tokenizer.code_tokens: per word run,
// camel/underscore subword spans; if >1 subword, also the whole run.
void token_spans(const unsigned char* src, long n, std::vector<Span>& out) {
  long i = 0;
  while (i < n) {
    while (i < n && !is_word_byte(src[i])) ++i;
    if (i >= n) break;
    long start = i;
    bool has_underscore = false;
    while (i < n && is_word_byte(src[i])) {
      if (src[i] == '_') has_underscore = true;
      ++i;
    }
    long end = i;
    size_t before = out.size();
    // segments (split on '_' etc.), then camel boundaries
    long p = start;
    while (p < end) {
      while (p < end && !is_seg_byte(src[p])) ++p;
      if (p >= end) break;
      long seg_start = p;
      while (p < end && is_seg_byte(src[p])) ++p;
      long seg_end = p;
      long s = seg_start;
      for (long k = seg_start + 1; k < seg_end; ++k) {
        bool boundary =
            (is_lower_digit(src[k - 1]) && is_upper(src[k])) ||
            (is_upper(src[k - 1]) && is_upper(src[k]) && k + 1 < seg_end &&
             is_lower(src[k + 1]));
        if (boundary) {
          out.push_back({s, k - s, utf8_chars(src, s, k - s) > 12});
          s = k;
        }
      }
      out.push_back({s, seg_end - s, utf8_chars(src, s, seg_end - s) > 12});
    }
    size_t subs = out.size() - before;
    if (subs > 1) {
      // whole-identifier token keeps underscores → whole flag via '_' or len
      out.push_back({start, end - start,
                     has_underscore || utf8_chars(src, start, end - start) > 12});
    }
    // single-subword tokens: python emits just the subword string (no
    // underscores survive), so its whole flag is already correct
    (void)before;
  }
}

}  // namespace

extern "C" {

// family: 0=c 1=rust 2=go 3=ts 4=python. out: buffer of >= n bytes.
int32_t cs_mask(int32_t family, const char* src, long n, char* out) {
  switch (family) {
    case 4: mask_python(src, n, out); return 0;
    case 1: mask_c_family(src, n, out, true, true, false, false, true); return 0;
    case 2: mask_c_family(src, n, out, false, false, true, false, false); return 0;
    case 3: mask_c_family(src, n, out, false, false, false, true, false); return 0;
    case 0: mask_c_family(src, n, out, false, false, false, false, false); return 0;
    default: return -1;
  }
}

// Featurize text → (bucket ids, double weights) in first-occurrence order
// (unigrams then bigrams). Returns feature count, or -1 if max_out too small.
// Weights are computed in double and cast to float by the caller for exact
// parity with the Python reference.
long cs_featurize(const char* text, long n, int64_t buckets,
                  int64_t* ids_out, double* w_out, long max_out) {
  const unsigned char* src = (const unsigned char*)text;
  std::vector<Span> toks;
  toks.reserve(256);
  token_spans(src, n, toks);

  std::unordered_map<uint64_t, long> idx;
  std::vector<uint64_t> ids;
  std::vector<long> tf;
  std::vector<uint8_t> whole;
  idx.reserve(toks.size() * 2);
  for (const Span& t : toks) {
    uint64_t b = hash_span(src, t) % (uint64_t)buckets;
    auto it = idx.find(b);
    if (it == idx.end()) {
      idx.emplace(b, (long)ids.size());
      ids.push_back(b);
      tf.push_back(1);
      whole.push_back(t.whole_flag ? 1 : 0);
    } else {
      tf[it->second] += 1;
      if (t.whole_flag) whole[it->second] = 1;
    }
  }
  std::unordered_map<uint64_t, long> bidx;
  std::vector<uint64_t> bids;
  std::vector<long> btf;
  for (size_t k = 0; k + 1 < toks.size(); ++k) {
    uint64_t b = hash_bigram(src, toks[k], toks[k + 1]) % (uint64_t)buckets;
    auto it = bidx.find(b);
    if (it == bidx.end()) {
      bidx.emplace(b, (long)bids.size());
      bids.push_back(b);
      btf.push_back(1);
    } else {
      btf[it->second] += 1;
    }
  }

  long total = (long)(ids.size() + bids.size());
  if (total > max_out) return -1;
  long o = 0;
  for (size_t k = 0; k < ids.size(); ++k, ++o) {
    double w = 1.0 + std::log((double)tf[k]);
    if (whole[k]) w *= 1.5;
    ids_out[o] = (int64_t)ids[k];
    w_out[o] = w;
  }
  for (size_t k = 0; k < bids.size(); ++k, ++o) {
    ids_out[o] = (int64_t)bids[k];
    w_out[o] = 0.7 * (1.0 + std::log((double)btf[k]));
  }
  return o;
}

// Batch featurize: one call for a whole slab of texts (concatenated buffer
// + offsets[n_texts+1]), amortizing the per-call ctypes marshaling that
// dominates per-text invocation at indexing rates. Per-text results are
// byte-identical to cs_featurize; counts_out[t] holds text t's feature
// count and results pack contiguously into ids_out/w_out. Returns the
// total count, or -1 if max_out is too small.
long cs_featurize_batch(const char* buf, const long* offsets, long n_texts,
                        int64_t buckets, int64_t* ids_out, double* w_out,
                        long max_out, long* counts_out) {
  long pos = 0;
  for (long t = 0; t < n_texts; ++t) {
    long m = cs_featurize(buf + offsets[t], offsets[t + 1] - offsets[t],
                          buckets, ids_out + pos, w_out + pos, max_out - pos);
    if (m < 0) return -1;
    counts_out[t] = m;
    pos += m;
  }
  return pos;
}

// Raw token bucket-id stream (order preserved, duplicates included) for FTS
// term-frequency counting. Returns count, or -1 if max_out too small.
long cs_token_hashes(const char* text, long n, int64_t buckets,
                     int64_t* ids_out, long max_out) {
  const unsigned char* src = (const unsigned char*)text;
  std::vector<Span> toks;
  token_spans(src, n, toks);
  if ((long)toks.size() > max_out) return -1;
  long o = 0;
  for (const Span& t : toks) {
    uint64_t h = hash_span(src, t);
    ids_out[o++] = (int64_t)(buckets > 0 ? h % (uint64_t)buckets : h);
  }
  return o;
}

// Batch token hashes: one call for a slab of texts (concatenated buffer +
// offsets[n_texts+1]) — the FTS ingest analog of cs_featurize_batch.
// Per-text results are byte-identical to cs_token_hashes; counts_out[t]
// holds text t's token count and results pack contiguously into ids_out.
// Returns the total count, or -1 if max_out is too small.
long cs_token_hashes_batch(const char* buf, const long* offsets, long n_texts,
                           int64_t buckets, int64_t* ids_out, long max_out,
                           long* counts_out) {
  long pos = 0;
  for (long t = 0; t < n_texts; ++t) {
    long m = cs_token_hashes(buf + offsets[t], offsets[t + 1] - offsets[t],
                             buckets, ids_out + pos, max_out - pos);
    if (m < 0) return -1;
    counts_out[t] = m;
    pos += m;
  }
  return pos;
}

// Run-level posting scatter for the FTS segment merge (fts/store.py
// _merge_segments): one source part's term runs are copied to their
// destinations in the merged posting arrays. For source term i (n_terms
// total), counts[i] postings starting at the running source offset go to
// out[cursor[pos[i]]]; cursor advances so a later part's run for the same
// term lands right after. dnums copy with elem_size bytes per element
// (4 = int32, 8 = int64; the Python wrapper pre-converts when the source
// dtype differs from the output's). tf arrays are int16. Plain sequential
// memcpy per run — replaces numpy's arange/repeat/fancy-index scatter
// (three full-size index temporaries per part). Returns postings copied,
// or -1 on a bad elem_size.
long cs_scatter_runs(const int64_t* pos, const int64_t* counts, long n_terms,
                     int64_t* cursor, int elem_size,
                     const char* src_d, const int16_t* src_c,
                     const int16_t* src_s, char* out_d, int16_t* out_c,
                     int16_t* out_s) {
  if (elem_size != 4 && elem_size != 8) return -1;
  long src_off = 0;
  for (long i = 0; i < n_terms; ++i) {
    const long c = (long)counts[i];
    const long dst = (long)cursor[pos[i]];
    memcpy(out_d + (size_t)dst * elem_size, src_d + (size_t)src_off * elem_size,
           (size_t)c * elem_size);
    memcpy(out_c + dst, src_c + src_off, (size_t)c * sizeof(int16_t));
    memcpy(out_s + dst, src_s + src_off, (size_t)c * sizeof(int16_t));
    cursor[pos[i]] += c;
    src_off += c;
  }
  return src_off;
}

}  // extern "C"
