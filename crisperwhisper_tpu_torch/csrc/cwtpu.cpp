// Native runtime helpers for crisperwhisper_tpu.
//
// Replaces the Rust `tokenizers` backend of the reference's fast tokenizer
// (SURVEY.md §2.7) with a C++ codec, plus a first-party RIFF/WAV decoder
// for the no-ffmpeg ingestion path. Exposed through a plain C ABI consumed
// via ctypes (no pybind11 in this environment).
//
// Vocabulary format ("cwvb1"): Python pre-resolves the byte-level BPE
// unicode indirection and writes id -> raw bytes:
//   magic "CWVB" | u32 n | u32 offsets[n+1] | u8 data[]
// Decode is then pure concatenation — the hot direction for ASR output.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <utility>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// BPE vocab
// ---------------------------------------------------------------------------

struct CwVocab {
  std::vector<uint32_t> offsets;
  std::vector<uint8_t> data;
  uint32_t n = 0;
};

void* cw_vocab_load(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  char magic[4];
  if (std::fread(magic, 1, 4, f) != 4 || std::memcmp(magic, "CWVB", 4)) {
    std::fclose(f);
    return nullptr;
  }
  auto* v = new CwVocab();
  uint32_t n = 0;
  if (std::fread(&n, 4, 1, f) != 1) { delete v; std::fclose(f); return nullptr; }
  v->n = n;
  v->offsets.resize(n + 1);
  if (std::fread(v->offsets.data(), 4, n + 1, f) != n + 1) {
    delete v; std::fclose(f); return nullptr;
  }
  uint32_t total = v->offsets[n];
  v->data.resize(total);
  if (total && std::fread(v->data.data(), 1, total, f) != total) {
    delete v; std::fclose(f); return nullptr;
  }
  std::fclose(f);
  return v;
}

void cw_vocab_free(void* vocab) { delete static_cast<CwVocab*>(vocab); }

// Decode `n_ids` token ids into `out` (caller-allocated, cap bytes).
// Ids outside the vocab are skipped (specials/timestamps are handled in
// Python). Returns bytes written, or -1 if `cap` is too small.
int64_t cw_decode(void* vocab, const int32_t* ids, int64_t n_ids,
                  uint8_t* out, int64_t cap) {
  auto* v = static_cast<CwVocab*>(vocab);
  int64_t w = 0;
  for (int64_t i = 0; i < n_ids; ++i) {
    int32_t id = ids[i];
    if (id < 0 || static_cast<uint32_t>(id) >= v->n) continue;
    uint32_t a = v->offsets[id], b = v->offsets[id + 1];
    int64_t len = b - a;
    if (w + len > cap) return -1;
    std::memcpy(out + w, v->data.data() + a, len);
    w += len;
  }
  return w;
}

// ---------------------------------------------------------------------------
// BPE encode: GPT-2 pre-tokenization + merge loop
// ---------------------------------------------------------------------------
//
// Replaces the Rust `tokenizers` ENCODE direction (the round-3 verdict's
// "fast tokenizer backend: partial" — decode-only). Blob "CWEB1", built by
// Python (native_bindings.NativeBPEEncoder):
//   magic "CWEB" | u32 version(1)
//   u32 n_tokens | u32 tok_offsets[n+1] | u8 tok_data[]   (id -> raw bytes)
//   u32 n_merges | u32 m_offsets[2*n_merges+1] | u8 m_data[]  (l0,r0,l1,r1,…)
//   u32 n_ranges | { u32 first, u32 last, u8 cls }[n_ranges]
// cls classifies codepoints exactly as the Python scanner does
// (crisperwhisper_tpu/tokenizer/bpe.py::gpt2_pre_tokenize): 0 other,
// 1 letter (\p{L}), 2 number (\p{N}), 3 whitespace (str.isspace).
// The table is EXPORTED from Python's unicodedata at blob-build time, so
// classification parity with the pure-Python oracle holds by construction.
//
// Merges operate on raw byte strings (the GPT-2 byte<->unicode map is a
// bijection, so merging mapped-unicode strings and merging raw bytes are
// isomorphic — Python pre-resolves the indirection, as it does for decode).
// Every symbol is interned to an id: vocab tokens keep their vocab id;
// merge RESULTS absent from the vocab get synthetic ids >= n_tokens, and a
// word that finishes holding one makes the call fail (-2) so the caller
// falls back to the Python path (which raises the same way HF's slow
// tokenizer would on an out-of-vocab symbol).

}  // extern "C" (reopened below — the encoder internals are C++)

namespace {

struct CwRange { uint32_t first, last; uint8_t cls; };

struct CwEncoder {
  // interned symbol table: id -> bytes (vocab ids first, synthetics after)
  std::vector<std::string> symbols;
  std::unordered_map<std::string, int32_t> sym_id;
  uint32_t n_vocab = 0;
  // (left_id << 32 | right_id) -> {rank, result_id}
  std::unordered_map<uint64_t, std::pair<uint32_t, int32_t>> ranks;
  std::vector<CwRange> cls_ranges;   // sorted by first
  int32_t byte_id[256];              // id of each single-byte symbol, -1 if absent

  int32_t intern(const std::string& s) {
    auto it = sym_id.find(s);
    if (it != sym_id.end()) return it->second;
    int32_t id = static_cast<int32_t>(symbols.size());
    symbols.push_back(s);
    sym_id.emplace(s, id);
    return id;
  }

  uint8_t classify(uint32_t cp) const {
    // binary search over sorted, non-overlapping ranges
    size_t lo = 0, hi = cls_ranges.size();
    while (lo < hi) {
      size_t mid = (lo + hi) / 2;
      const CwRange& r = cls_ranges[mid];
      if (cp < r.first) hi = mid;
      else if (cp > r.last) lo = mid + 1;
      else return r.cls;
    }
    return 0;
  }
};

bool read_u32(FILE* f, uint32_t* v) { return std::fread(v, 4, 1, f) == 1; }

// Decode one UTF-8 codepoint starting at p (guaranteed valid: the input
// comes from a Python str). Returns byte length consumed.
inline int utf8_next(const uint8_t* s, int64_t len, int64_t p, uint32_t* cp) {
  uint8_t c = s[p];
  if (c < 0x80) { *cp = c; return 1; }
  if ((c >> 5) == 0x6 && p + 1 < len) {
    *cp = ((c & 0x1F) << 6) | (s[p + 1] & 0x3F);
    return 2;
  }
  if ((c >> 4) == 0xE && p + 2 < len) {
    *cp = ((c & 0x0F) << 12) | ((s[p + 1] & 0x3F) << 6) | (s[p + 2] & 0x3F);
    return 3;
  }
  if ((c >> 3) == 0x1E && p + 3 < len) {
    *cp = ((c & 0x07) << 18) | ((s[p + 1] & 0x3F) << 12)
        | ((s[p + 2] & 0x3F) << 6) | (s[p + 3] & 0x3F);
    return 4;
  }
  *cp = 0xFFFD;   // truncated sequence: treat as replacement, consume 1
  return 1;
}

}  // namespace

extern "C" {

void* cw_encoder_load(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  char magic[4];
  uint32_t version = 0;
  if (std::fread(magic, 1, 4, f) != 4 || std::memcmp(magic, "CWEB", 4) ||
      !read_u32(f, &version) || version != 1) {
    std::fclose(f);
    return nullptr;
  }
  auto* e = new CwEncoder();
  auto fail = [&]() { delete e; std::fclose(f); return nullptr; };

  // Offset tables come from an on-disk blob; validate counts and
  // monotonicity before substr() — a malformed/corrupt cache must return
  // nullptr (Python falls back to the pure path), never throw
  // std::out_of_range across the extern-C boundary (ADVICE r4 item 4).
  constexpr uint32_t kMaxEntries = 1u << 24;   // 16M >> any BPE vocab
  auto monotonic = [](const std::vector<uint32_t>& off) {
    for (size_t i = 1; i < off.size(); ++i)
      if (off[i] < off[i - 1]) return false;
    return true;
  };
  uint32_t n_tok = 0;
  if (!read_u32(f, &n_tok) || n_tok > kMaxEntries) return fail();
  std::vector<uint32_t> toff(n_tok + 1);
  if (std::fread(toff.data(), 4, n_tok + 1, f) != n_tok + 1) return fail();
  if (!monotonic(toff)) return fail();
  std::string tdata(toff[n_tok], '\0');
  if (toff[n_tok] &&
      std::fread(&tdata[0], 1, toff[n_tok], f) != toff[n_tok]) return fail();
  e->symbols.reserve(n_tok);
  for (uint32_t i = 0; i < n_tok; ++i) {
    std::string s = tdata.substr(toff[i], toff[i + 1] - toff[i]);
    e->symbols.push_back(s);
    // vocab.json is a dict keyed by token string, so byte strings are
    // unique across ids; emplace is first-writer-wins just in case.
    e->sym_id.emplace(std::move(s), static_cast<int32_t>(i));
  }
  e->n_vocab = n_tok;

  uint32_t n_merges = 0;
  if (!read_u32(f, &n_merges) || n_merges > kMaxEntries) return fail();
  std::vector<uint32_t> moff(2 * static_cast<size_t>(n_merges) + 1);
  if (std::fread(moff.data(), 4, moff.size(), f) != moff.size()) return fail();
  if (!monotonic(moff)) return fail();
  std::string mdata(moff.back(), '\0');
  if (moff.back() &&
      std::fread(&mdata[0], 1, moff.back(), f) != moff.back()) return fail();
  for (uint32_t r = 0; r < n_merges; ++r) {
    std::string left = mdata.substr(moff[2 * r], moff[2 * r + 1] - moff[2 * r]);
    std::string right =
        mdata.substr(moff[2 * r + 1], moff[2 * r + 2] - moff[2 * r + 1]);
    int32_t a = e->intern(left);
    int32_t b = e->intern(right);
    int32_t res = e->intern(left + right);
    uint64_t key = (static_cast<uint64_t>(static_cast<uint32_t>(a)) << 32)
                 | static_cast<uint32_t>(b);
    // overwrite on duplicate pairs: Python's dict(zip(merges, range(n)))
    // keeps the LAST rank for a repeated pair; mirror that.
    e->ranks[key] = {r, res};
  }

  uint32_t n_ranges = 0;
  if (!read_u32(f, &n_ranges) || n_ranges > kMaxEntries) return fail();
  e->cls_ranges.resize(n_ranges);
  for (uint32_t i = 0; i < n_ranges; ++i) {
    CwRange& r = e->cls_ranges[i];
    if (!read_u32(f, &r.first) || !read_u32(f, &r.last) ||
        std::fread(&r.cls, 1, 1, f) != 1) return fail();
  }
  std::fclose(f);

  for (int i = 0; i < 256; ++i) {
    std::string s(1, static_cast<char>(i));
    auto it = e->sym_id.find(s);
    e->byte_id[i] = (it != e->sym_id.end() && it->second >= 0 &&
                     static_cast<uint32_t>(it->second) < e->n_vocab)
                        ? it->second : -1;
  }
  return e;
}

void cw_encoder_free(void* enc) { delete static_cast<CwEncoder*>(enc); }

// Encode UTF-8 `text` into vocab ids. Returns id count, -1 if cap too
// small (cannot happen when cap >= text_len), -2 when a symbol has no
// vocab id (caller must fall back to the Python oracle).
int64_t cw_encode(void* enc, const uint8_t* text, int64_t text_len,
                  int32_t* out, int64_t cap) {
  auto* e = static_cast<CwEncoder*>(enc);
  int64_t w = 0;

  // codepoint stream with byte offsets (cp_off[i] = start of cp i)
  std::vector<uint32_t> cps;
  std::vector<int64_t> cp_off;
  cps.reserve(text_len);
  cp_off.reserve(text_len + 1);
  for (int64_t p = 0; p < text_len;) {
    uint32_t cp;
    cp_off.push_back(p);
    p += utf8_next(text, text_len, p, &cp);
    cps.push_back(cp);
  }
  cp_off.push_back(text_len);
  const int64_t n = static_cast<int64_t>(cps.size());

  std::vector<int32_t> word;   // symbol ids of the current pre-token
  auto emit_token = [&](int64_t a_cp, int64_t b_cp) -> int {
    // BPE over the raw bytes [cp_off[a_cp], cp_off[b_cp])
    const uint8_t* s = text + cp_off[a_cp];
    int64_t nb = cp_off[b_cp] - cp_off[a_cp];
    word.clear();
    for (int64_t i = 0; i < nb; ++i) {
      int32_t id = e->byte_id[s[i]];
      if (id < 0) return -2;
      word.push_back(id);
    }
    // merge loop: repeatedly apply the lowest-rank adjacent pair
    // (tokenizer/bpe.py::ByteLevelBPE.bpe — left-to-right, non-overlapping)
    while (word.size() > 1) {
      uint32_t best_rank = 0xFFFFFFFFu;
      int32_t bf = -1, bs = -1, bres = -1;
      for (size_t i = 0; i + 1 < word.size(); ++i) {
        uint64_t key = (static_cast<uint64_t>(
                            static_cast<uint32_t>(word[i])) << 32)
                     | static_cast<uint32_t>(word[i + 1]);
        auto it = e->ranks.find(key);
        if (it != e->ranks.end() && it->second.first < best_rank) {
          best_rank = it->second.first;
          bf = word[i];
          bs = word[i + 1];
          bres = it->second.second;
        }
      }
      if (bf < 0) break;
      size_t j = 0;
      for (size_t i = 0; i < word.size();) {
        if (word[i] == bf && i + 1 < word.size() && word[i + 1] == bs) {
          word[j++] = bres;
          i += 2;
        } else {
          word[j++] = word[i++];
        }
      }
      word.resize(j);
    }
    for (int32_t id : word) {
      if (static_cast<uint32_t>(id) >= e->n_vocab) return -2;
      if (w >= cap) return -1;
      out[w++] = id;
    }
    return 0;
  };

  // pre-tokenization scanner (bpe.py::gpt2_pre_tokenize semantics)
  static const char* kContractions[7] = {"'s", "'t", "'re", "'ve",
                                         "'m", "'ll", "'d"};
  int64_t i = 0;
  while (i < n) {
    uint32_t c = cps[i];
    if (c == '\'') {
      int64_t mlen = 0;
      for (const char* suf : kContractions) {
        int64_t L = static_cast<int64_t>(std::strlen(suf));
        if (i + L <= n) {
          bool ok = true;
          for (int64_t k = 0; k < L; ++k)
            if (cps[i + k] != static_cast<uint32_t>(suf[k])) { ok = false; break; }
          if (ok) { mlen = L; break; }   // alternation order = array order
        }
      }
      if (mlen) {
        int rc = emit_token(i, i + mlen);
        if (rc) return rc;
        i += mlen;
        continue;
      }
    }
    int64_t j = i + ((c == ' ' && i + 1 < n &&
                      e->classify(cps[i + 1]) != 3) ? 1 : 0);
    if (j < n) {
      uint8_t k0 = e->classify(cps[j]);
      if (k0 == 1 || k0 == 2) {          // " ?letters" / " ?numbers"
        int64_t k = j + 1;
        while (k < n && e->classify(cps[k]) == k0) ++k;
        int rc = emit_token(i, k);
        if (rc) return rc;
        i = k;
        continue;
      }
      if (k0 != 3) {                     // " ?other" (incl. lone ')
        int64_t k = j + 1;
        while (k < n && e->classify(cps[k]) == 0) ++k;
        int rc = emit_token(i, k);
        if (rc) return rc;
        i = k;
        continue;
      }
    }
    // whitespace run (c is whitespace here)
    j = i + 1;
    while (j < n && e->classify(cps[j]) == 3) ++j;
    int64_t end;
    if (j >= n) end = j;                 // run to EOS: take all
    else if (j - i >= 2) { end = j - 1; }  // \s+(?!\S): backtrack one char
    else end = i + 1;                    // single ws char before non-space
    int rc = emit_token(i, end);
    if (rc) return rc;
    i = end;
  }
  return w;
}

// ---------------------------------------------------------------------------
// WAV reader: RIFF PCM16/24/32 + float32/64 -> mono f32
// ---------------------------------------------------------------------------

// Parses `buf` and fills header info. Returns 0 on success.
int cw_wav_info(const uint8_t* buf, int64_t len, int32_t* sample_rate,
                int32_t* channels, int32_t* bits, int32_t* is_float,
                int64_t* data_off, int64_t* data_len) {
  if (len < 44 || std::memcmp(buf, "RIFF", 4) || std::memcmp(buf + 8, "WAVE", 4))
    return -1;
  int64_t p = 12;
  int32_t fmt = 0, ch = 0, sr = 0, bps = 0;
  int64_t doff = -1, dlen = 0;
  while (p + 8 <= len) {
    uint32_t sz;
    std::memcpy(&sz, buf + p + 4, 4);
    if (!std::memcmp(buf + p, "fmt ", 4) && p + 8 + 16 <= len) {
      uint16_t w;
      std::memcpy(&w, buf + p + 8, 2); fmt = w;
      std::memcpy(&w, buf + p + 10, 2); ch = w;
      std::memcpy(&sr, buf + p + 12, 4);
      std::memcpy(&w, buf + p + 22, 2); bps = w;
      // WAVE_FORMAT_EXTENSIBLE: the sub-format lives past the base fmt
      // body; a truncated buffer whose fmt chunk *claims* sz>=40 must not
      // be read past `len`.
      if (fmt == 0xFFFE && sz >= 40 && p + 8 + 26 <= len) {
        uint16_t sub;
        std::memcpy(&sub, buf + p + 8 + 24, 2);
        fmt = sub;
      }
    } else if (!std::memcmp(buf + p, "data", 4)) {
      doff = p + 8;
      dlen = sz;
      if (doff + dlen > len) dlen = len - doff;
      break;
    }
    p += 8 + sz + (sz & 1);
  }
  if (doff < 0 || ch <= 0 || sr <= 0) return -2;
  *sample_rate = sr;
  *channels = ch;
  *bits = bps;
  *is_float = (fmt == 3) ? 1 : 0;
  *data_off = doff;
  *data_len = dlen;
  return 0;
}

// Decode samples to mono f32. Returns frames written or <0 on error.
int64_t cw_wav_decode(const uint8_t* buf, int64_t len, float* out,
                      int64_t max_frames) {
  int32_t sr, ch, bits, isf;
  int64_t off, dlen;
  int rc = cw_wav_info(buf, len, &sr, &ch, &bits, &isf, &off, &dlen);
  if (rc != 0) return rc;
  int64_t bytes_per = (bits / 8) * ch;
  if (bytes_per <= 0) return -3;
  int64_t frames = dlen / bytes_per;
  if (frames > max_frames) frames = max_frames;
  const uint8_t* d = buf + off;
  for (int64_t i = 0; i < frames; ++i) {
    double acc = 0.0;
    for (int32_t c = 0; c < ch; ++c) {
      const uint8_t* s = d + i * bytes_per + c * (bits / 8);
      double val = 0.0;
      if (isf && bits == 32) {
        float fv; std::memcpy(&fv, s, 4); val = fv;
      } else if (isf && bits == 64) {
        double dv; std::memcpy(&dv, s, 8); val = dv;
      } else if (bits == 16) {
        int16_t iv; std::memcpy(&iv, s, 2); val = iv / 32768.0;
      } else if (bits == 32) {
        int32_t iv; std::memcpy(&iv, s, 4); val = iv / 2147483648.0;
      } else if (bits == 24) {
        int32_t iv = (s[0] | (s[1] << 8) | (s[2] << 16));
        if (iv & 0x800000) iv |= ~0xFFFFFF;
        val = iv / 8388608.0;
      } else if (bits == 8) {
        val = (s[0] - 128) / 128.0;
      } else {
        return -4;
      }
      acc += val;
    }
    out[i] = static_cast<float>(acc / ch);
  }
  return frames;
}

}  // extern "C"
