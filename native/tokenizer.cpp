// Native batch tokenizer: the host-side data-loader hot path.
//
// Ingest at scale is bounded by host tokenization (the pure-Python
// per-character loop measures ~1.4 Mchar/s; the device embedder consumes far
// faster). This implements models/tokenizer.py:HashCharTokenizer.encode
// byte-for-byte: slice the first (max_len-1) CODEPOINTS, skip
// Python-`str.isspace()` characters, splitmix-scramble each codepoint into
// [2, vocab). Exactness matters: the embedder fingerprint (and therefore
// every persisted index) depends on tokenization being identical across
// the Python and native paths — asserted in tests/test_native.py.
//
// C ABI + ctypes, no pybind (not in the image).

#include <cstdint>
#include <cstring>

namespace {

inline bool py_isspace(uint32_t cp) {
  // mirror CPython str.isspace(): ASCII controls 0x09-0x0D, 0x1C-0x1F,
  // 0x20, 0x85, 0xA0, and the Unicode Zs/Zl/Zp space characters
  switch (cp) {
    case 0x09: case 0x0A: case 0x0B: case 0x0C: case 0x0D:
    case 0x1C: case 0x1D: case 0x1E: case 0x1F:
    case 0x20: case 0x85: case 0xA0:
    case 0x1680:
    case 0x2028: case 0x2029: case 0x202F: case 0x205F:
    case 0x3000:
      return true;
    default:
      return (cp >= 0x2000 && cp <= 0x200A);
  }
}

inline uint32_t char_id(uint32_t cp, uint32_t vocab) {
  uint32_t x = cp;
  x *= 0x9E3779B1u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  return 2u + (x % (vocab - 2u));
}

// decode one UTF-8 codepoint; input is valid UTF-8 (produced by Python)
inline const uint8_t* next_cp(const uint8_t* p, const uint8_t* end,
                              uint32_t* cp) {
  uint8_t b = *p;
  if (b < 0x80) { *cp = b; return p + 1; }
  if ((b >> 5) == 0x6 && p + 1 < end) {
    *cp = ((b & 0x1F) << 6) | (p[1] & 0x3F);
    return p + 2;
  }
  if ((b >> 4) == 0xE && p + 2 < end) {
    *cp = ((b & 0x0F) << 12) | ((p[1] & 0x3F) << 6) | (p[2] & 0x3F);
    return p + 3;
  }
  if ((b >> 3) == 0x1E && p + 3 < end) {
    *cp = ((b & 0x07) << 18) | ((p[1] & 0x3F) << 12) | ((p[2] & 0x3F) << 6) |
          (p[3] & 0x3F);
    return p + 4;
  }
  *cp = 0xFFFD;   // unreachable for valid input
  return p + 1;
}

}  // namespace

extern "C" {

// buf: concatenated UTF-8 texts; offsets: [n+1] byte offsets into buf.
// For each text: ids = [CLS=1] + hashed non-space chars of the first
// (slice_len) codepoints, truncated to cap_len tokens. out_ids is [n,
// cap_len] pre-zeroed or not (fully written: PAD=0 tail). out_lens: [n].
void tok_batch(const uint8_t* buf, const int64_t* offsets, int32_t n,
               int32_t vocab, int32_t slice_len, int32_t cap_len,
               int32_t* out_ids, int32_t* out_lens) {
  for (int32_t r = 0; r < n; ++r) {
    const uint8_t* p = buf + offsets[r];
    const uint8_t* end = buf + offsets[r + 1];
    int32_t* row = out_ids + static_cast<int64_t>(r) * cap_len;
    int32_t len = 0;
    if (cap_len > 0) row[len++] = 1;  // CLS
    int32_t seen = 0;                 // codepoints consumed from the slice
    uint32_t cp;
    while (p < end && seen < slice_len && len < cap_len) {
      p = next_cp(p, end, &cp);
      ++seen;
      if (py_isspace(cp)) continue;
      row[len++] = static_cast<int32_t>(char_id(cp, vocab));
    }
    for (int32_t j = len; j < cap_len; ++j) row[j] = 0;  // PAD
    out_lens[r] = len;
  }
}

}  // extern "C"
