// Unicode analysis for the native ingest path: NFKC normalization,
// full lowercase (incl. the Final_Sigma context rule, matching CPython
// str.lower), and exact UAX#29 word segmentation — the C++ twin of the
// `unicode` analyzer pipeline (searchlite/analysis/uax29.py +
// tokenizers.py: nfkc -> unicode_words -> lowercase). All tables are
// generated from the same UCD (tools/gen_unicode_cpp.py); equivalence
// is fuzzed against the Python implementation in tests/test_native.py.
#pragma once

#include <cstdint>
#include <string>
#include <vector>

#include "slt_unicode_tables.h"

namespace sltu {

// ---- lookups -------------------------------------------------------------

inline long find_key(const uint32_t *keys, size_t n, uint32_t cp) {
  size_t lo = 0, hi = n;
  while (lo < hi) {
    size_t mid = (lo + hi) / 2;
    if (keys[mid] < cp) lo = mid + 1; else hi = mid;
  }
  return (lo < n && keys[lo] == cp) ? (long)lo : -1;
}

inline bool in_intervals(const uint32_t *los, const uint32_t *his,
                         size_t n, uint32_t cp) {
  size_t lo = 0, hi = n;
  while (lo < hi) {  // last los[i] <= cp
    size_t mid = (lo + hi) / 2;
    if (los[mid] <= cp) lo = mid + 1; else hi = mid;
  }
  if (lo == 0) return false;
  return cp <= his[lo - 1];
}

inline int wb_class(uint32_t cp) {
  size_t lo = 0, hi = SLT_WB_LO_len;
  while (lo < hi) {
    size_t mid = (lo + hi) / 2;
    if (SLT_WB_LO[mid] <= cp) lo = mid + 1; else hi = mid;
  }
  if (lo == 0) return SLT_WB_OTHER;
  return cp <= SLT_WB_HI[lo - 1] ? (int)SLT_WB_CLS[lo - 1]
                                 : SLT_WB_OTHER;
}

inline uint8_t ccc(uint32_t cp) {
  long i = find_key(SLT_CCC_KEY, SLT_CCC_KEY_len, cp);
  return i < 0 ? 0 : (uint8_t)SLT_CCC_VAL[i];
}

inline bool is_ext_pict(uint32_t cp) {
  return in_intervals(SLT_EP_LO, SLT_EP_HI, SLT_EP_LO_len, cp);
}
inline bool is_alnum(uint32_t cp) {
  return in_intervals(SLT_AN_LO, SLT_AN_HI, SLT_AN_LO_len, cp);
}
inline bool is_cased(uint32_t cp) {
  return in_intervals(SLT_CASED_LO, SLT_CASED_HI, SLT_CASED_LO_len, cp);
}
inline bool is_case_ignorable(uint32_t cp) {
  return in_intervals(SLT_CI_LO, SLT_CI_HI, SLT_CI_LO_len, cp);
}

// ---- UTF-8 ---------------------------------------------------------------

inline void utf8_decode(const char *s, long n,
                        std::vector<uint32_t> &out) {
  const unsigned char *p = (const unsigned char *)s;
  long i = 0;
  while (i < n) {
    unsigned char b = p[i];
    uint32_t cp;
    int len;
    if (b < 0x80) { cp = b; len = 1; }
    else if ((b & 0xE0) == 0xC0) { cp = b & 0x1F; len = 2; }
    else if ((b & 0xF0) == 0xE0) { cp = b & 0x0F; len = 3; }
    else if ((b & 0xF8) == 0xF0) { cp = b & 0x07; len = 4; }
    else { cp = 0xFFFD; len = 1; }
    for (int j = 1; j < len && i + j < n; j++)
      cp = (cp << 6) | (p[i + j] & 0x3F);
    out.push_back(cp);
    i += len;
  }
}

inline void utf8_encode(uint32_t cp, std::string &out) {
  if (cp < 0x80) out.push_back((char)cp);
  else if (cp < 0x800) {
    out.push_back((char)(0xC0 | (cp >> 6)));
    out.push_back((char)(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out.push_back((char)(0xE0 | (cp >> 12)));
    out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back((char)(0x80 | (cp & 0x3F)));
  } else {
    out.push_back((char)(0xF0 | (cp >> 18)));
    out.push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
    out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back((char)(0x80 | (cp & 0x3F)));
  }
}

// ---- NFKC ----------------------------------------------------------------

static const uint32_t H_SB = 0xAC00, H_LB = 0x1100, H_VB = 0x1161,
                      H_TB = 0x11A7;
static const uint32_t H_LC = 19, H_VC = 21, H_TC = 28,
                      H_NC = H_VC * H_TC, H_SC = H_LC * H_NC;

inline void decompose(uint32_t cp, std::vector<uint32_t> &out) {
  if (cp >= H_SB && cp < H_SB + H_SC) {
    uint32_t si = cp - H_SB;
    out.push_back(H_LB + si / H_NC);
    out.push_back(H_VB + (si % H_NC) / H_TC);
    uint32_t t = si % H_TC;
    if (t) out.push_back(H_TB + t);
    return;
  }
  long i = find_key(SLT_NFKD_KEY, SLT_NFKD_KEY_len, cp);
  if (i < 0) { out.push_back(cp); return; }
  uint32_t v = SLT_NFKD_VAL[i];
  size_t off = v >> 5, len = v & 31;
  for (size_t j = 0; j < len; j++) {
    // table entries are full NFKD except Hangul syllables that appear
    // inside compatibility decompositions are already expanded by the
    // generator (Python NFKD is fully recursive)
    out.push_back(SLT_NFKD_FLAT[off + j]);
  }
}

inline uint32_t compose_pair(uint32_t a, uint32_t b) {
  if (a >= H_LB && a < H_LB + H_LC && b >= H_VB && b < H_VB + H_VC)
    return H_SB + ((a - H_LB) * H_VC + (b - H_VB)) * H_TC;
  if (a >= H_SB && a < H_SB + H_SC && (a - H_SB) % H_TC == 0 &&
      b > H_TB && b < H_TB + H_TC)
    return a + (b - H_TB);
  size_t lo = 0, hi = SLT_COMP_A_len;
  while (lo < hi) {
    size_t mid = (lo + hi) / 2;
    if (SLT_COMP_A[mid] < a ||
        (SLT_COMP_A[mid] == a && SLT_COMP_B[mid] < b))
      lo = mid + 1;
    else
      hi = mid;
  }
  if (lo < SLT_COMP_A_len && SLT_COMP_A[lo] == a && SLT_COMP_B[lo] == b)
    return SLT_COMP_C[lo];
  return 0;
}

inline void nfkc(const std::vector<uint32_t> &in,
                 std::vector<uint32_t> &out) {
  std::vector<uint32_t> buf;
  buf.reserve(in.size() + 8);
  for (uint32_t cp : in) decompose(cp, buf);
  // canonical ordering (stable bubble over nonzero-ccc runs)
  for (size_t i = 1; i < buf.size(); i++) {
    uint8_t c = ccc(buf[i]);
    if (!c) continue;
    size_t j = i;
    while (j > 0 && ccc(buf[j - 1]) > c) {
      uint32_t tmp = buf[j - 1];
      buf[j - 1] = buf[j];
      buf[j] = tmp;
      j--;
    }
  }
  // canonical composition (UAX#15)
  out.clear();
  if (buf.empty()) return;
  out.push_back(buf[0]);
  long starter = ccc(buf[0]) == 0 ? 0 : -1;
  for (size_t i = 1; i < buf.size(); i++) {
    uint32_t ch = buf[i];
    uint8_t c = ccc(ch);
    if (starter >= 0) {
      bool blocked;
      if ((long)out.size() - 1 == starter) {
        blocked = false;
      } else {
        uint8_t lc = ccc(out.back());
        blocked = (lc == 0) || (lc >= c);
      }
      if (!blocked) {
        uint32_t comp = compose_pair(out[(size_t)starter], ch);
        if (comp) { out[(size_t)starter] = comp; continue; }
      }
    }
    out.push_back(ch);
    if (c == 0) starter = (long)out.size() - 1;
  }
}

// ---- lowercase (CPython str.lower parity incl. Final_Sigma) ---------------

inline void lower_into(const std::vector<uint32_t> &in,
                       std::vector<uint32_t> &out) {
  out.clear();
  for (size_t i = 0; i < in.size(); i++) {
    uint32_t cp = in[i];
    if (cp == 0x3A3) {  // GREEK CAPITAL SIGMA: Final_Sigma context
      bool before = false;
      for (size_t j = i; j > 0; j--) {
        uint32_t prev = in[j - 1];
        if (is_case_ignorable(prev)) continue;
        before = is_cased(prev);
        break;
      }
      bool after = false;
      for (size_t j = i + 1; j < in.size(); j++) {
        uint32_t next = in[j];
        if (is_case_ignorable(next)) continue;
        after = is_cased(next);
        break;
      }
      out.push_back(before && !after ? 0x3C2 : 0x3C3);
      continue;
    }
    long k = find_key(SLT_LOWER_KEY, SLT_LOWER_KEY_len, cp);
    if (k < 0) { out.push_back(cp); continue; }
    uint32_t v = SLT_LOWER_VAL[k];
    size_t off = v >> 5, len = v & 31;
    for (size_t j = 0; j < len; j++)
      out.push_back(SLT_LOWER_FLAT[off + j]);
  }
}

// ---- UAX#29 word segmentation (twin of analysis/uax29.py) -----------------

inline bool wb_ignore(int c) {
  return c == SLT_WB_EXTEND || c == SLT_WB_FORMAT || c == SLT_WB_ZWJ;
}
inline bool wb_ah(int c) {
  return c == SLT_WB_ALETTER || c == SLT_WB_HEBREW_LETTER;
}
inline bool wb_midq(int c) {
  return c == SLT_WB_MIDNUMLET || c == SLT_WB_SINGLE_QUOTE;
}

// yields boundary flags: bounds[i] = word boundary before cps[i]
inline void word_bounds(const std::vector<uint32_t> &cps,
                        std::vector<char> &brk) {
  size_t n = cps.size();
  brk.assign(n + 1, 0);
  brk[0] = 1;
  brk[n] = 1;
  if (n == 0) return;
  std::vector<int> cls(n);
  for (size_t i = 0; i < n; i++) cls[i] = wb_class(cps[i]);

  int left = cls[0];
  int left2 = SLT_WB_OTHER;
  int ri_run = left == SLT_WB_REGIONAL_INDICATOR ? 1 : 0;

  for (size_t i = 1; i < n; i++) {
    int right = cls[i];
    int prev = cls[i - 1];
    bool b;
    bool nl_prev = prev == SLT_WB_NEWLINE || prev == SLT_WB_CR ||
                   prev == SLT_WB_LF;
    bool nl_right = right == SLT_WB_NEWLINE || right == SLT_WB_CR ||
                    right == SLT_WB_LF;
    if (prev == SLT_WB_CR && right == SLT_WB_LF) b = false;      // WB3
    else if (nl_prev) b = true;                                  // WB3a
    else if (nl_right) b = true;                                 // WB3b
    else if (prev == SLT_WB_ZWJ && is_ext_pict(cps[i])) b = false;  // 3c
    else if (prev == SLT_WB_WSEGSPACE &&
             right == SLT_WB_WSEGSPACE) b = false;               // WB3d
    else if (wb_ignore(right)) b = false;                        // WB4
    else {
      int right2 = SLT_WB_OTHER;
      for (size_t j = i + 1; j < n; j++) {
        if (!wb_ignore(cls[j])) { right2 = cls[j]; break; }
      }
      if (wb_ah(left) && wb_ah(right)) b = false;                // WB5
      else if (wb_ah(left) && wb_ah(right2) &&
               (right == SLT_WB_MIDLETTER || wb_midq(right)))
        b = false;                                               // WB6
      else if ((left == SLT_WB_MIDLETTER || wb_midq(left)) &&
               wb_ah(left2) && wb_ah(right))
        b = false;                                               // WB7
      else if (left == SLT_WB_HEBREW_LETTER &&
               right == SLT_WB_SINGLE_QUOTE)
        b = false;                                               // WB7a
      else if (left == SLT_WB_HEBREW_LETTER &&
               right == SLT_WB_DOUBLE_QUOTE &&
               right2 == SLT_WB_HEBREW_LETTER)
        b = false;                                               // WB7b
      else if (left == SLT_WB_DOUBLE_QUOTE &&
               left2 == SLT_WB_HEBREW_LETTER &&
               right == SLT_WB_HEBREW_LETTER)
        b = false;                                               // WB7c
      else if (left == SLT_WB_NUMERIC && right == SLT_WB_NUMERIC)
        b = false;                                               // WB8
      else if (wb_ah(left) && right == SLT_WB_NUMERIC) b = false;  // 9
      else if (left == SLT_WB_NUMERIC && wb_ah(right)) b = false;  // 10
      else if ((left == SLT_WB_MIDNUM || wb_midq(left)) &&
               left2 == SLT_WB_NUMERIC && right == SLT_WB_NUMERIC)
        b = false;                                               // WB11
      else if (left == SLT_WB_NUMERIC && right2 == SLT_WB_NUMERIC &&
               (right == SLT_WB_MIDNUM || wb_midq(right)))
        b = false;                                               // WB12
      else if (left == SLT_WB_KATAKANA && right == SLT_WB_KATAKANA)
        b = false;                                               // WB13
      else if (right == SLT_WB_EXTENDNUMLET &&
               (wb_ah(left) || left == SLT_WB_NUMERIC ||
                left == SLT_WB_KATAKANA ||
                left == SLT_WB_EXTENDNUMLET))
        b = false;                                               // WB13a
      else if (left == SLT_WB_EXTENDNUMLET &&
               (wb_ah(right) || right == SLT_WB_NUMERIC ||
                right == SLT_WB_KATAKANA))
        b = false;                                               // WB13b
      else if (left == SLT_WB_REGIONAL_INDICATOR &&
               right == SLT_WB_REGIONAL_INDICATOR && ri_run % 2 == 1)
        b = false;                                               // 15/16
      else
        b = true;                                                // WB999
    }
    if (b) brk[i] = 1;
    if (!(wb_ignore(right) && !nl_prev)) {
      if (right == SLT_WB_REGIONAL_INDICATOR)
        ri_run = left == SLT_WB_REGIONAL_INDICATOR ? ri_run + 1 : 1;
      else
        ri_run = 0;
      left2 = left;
      left = right;
    }
  }
}

// The full `unicode` analyzer pipeline: utf8 -> NFKC -> UAX#29 words
// (alphanumeric-containing segments only) -> lowercase -> utf8 tokens.
inline void unicode_analyze(const char *text, long n,
                            std::vector<std::string> &tokens) {
  std::vector<uint32_t> raw, norm, low;
  utf8_decode(text, n, raw);
  nfkc(raw, norm);
  std::vector<char> brk;
  word_bounds(norm, brk);
  size_t start = 0;
  std::vector<uint32_t> seg;
  for (size_t i = 1; i <= norm.size(); i++) {
    if (!brk[i]) continue;
    bool any = false;
    for (size_t j = start; j < i; j++) {
      if (is_alnum(norm[j])) { any = true; break; }
    }
    if (any) {
      seg.assign(norm.begin() + start, norm.begin() + i);
      lower_into(seg, low);
      std::string out;
      for (uint32_t cp : low) utf8_encode(cp, out);
      tokens.push_back(std::move(out));
    }
    start = i;
  }
}

}  // namespace sltu
