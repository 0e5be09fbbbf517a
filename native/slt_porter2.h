// Porter2 (Snowball "english") stemmer — C++ port of
// searchlite/analysis/porter2.py (itself implementing the published
// Snowball english algorithm with generated-runtime region semantics:
// R1/R2 fixed as integer positions). ASCII-only: the native ingest path
// rejects non-ASCII values before reaching this code.
//
// Byte-equivalence with the Python implementation is enforced by
// tests/test_native.py on a shared vocabulary.
#pragma once

#include <algorithm>
#include <array>
#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>

namespace slt_porter2 {

inline bool is_vowel_char(char c) {
  return c == 'a' || c == 'e' || c == 'i' || c == 'o' || c == 'u' ||
         c == 'y';
}

inline bool is_vowel(const std::string& w, size_t i) {
  return is_vowel_char(w[i]);
}

inline bool contains_vowel(const std::string& w, size_t start, size_t end) {
  for (size_t i = start; i < end && i < w.size(); ++i) {
    if (is_vowel(w, i)) return true;
  }
  return false;
}

inline size_t compute_r1(const std::string& w) {
  static const char* prefixes[] = {"gener", "commun", "arsen"};
  for (const char* p : prefixes) {
    size_t n = std::strlen(p);
    if (w.size() >= n && w.compare(0, n, p) == 0) return n;
  }
  for (size_t i = 1; i < w.size(); ++i) {
    if (!is_vowel(w, i) && is_vowel(w, i - 1)) return i + 1;
  }
  return w.size();
}

inline size_t compute_r2(const std::string& w, size_t r1) {
  for (size_t i = r1 + 1; i < w.size(); ++i) {
    if (!is_vowel(w, i) && is_vowel(w, i - 1)) return i + 1;
  }
  return w.size();
}

inline bool is_short_syllable(const std::string& w, size_t i) {
  if (i == 0) {
    return w.size() >= 2 && is_vowel(w, 0) && !is_vowel(w, 1);
  }
  return i + 1 < w.size() && is_vowel(w, i) && !is_vowel(w, i + 1) &&
         w[i + 1] != 'w' && w[i + 1] != 'x' && w[i + 1] != 'Y' &&
         !is_vowel(w, i - 1);
}

inline bool ends_in_short_syllable(const std::string& w) {
  if (w.size() < 2) return false;
  if (w.size() == 2) return is_vowel(w, 0) && !is_vowel(w, 1);
  return is_short_syllable(w, w.size() - 2);
}

inline bool is_short_word(const std::string& w, size_t r1) {
  return r1 >= w.size() && ends_in_short_syllable(w);
}

inline bool ends_with(const std::string& w, const char* suf) {
  size_t n = std::strlen(suf);
  return w.size() >= n && w.compare(w.size() - n, n, suf) == 0;
}

inline bool ends_double(const std::string& w) {
  static const char* doubles[] = {"bb", "dd", "ff", "gg", "mm",
                                  "nn", "pp", "rr", "tt"};
  for (const char* d : doubles) {
    if (ends_with(w, d)) return true;
  }
  return false;
}

inline std::string stem(std::string word) {
  for (auto& c : word) {
    if (c >= 'A' && c <= 'Z') c = static_cast<char>(c + 32);
  }
  if (word.size() <= 2) return word;
  if (!word.empty() && word[0] == '\'') word.erase(0, 1);

  static const std::unordered_map<std::string, std::string> kEx1 = {
      {"skis", "ski"},     {"skies", "sky"},   {"dying", "die"},
      {"lying", "lie"},    {"tying", "tie"},   {"idly", "idl"},
      {"gently", "gentl"}, {"ugly", "ugli"},   {"early", "earli"},
      {"only", "onli"},    {"singly", "singl"},{"sky", "sky"},
      {"news", "news"},    {"howe", "howe"},   {"atlas", "atlas"},
      {"cosmos", "cosmos"},{"bias", "bias"},   {"andes", "andes"}};
  auto ex = kEx1.find(word);
  if (ex != kEx1.end()) return ex->second;
  if (word.size() <= 2) return word;

  // mark consonant-y as Y
  if (word[0] == 'y') word[0] = 'Y';
  for (size_t i = 1; i < word.size(); ++i) {
    if (word[i] == 'y' && is_vowel_char(word[i - 1])) word[i] = 'Y';
  }

  const size_t r1 = compute_r1(word);
  const size_t r2 = compute_r2(word, r1);

  // step 0
  for (const char* suf : {"'s'", "'s", "'"}) {
    if (ends_with(word, suf)) {
      word.resize(word.size() - std::strlen(suf));
      break;
    }
  }

  // step 1a
  if (ends_with(word, "sses")) {
    word.resize(word.size() - 2);
  } else if (ends_with(word, "ied") || ends_with(word, "ies")) {
    word.resize(word.size() - (word.size() > 4 ? 2 : 1));
  } else if (ends_with(word, "us") || ends_with(word, "ss")) {
    // no-op
  } else if (ends_with(word, "s")) {
    if (word.size() >= 2 && contains_vowel(word, 0, word.size() - 2)) {
      word.resize(word.size() - 1);
    }
  }

  static const std::unordered_set<std::string> kEx2 = {
      "inning", "outing", "canning", "herring",
      "earring", "proceed", "exceed", "succeed"};
  if (kEx2.count(word)) return word;

  // step 1b
  bool step1b_done = false;
  for (const auto& [suf, repl] :
       std::array<std::pair<const char*, const char*>, 2>{
           {{"eedly", "ee"}, {"eed", "ee"}}}) {
    if (ends_with(word, suf)) {
      if (word.size() - std::strlen(suf) >= r1) {
        word.resize(word.size() - std::strlen(suf));
        word += repl;
      }
      step1b_done = true;
      break;
    }
  }
  if (!step1b_done) {
    for (const char* suf : {"ingly", "edly", "ing", "ed"}) {
      if (ends_with(word, suf)) {
        std::string stem_part = word.substr(0, word.size() - std::strlen(suf));
        if (contains_vowel(stem_part, 0, stem_part.size())) {
          word = stem_part;
          if (ends_with(word, "at") || ends_with(word, "bl") ||
              ends_with(word, "iz")) {
            word += 'e';
          } else if (ends_double(word)) {
            word.resize(word.size() - 1);
          } else if (is_short_word(word, r1)) {
            word += 'e';
          }
        }
        break;
      }
    }
  }

  // step 1c
  if (word.size() > 2 && (word.back() == 'y' || word.back() == 'Y') &&
      !is_vowel_char(word[word.size() - 2])) {
    word.back() = 'i';
  }

  // step 2
  {
    static const std::array<std::pair<const char*, const char*>, 22> kStep2{
        {{"ization", "ize"}, {"ational", "ate"}, {"ousness", "ous"},
         {"iveness", "ive"}, {"fulness", "ful"}, {"tional", "tion"},
         {"biliti", "ble"},  {"lessli", "less"}, {"entli", "ent"},
         {"ation", "ate"},   {"alism", "al"},    {"aliti", "al"},
         {"ousli", "ous"},   {"iviti", "ive"},   {"fulli", "ful"},
         {"enci", "ence"},   {"anci", "ance"},   {"abli", "able"},
         {"izer", "ize"},    {"ator", "ate"},    {"alli", "al"},
         {"bli", "ble"}}};
    bool matched = false;
    for (const auto& [suf, repl] : kStep2) {
      if (ends_with(word, suf)) {
        if (word.size() - std::strlen(suf) >= r1) {
          word.resize(word.size() - std::strlen(suf));
          word += repl;
        }
        matched = true;
        break;
      }
    }
    if (!matched) {
      if (ends_with(word, "ogi")) {
        if (word.size() >= 4 && word.size() - 3 >= r1 &&
            word[word.size() - 4] == 'l') {
          word.resize(word.size() - 1);
        }
      } else if (ends_with(word, "li")) {
        if (word.size() >= 3 && word.size() - 2 >= r1) {
          char prev = word[word.size() - 3];
          if (std::strchr("cdeghkmnrt", prev)) {
            word.resize(word.size() - 2);
          }
        }
      }
    }
  }

  // step 3
  {
    static const std::array<std::pair<const char*, const char*>, 8> kStep3{
        {{"ational", "ate"}, {"tional", "tion"}, {"alize", "al"},
         {"icate", "ic"},    {"iciti", "ic"},    {"ical", "ic"},
         {"ful", ""},        {"ness", ""}}};
    bool matched = false;
    for (const auto& [suf, repl] : kStep3) {
      if (ends_with(word, suf)) {
        if (word.size() - std::strlen(suf) >= r1) {
          word.resize(word.size() - std::strlen(suf));
          word += repl;
        }
        matched = true;
        break;
      }
    }
    if (!matched && ends_with(word, "ative")) {
      if (word.size() - 5 >= r1 && word.size() - 5 >= r2) {
        word.resize(word.size() - 5);
      }
    }
  }

  // step 4
  {
    static const std::array<const char*, 17> kStep4{
        {"ement", "ance", "ence", "able", "ible", "ment", "ant", "ent",
         "ism", "ate", "iti", "ous", "ive", "ize", "al", "er", "ic"}};
    bool matched = false;
    for (const char* suf : kStep4) {
      if (ends_with(word, suf)) {
        if (word.size() - std::strlen(suf) >= r2) {
          word.resize(word.size() - std::strlen(suf));
        }
        matched = true;
        break;
      }
    }
    if (!matched && ends_with(word, "ion")) {
      if (word.size() >= 4 && word.size() - 3 >= r2) {
        char prev = word[word.size() - 4];
        if (prev == 's' || prev == 't') word.resize(word.size() - 3);
      }
    }
  }

  // step 5
  if (!word.empty() && word.back() == 'e') {
    if (word.size() - 1 >= r2) {
      word.resize(word.size() - 1);
    } else if (word.size() - 1 >= r1) {
      std::string head = word.substr(0, word.size() - 1);
      if (!ends_in_short_syllable(head)) word.resize(word.size() - 1);
    }
  } else if (!word.empty() && word.back() == 'l') {
    if (word.size() >= 2 && word.size() - 1 >= r2 &&
        word[word.size() - 2] == 'l') {
      word.resize(word.size() - 1);
    }
  }

  for (auto& c : word) {
    if (c == 'Y') c = 'y';
  }
  return word;
}

}  // namespace slt_porter2
