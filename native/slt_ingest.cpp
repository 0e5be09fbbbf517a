// searchlite native ingest accelerator.
//
// Replaces the hot host-side ingest loop (tokenize -> postings
// accumulate; the reference's `index/segment.rs:655-698` +
// `index/postings.rs:31-57` equivalent) with C++ passes.
//
// Tokenizers: the `default` tokenizer's ASCII subset (split on
// non-alnum, lowercase ASCII letters; byte-identical to the Python
// path for ASCII input) and the full `unicode` chain (NFKC + UAX#29 +
// lowercase, slt_unicode.h). Optional English filter chain (stopwords
// + Porter2 stemming, slt_porter2.h).
//
// The term table is sharded by a stable FNV-1a hash of the key so the
// bulk entry point (slt_add_texts) can run multi-threaded: phase A
// tokenizes item ranges in parallel (ranges aligned to position-chain
// group boundaries), phase B inserts each hash-shard's tokens on its
// own thread, scanning the phase-A streams in order so every term's
// postings stay doc-ascending. Output is deterministic for any thread
// count: slt_finish sorts terms globally before export.
//
// Exported arrays mirror the device block layout of
// `searchlite/index/postings.py` (128-wide doc/tf blocks, ragged
// CSR positions).
//
// Built with: g++ -O3 -shared -fPIC -pthread -std=c++17 slt_ingest.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "slt_porter2.h"
#include "slt_unicode.h"

namespace {

constexpr int BLOCK = 128;

struct TermPostings {
  std::vector<uint32_t> docs;
  std::vector<float> tfs;
  // ragged positions: one run per posting
  std::vector<uint32_t> pos_data;
  std::vector<uint32_t> pos_lens;

  // Eager insert — the positions-ON path (positions-off inserts ride
  // the flat log + materialize() below, which never touches
  // pos_lens/pos_data; the exporter treats a short pos_lens as
  // all-zero lengths). pos_lens stays aligned one-entry-per-posting
  // even for with_positions=false adds (keyword terms on a
  // positions-on builder), so a term mixing both flags can never
  // misattribute positions or hit pos_lens.back() on an empty vector.
  void add(uint32_t doc, uint32_t pos, bool with_positions) {
    if (!docs.empty() && docs.back() == doc) {
      tfs.back() += 1.0f;
      if (with_positions) {
        pos_data.push_back(pos);
        pos_lens.back() += 1;
      }
    } else {
      docs.push_back(doc);
      tfs.push_back(1.0f);
      if (with_positions) {
        pos_data.push_back(pos);
        pos_lens.push_back(1);
      } else {
        pos_lens.push_back(0);
      }
    }
  }
};

inline uint64_t fnv1a_cont(uint64_t h, const char* p, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    h ^= static_cast<unsigned char>(p[i]);
    h *= 1099511628211ull;
  }
  return h;
}

inline uint64_t fnv1a(const char* p, size_t n) {
  return fnv1a_cont(1469598103934665603ull, p, n);
}

struct Shard {
  // Open-addressing term table keyed by the fnv1a hash the caller
  // already computed for shard routing (libstdc++ unordered_map would
  // hash the full key a second time and chase bucket nodes — measured
  // ~2x slower on the ingest hot loop). Linear probing, 0 = empty,
  // load factor <= 0.7.
  std::vector<uint64_t> slot_hash;
  std::vector<uint32_t> slot_id1;  // term id + 1; 0 = empty slot
  size_t n_used = 0;
  std::vector<TermPostings> terms;
  std::vector<std::string> term_keys;

  void rehash(size_t cap) {
    std::vector<uint64_t> nh(cap, 0);
    std::vector<uint32_t> ni(cap, 0);
    const size_t mask = cap - 1;
    for (size_t j = 0; j < slot_id1.size(); ++j) {
      if (!slot_id1[j]) continue;
      size_t i = static_cast<size_t>(slot_hash[j]) & mask;
      while (ni[i]) i = (i + 1) & mask;
      nh[i] = slot_hash[j];
      ni[i] = slot_id1[j];
    }
    slot_hash.swap(nh);
    slot_id1.swap(ni);
  }

  // flat insert log (positions-off mode): (term_id << 32) | doc per
  // TOKEN, appended sequentially — the cache-hostile per-term vector
  // pushes move to materialize(), whose counting-sort cursors and
  // counts stay cache-resident
  std::vector<uint64_t> recs;

  uint32_t term_id_h(uint64_t h, const char* key, size_t klen) {
    if (slot_hash.empty()) rehash(4096);
    const size_t mask = slot_hash.size() - 1;
    size_t i = static_cast<size_t>(h) & mask;
    while (true) {
      const uint32_t id1 = slot_id1[i];
      if (id1 == 0) break;
      if (slot_hash[i] == h) {
        const std::string& k = term_keys[id1 - 1];
        if (k.size() == klen && std::memcmp(k.data(), key, klen) == 0)
          return id1 - 1;
      }
      i = (i + 1) & mask;
    }
    const uint32_t id = static_cast<uint32_t>(terms.size());
    terms.emplace_back();
    term_keys.emplace_back(key, klen);
    slot_hash[i] = h;
    slot_id1[i] = id + 1;
    if (++n_used * 10 >= slot_hash.size() * 7)
      rehash(slot_hash.size() * 2);
    return id;
  }

  TermPostings& term_h(uint64_t h, const char* key, size_t klen) {
    return terms[term_id_h(h, key, klen)];
  }

  TermPostings& term(const std::string& key) {
    return term_h(fnv1a(key.data(), key.size()), key.data(), key.size());
  }

  // Replay the flat log into per-term (docs, tfs): stable counting
  // sort by term id (preserves the log's doc-ascending order within a
  // term), then combine equal-doc runs with the SAME back()==doc /
  // tfs += 1.0f accumulation TermPostings::add performs — the output
  // is bit-identical to the eager path.
  void materialize() {
    if (recs.empty()) return;
    const size_t nt = terms.size();
    std::vector<uint64_t> bounds(nt + 1, 0);
    for (uint64_t r : recs) ++bounds[(r >> 32) + 1];
    for (size_t t = 1; t <= nt; ++t) bounds[t] += bounds[t - 1];
    std::vector<uint32_t> docs_flat(recs.size());
    std::vector<uint64_t> cursor(bounds.begin(), bounds.end() - 1);
    for (uint64_t r : recs)
      docs_flat[cursor[r >> 32]++] = static_cast<uint32_t>(r);
    for (size_t t = 0; t < nt; ++t) {
      TermPostings& tp = terms[t];
      const uint64_t lo = bounds[t], hi = bounds[t + 1];
      if (lo == hi) continue;
      tp.docs.reserve(tp.docs.size() + (hi - lo));
      tp.tfs.reserve(tp.tfs.size() + (hi - lo));
      for (uint64_t p = lo; p < hi; ++p) {
        const uint32_t d = docs_flat[p];
        if (!tp.docs.empty() && tp.docs.back() == d) {
          tp.tfs.back() += 1.0f;
        } else {
          tp.docs.push_back(d);
          tp.tfs.push_back(1.0f);
        }
      }
    }
    recs.clear();
    recs.shrink_to_fit();
  }
};

struct Builder {
  bool enable_positions;
  int n_shards;
  std::vector<Shard> shards;
  // optional analyzer filter chain (English profile)
  std::unordered_set<std::string> stopwords;

  // finish() products
  struct Ref {
    uint32_t shard;
    uint32_t id;
  };
  std::vector<Ref> sorted_order;
  uint64_t n_blocks = 0;
  uint64_t n_postings = 0;
  uint64_t n_positions = 0;
  uint64_t terms_bytes = 0;

  TermPostings& term(const std::string& key) {
    const uint64_t h = fnv1a(key.data(), key.size());
    return shards[h % static_cast<uint64_t>(n_shards)].term_h(
        h, key.data(), key.size());
  }

  // one insert per surviving token: flat log when positions are off
  // (replayed at finish — Shard::materialize), eager TermPostings
  // push when positions are on (the per-token position must ride
  // along)
  void insert(Shard& s, uint64_t h, const char* key, size_t klen,
              uint32_t doc, uint32_t pos, bool with_pos) {
    const uint32_t id = s.term_id_h(h, key, klen);
    if (enable_positions) {
      s.terms[id].add(doc, pos, with_pos);
    } else {
      s.recs.push_back((static_cast<uint64_t>(id) << 32) | doc);
    }
  }

  void insert(uint64_t h, const char* key, size_t klen, uint32_t doc,
              uint32_t pos, bool with_pos) {
    insert(shards[h % static_cast<uint64_t>(n_shards)], h, key, klen,
           doc, pos, with_pos);
  }
};

inline bool is_ascii_alnum(unsigned char c) {
  return (c >= '0' && c <= '9') || (c >= 'a' && c <= 'z') ||
         (c >= 'A' && c <= 'Z');
}

// Tokenize one text value through either analyzer chain, emitting
// (key, key_hash, position) for every surviving token — the hash is
// fnv1a over the full key, folded as prefix-hash + token bytes so the
// prefix is hashed once per item, not once per token. Returns the
// surviving token count; *max_pos_out = last surviving position
// (0xFFFFFFFF when none). Shared by the sequential and the threaded
// bulk paths so their token streams are identical by construction.
template <typename Emit>
long long analyze_item(const std::unordered_set<std::string>& stopwords,
                       const char* text, long long tlen, const char* pfx,
                       size_t plen, bool use_stop, bool use_stem,
                       bool use_unicode, uint32_t* max_pos_out,
                       Emit&& emit) {
  long long count = 0;
  uint32_t position = 0;
  uint32_t max_pos = 0xFFFFFFFFu;
  std::string key;
  const uint64_t pfx_h = fnv1a(pfx, plen);
  if (use_unicode) {
    std::vector<std::string> tokens;
    sltu::unicode_analyze(text, tlen, tokens);
    for (auto& tok : tokens) {
      if (use_stop && stopwords.count(tok)) continue;
      key.assign(pfx, plen);
      key += tok;
      emit(key, fnv1a_cont(pfx_h, tok.data(), tok.size()), position);
      max_pos = position;
      ++position;
      ++count;
    }
  } else {
    std::string token;
    key.assign(pfx, plen);
    for (long long i = 0; i <= tlen; ++i) {
      const bool alnum =
          i < tlen && is_ascii_alnum(static_cast<unsigned char>(text[i]));
      if (alnum) {
        char c = text[i];
        if (c >= 'A' && c <= 'Z') c = static_cast<char>(c + 32);
        token.push_back(c);
      } else if (!token.empty()) {
        if (use_stop && stopwords.count(token)) {
          token.clear();
          continue;
        }
        if (use_stem) token = slt_porter2::stem(std::move(token));
        key.resize(plen);  // keep the prefix bytes, drop the old token
        key += token;
        emit(key, fnv1a_cont(pfx_h, token.data(), token.size()),
             position);
        max_pos = position;
        ++position;
        ++count;
        token.clear();
      }
    }
  }
  *max_pos_out = max_pos;
  return count;
}

// Phase-A output: one token stream per item range.
struct TokRec {
  uint64_t hash;
  uint32_t doc;
  uint32_t pos;
  uint32_t key_off;
  uint32_t key_len;
};

struct Stream {
  std::vector<TokRec> toks;
  std::string arena;
};

}  // namespace

extern "C" {

// n_threads <= 0 selects automatically (hardware_concurrency, capped).
void* slt_new(int enable_positions, int n_threads) {
  auto* b = new Builder();
  b->enable_positions = enable_positions != 0;
  int t = n_threads;
  if (t <= 0) {
    t = static_cast<int>(std::thread::hardware_concurrency());
    if (t > 8) t = 8;
  }
  if (t < 1) t = 1;
  b->n_shards = t;
  b->shards.resize(static_cast<size_t>(t));
  return b;
}

void slt_free(void* handle) { delete static_cast<Builder*>(handle); }

// Add one token (already-analyzed, e.g. lowercased keywords or Python
// fallback tokens). key = "{field}:{token}".
void slt_add_token(void* handle, const char* key, int key_len, uint32_t doc,
                   uint32_t pos, int with_positions) {
  auto* b = static_cast<Builder*>(handle);
  std::string k(key, static_cast<size_t>(key_len));
  const uint64_t h = fnv1a(k.data(), k.size());
  b->insert(h, k.data(), k.size(), doc, pos,
            b->enable_positions && with_positions != 0);
}

// Register a stopword for the builder's English filter profile.
void slt_add_stopword(void* handle, const char* word, int len) {
  auto* b = static_cast<Builder*>(handle);
  b->stopwords.emplace(word, static_cast<size_t>(len));
}

// Expose the stemmer for cross-language equivalence tests.
// Returns the stemmed length; writes at most out_cap bytes.
int slt_stem(const char* word, int len, char* out, int out_cap) {
  std::string stemmed =
      slt_porter2::stem(std::string(word, static_cast<size_t>(len)));
  int n = static_cast<int>(stemmed.size());
  if (n > out_cap) n = out_cap;
  std::memcpy(out, stemmed.data(), static_cast<size_t>(n));
  return n;
}

// Tokenize one ASCII text value with the `default` tokenizer, optionally
// apply the English filter chain (stopword removal then Snowball
// stemming — positions resequence over surviving tokens, matching the
// Python analyzer), and add all tokens under "{field_prefix}{token}".
// field_prefix includes the ':'. position_offset is added to every token
// position (cross-value offsets).
//
// Returns -1 (no side effects) if the text contains non-ASCII bytes;
// otherwise the surviving token count. out_max_pos receives the max
// token position (un-offset), or 0xFFFFFFFF when no tokens survive.
long long slt_add_text(void* handle, const char* field_prefix, int prefix_len,
                       uint32_t doc, const char* text, long long text_len,
                       uint32_t position_offset, int use_stopwords,
                       int use_stem, uint32_t* out_max_pos) {
  for (long long i = 0; i < text_len; ++i) {
    if (static_cast<unsigned char>(text[i]) >= 0x80) return -1;
  }
  auto* b = static_cast<Builder*>(handle);
  long long count = analyze_item(
      b->stopwords, text, text_len, field_prefix,
      static_cast<size_t>(prefix_len), use_stopwords != 0, use_stem != 0,
      false, out_max_pos,
      [&](const std::string& key, uint64_t h, uint32_t pos) {
        b->insert(h, key.data(), key.size(), doc, position_offset + pos,
                  b->enable_positions);
      });
  return count;
}

// Tokenize+add one text value through the `unicode` analyzer chain
// (NFKC -> UAX#29 unicode_words -> lowercase [-> stopwords]) — the
// native twin of analysis/tokenizers.py::unicode_tokenize +
// analysis/uax29.py, equivalence-fuzzed in tests/test_native.py.
// Handles ANY input (no ASCII restriction). Returns the surviving
// token count; out_max_pos as in slt_add_text.
long long slt_add_text_unicode(void* handle, const char* field_prefix,
                               int prefix_len, uint32_t doc,
                               const char* text, long long text_len,
                               uint32_t position_offset,
                               int use_stopwords,
                               uint32_t* out_max_pos) {
  auto* b = static_cast<Builder*>(handle);
  long long count = analyze_item(
      b->stopwords, text, text_len, field_prefix,
      static_cast<size_t>(prefix_len), use_stopwords != 0, false, true,
      out_max_pos,
      [&](const std::string& key, uint64_t h, uint32_t pos) {
        b->insert(h, key.data(), key.size(), doc, position_offset + pos,
                  b->enable_positions);
      });
  return count;
}

// Bulk tokenize+add: n_items text values, processed in order. Items
// belonging to one (doc, field) group are consecutive; new_group[i]=1
// resets the position-offset chain, so a group behaves exactly like
// repeated slt_add_text calls with chained position_offset. Per-field
// analyzer settings come from the parallel field table (prefixes
// include the ':'). Default-tokenizer items must be pure ASCII (the
// caller pre-checks with str.isascii(); bytes >= 0x80 would merely act
// as token separators here). out_counts[i] receives each item's
// surviving token count. One call amortizes the Python->C boundary
// over thousands of values (~30us/call measured via ctypes), and runs
// the builder's thread count across tokenize (phase A, by item range)
// and term-table insert (phase B, by term-hash shard).
void slt_add_texts(void* handle, const char* texts, const int64_t* text_off,
                   const uint32_t* doc_ords, const int32_t* field_ids,
                   const uint8_t* new_group, long long n_items,
                   const char* prefixes, const int32_t* prefix_off,
                   const uint8_t* f_stop, const uint8_t* f_stem,
                   const uint8_t* f_unicode, int n_fields,
                   int64_t* out_counts) {
  auto* b = static_cast<Builder*>(handle);
  (void)n_fields;
  const int T = b->n_shards;

  if (T == 1) {
    // sequential fast path: insert directly, no token materialization
    uint32_t offset = 0;
    for (long long it = 0; it < n_items; ++it) {
      if (new_group[it]) offset = 0;
      const int32_t f = field_ids[it];
      uint32_t max_pos = 0xFFFFFFFFu;
      out_counts[it] = analyze_item(
          b->stopwords, texts + text_off[it],
          text_off[it + 1] - text_off[it], prefixes + prefix_off[f],
          static_cast<size_t>(prefix_off[f + 1] - prefix_off[f]),
          f_stop[f] != 0, f_stem[f] != 0, f_unicode[f] != 0, &max_pos,
          [&](const std::string& key, uint64_t h, uint32_t pos) {
            b->insert(b->shards[0], h, key.data(), key.size(),
                      doc_ords[it], offset + pos, b->enable_positions);
          });
      offset += (max_pos == 0xFFFFFFFFu) ? 1u : (max_pos + 1u);
    }
    return;
  }

  // phase A — parallel tokenize over item ranges aligned to group
  // boundaries (the position chain never crosses a range)
  std::vector<long long> bounds(static_cast<size_t>(T) + 1, 0);
  bounds[static_cast<size_t>(T)] = n_items;
  for (int t = 1; t < T; ++t) {
    long long target = n_items * t / T;
    while (target < n_items && !new_group[target]) ++target;
    bounds[static_cast<size_t>(t)] = target;
  }
  for (int t = 1; t <= T; ++t) {
    if (bounds[t] < bounds[t - 1]) bounds[t] = bounds[t - 1];
  }
  std::vector<Stream> streams(static_cast<size_t>(T));
  auto phase_a = [&](int t) {
    Stream& out = streams[static_cast<size_t>(t)];
    out.arena.reserve(1 << 16);
    uint32_t offset = 0;
    for (long long it = bounds[t]; it < bounds[t + 1]; ++it) {
      if (new_group[it]) offset = 0;
      const int32_t f = field_ids[it];
      uint32_t max_pos = 0xFFFFFFFFu;
      out_counts[it] = analyze_item(
          b->stopwords, texts + text_off[it],
          text_off[it + 1] - text_off[it], prefixes + prefix_off[f],
          static_cast<size_t>(prefix_off[f + 1] - prefix_off[f]),
          f_stop[f] != 0, f_stem[f] != 0, f_unicode[f] != 0, &max_pos,
          [&](const std::string& key, uint64_t h, uint32_t pos) {
            out.toks.push_back(
                {h, doc_ords[it], offset + pos,
                 static_cast<uint32_t>(out.arena.size()),
                 static_cast<uint32_t>(key.size())});
            out.arena.append(key);
          });
      offset += (max_pos == 0xFFFFFFFFu) ? 1u : (max_pos + 1u);
    }
  };
  {
    std::vector<std::thread> workers;
    workers.reserve(static_cast<size_t>(T));
    for (int t = 0; t < T; ++t) workers.emplace_back(phase_a, t);
    for (auto& w : workers) w.join();
  }

  // phase B — each hash shard inserts its tokens on its own thread,
  // scanning streams in range order so postings stay doc-ascending
  auto phase_b = [&](uint32_t shard_id) {
    Shard& s = b->shards[shard_id];
    const uint64_t mod = static_cast<uint64_t>(T);
    for (const auto& st : streams) {
      for (const auto& tk : st.toks) {
        if (tk.hash % mod != shard_id) continue;
        b->insert(s, tk.hash, st.arena.data() + tk.key_off,
                  tk.key_len, tk.doc, tk.pos, b->enable_positions);
      }
    }
  };
  {
    std::vector<std::thread> workers;
    workers.reserve(static_cast<size_t>(T));
    for (int t = 0; t < T; ++t)
      workers.emplace_back(phase_b, static_cast<uint32_t>(t));
    for (auto& w : workers) w.join();
  }
}

// Sort terms globally, compute export sizes.
void slt_finish(void* handle) {
  auto* b = static_cast<Builder*>(handle);
  // positions-off builders replay their flat insert logs here (one
  // thread per shard; a no-op for positions-on builders / empty logs)
  if (b->n_shards == 1) {
    b->shards[0].materialize();
  } else {
    std::vector<std::thread> workers;
    workers.reserve(b->shards.size());
    for (auto& s : b->shards)
      workers.emplace_back([&s] { s.materialize(); });
    for (auto& w : workers) w.join();
  }
  b->sorted_order.clear();
  for (uint32_t s = 0; s < b->shards.size(); ++s) {
    const size_t n = b->shards[s].terms.size();
    for (uint32_t i = 0; i < n; ++i) b->sorted_order.push_back({s, i});
  }
  std::sort(b->sorted_order.begin(), b->sorted_order.end(),
            [b](const Builder::Ref& a, const Builder::Ref& c) {
              return b->shards[a.shard].term_keys[a.id] <
                     b->shards[c.shard].term_keys[c.id];
            });
  b->n_blocks = 0;
  b->n_postings = 0;
  b->n_positions = 0;
  b->terms_bytes = 0;
  for (const auto& r : b->sorted_order) {
    const auto& t = b->shards[r.shard].terms[r.id];
    b->n_postings += t.docs.size();
    b->n_positions += t.pos_data.size();
    b->n_blocks += (t.docs.size() + BLOCK - 1) / BLOCK;
    b->terms_bytes += 4 + b->shards[r.shard].term_keys[r.id].size();
  }
}

uint64_t slt_n_terms(void* h) {
  return static_cast<Builder*>(h)->sorted_order.size();
}
uint64_t slt_n_blocks(void* h) { return static_cast<Builder*>(h)->n_blocks; }
uint64_t slt_n_postings(void* h) {
  return static_cast<Builder*>(h)->n_postings;
}
uint64_t slt_n_positions(void* h) {
  return static_cast<Builder*>(h)->n_positions;
}
uint64_t slt_terms_bytes(void* h) {
  return static_cast<Builder*>(h)->terms_bytes;
}

// Export everything in sorted-term order into caller-allocated buffers:
//   terms_buf       [terms_bytes]   repeated u32-LE len + utf8 bytes
//   block_docs      [n_blocks*128]  int32, pad -1
//   block_tfs       [n_blocks*128]  float32, pad 0
//   block_term      [n_blocks]      int32
//   term_block_start/count/df [n_terms] int32
//   term_max_tf     [n_terms]       float32
//   block_max_tf    [n_blocks]      float32
//   block_last_doc  [n_blocks]      int32
//   pos_offsets     [n_postings+1]  int64 (posting-ordinal CSR)
//   pos_values      [n_positions]   int32
void slt_export(void* handle, char* terms_buf, int32_t* block_docs,
                float* block_tfs, int32_t* block_term,
                int32_t* term_block_start, int32_t* term_block_count,
                int32_t* term_df, float* term_max_tf, float* block_max_tf,
                int32_t* block_last_doc, int64_t* pos_offsets,
                int32_t* pos_values) {
  auto* b = static_cast<Builder*>(handle);
  const size_t n = b->sorted_order.size();
  uint64_t block_cursor = 0;
  uint64_t posting_cursor = 0;
  uint64_t pos_cursor = 0;
  char* tb = terms_buf;
  pos_offsets[0] = 0;
  for (size_t rank = 0; rank < n; ++rank) {
    const Builder::Ref ref = b->sorted_order[rank];
    const auto& key = b->shards[ref.shard].term_keys[ref.id];
    const auto& t = b->shards[ref.shard].terms[ref.id];
    const uint32_t klen = static_cast<uint32_t>(key.size());
    std::memcpy(tb, &klen, 4);
    tb += 4;
    std::memcpy(tb, key.data(), klen);
    tb += klen;

    const size_t df = t.docs.size();
    const size_t nb = (df + BLOCK - 1) / BLOCK;
    term_block_start[rank] = static_cast<int32_t>(block_cursor);
    term_block_count[rank] = static_cast<int32_t>(nb);
    term_df[rank] = static_cast<int32_t>(df);
    float max_tf = 0.0f;
    for (size_t i = 0; i < nb * BLOCK; ++i) {
      const size_t out = block_cursor * BLOCK + i;
      if (i < df) {
        block_docs[out] = static_cast<int32_t>(t.docs[i]);
        block_tfs[out] = t.tfs[i];
        if (t.tfs[i] > max_tf) max_tf = t.tfs[i];
      } else {
        block_docs[out] = -1;
        block_tfs[out] = 0.0f;
      }
    }
    term_max_tf[rank] = max_tf;
    for (size_t blk = 0; blk < nb; ++blk) {
      float bmax = 0.0f;
      int32_t dmax = 0;
      for (size_t i = blk * BLOCK; i < (blk + 1) * BLOCK && i < df; ++i) {
        if (t.tfs[i] > bmax) bmax = t.tfs[i];
        if (static_cast<int32_t>(t.docs[i]) > dmax)
          dmax = static_cast<int32_t>(t.docs[i]);
      }
      block_max_tf[block_cursor + blk] = bmax;
      block_last_doc[block_cursor + blk] = dmax;
      block_term[block_cursor + blk] = static_cast<int32_t>(rank);
    }
    block_cursor += nb;

    // positions CSR in posting order
    size_t data_cursor = 0;
    for (size_t p = 0; p < df; ++p) {
      const uint32_t len = p < t.pos_lens.size() ? t.pos_lens[p] : 0;
      for (uint32_t j = 0; j < len; ++j) {
        pos_values[pos_cursor + j] =
            static_cast<int32_t>(t.pos_data[data_cursor + j]);
      }
      data_cursor += len;
      pos_cursor += len;
      ++posting_cursor;
      pos_offsets[posting_cursor] = static_cast<int64_t>(pos_cursor);
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched query prep: tokenize a batch of plain term queries through the
// SAME analyzer chain as ingest (analyze_item above — identical tokens by
// construction), look each key up in the segment's sorted terms dictionary,
// and emit the per-query (slot, count) CSR that ops/impact.py's
// build_impact_batch produces — the host side of the headline batched
// search path (~30ms of Python per 1024-query batch collapses to ~1ms).
// Python computes weights (count x idf), q_nblk and slot metadata from the
// returned slot term-ids with numpy gathers. Replaces the reference's
// per-query planner front end (searchlite-core/src/query/wand.rs:459-566)
// for the batch API; the analyzer/dictionary behavior contract is
// api/reader.py::_analyze_batches + ops/impact.py::build_impact_batch,
// equivalence-fuzzed in tests/test_native_qprep.py.

namespace {

struct QueryPrep {
  std::string blob;                 // concatenated sorted term keys
  std::vector<int64_t> offs;        // [n_terms + 1]
  std::unordered_set<std::string> stopwords;
  std::unordered_map<std::string, int64_t> tid_cache;  // -1 = missing
};

// lower_bound over the key blob; exact match or -1. memcmp order over
// UTF-8 bytes == Python str order over code points.
int64_t qprep_lookup(QueryPrep& qp, const std::string& key) {
  auto hit = qp.tid_cache.find(key);
  if (hit != qp.tid_cache.end()) return hit->second;
  int64_t lo = 0, hi = static_cast<int64_t>(qp.offs.size()) - 1;
  while (lo < hi) {
    int64_t mid = (lo + hi) / 2;
    const char* t = qp.blob.data() + qp.offs[mid];
    size_t tlen = static_cast<size_t>(qp.offs[mid + 1] - qp.offs[mid]);
    int cmp = std::memcmp(t, key.data(), std::min(tlen, key.size()));
    if (cmp == 0) cmp = (tlen < key.size()) ? -1 : (tlen > key.size());
    if (cmp < 0)
      lo = mid + 1;
    else
      hi = mid;
  }
  int64_t tid = -1;
  if (lo < static_cast<int64_t>(qp.offs.size()) - 1) {
    size_t tlen = static_cast<size_t>(qp.offs[lo + 1] - qp.offs[lo]);
    if (tlen == key.size() &&
        std::memcmp(qp.blob.data() + qp.offs[lo], key.data(), tlen) == 0)
      tid = lo;
  }
  qp.tid_cache.emplace(key, tid);
  return tid;
}

}  // namespace

extern "C" {

void* slt_qprep_new(const char* terms_blob, int64_t blob_len,
                    const int64_t* offs, int64_t n_terms) {
  auto* qp = new QueryPrep();
  qp->blob.assign(terms_blob, static_cast<size_t>(blob_len));
  qp->offs.assign(offs, offs + n_terms + 1);
  return qp;
}

void slt_qprep_stopword(void* h, const char* w, int len) {
  static_cast<QueryPrep*>(h)->stopwords.emplace(
      w, static_cast<size_t>(len));
}

void slt_qprep_free(void* h) { delete static_cast<QueryPrep*>(h); }

// Returns 0 on success, -1 when a query needs the Python path (phrase /
// field-prefix / negation syntax, or non-ASCII under the default
// tokenizer), -2 when an output capacity would overflow. field_flags per
// field: bit0 = stopwords, bit1 = stem, bit2 = unicode tokenizer.
int64_t slt_qprep_batch(void* h, const char* qblob, const int64_t* q_off,
                        int64_t n_queries, const char* fields_blob,
                        const int64_t* f_off, int32_t n_fields,
                        const uint8_t* field_flags, int64_t* qs_start,
                        int32_t* qs_slot, int32_t* qs_cnt, int64_t cap,
                        int64_t* slot_tids, int64_t* out_counts) {
  auto* qp = static_cast<QueryPrep*>(h);
  bool all_unicode = true;
  for (int32_t f = 0; f < n_fields; ++f)
    if (!(field_flags[f] & 4u)) all_unicode = false;
  std::unordered_map<int64_t, int32_t> slot_of;
  int64_t n_entries = 0, n_slots = 0;
  std::vector<std::pair<int32_t, int32_t>> row;  // (slot, count)
  std::string key;
  qs_start[0] = 0;
  for (int64_t qi = 0; qi < n_queries; ++qi) {
    const char* text = qblob + q_off[qi];
    const int64_t tlen = q_off[qi + 1] - q_off[qi];
    for (int64_t i = 0; i < tlen; ++i) {
      const unsigned char c = static_cast<unsigned char>(text[i]);
      if (c == '"' || c == ':' || c == '-') return -1;
      if (c >= 0x80 && !all_unicode) return -1;
    }
    row.clear();
    bool overflow = false;
    // whitespace pieces OUTER, fields INNER — matching the Python
    // fast path's `for tok in raw.split(): for field in fields`, so
    // slot first-appearance order (and with it the f32 summation
    // order of the scoring matmul) is identical across both paths
    int64_t piece_start = 0;
    for (int64_t i = 0; i <= tlen; ++i) {
      const bool ws =
          i == tlen || text[i] == ' ' || text[i] == '\t' ||
          text[i] == '\n' || text[i] == '\r' || text[i] == '\f' ||
          text[i] == '\v';
      if (!ws) continue;
      const char* piece = text + piece_start;
      const int64_t plen_piece = i - piece_start;
      piece_start = i + 1;
      if (plen_piece == 0) continue;
      for (int32_t f = 0; f < n_fields; ++f) {
      const char* pfx = fields_blob + f_off[f];
      const size_t plen = static_cast<size_t>(f_off[f + 1] - f_off[f]);
      const bool use_stop = field_flags[f] & 1u;
      const bool use_stem = field_flags[f] & 2u;
      const bool use_unicode = field_flags[f] & 4u;
      uint32_t max_pos = 0;
      analyze_item(qp->stopwords, piece, plen_piece, pfx, plen,
                   use_stop, use_stem, use_unicode, &max_pos,
                   [&](const std::string& k, uint64_t, uint32_t) {
                     const int64_t tid = qprep_lookup(*qp, k);
                     if (tid < 0) return;
                     auto it = slot_of.find(tid);
                     int32_t slot;
                     if (it == slot_of.end()) {
                       if (n_slots >= cap) {
                         overflow = true;
                         return;
                       }
                       slot = static_cast<int32_t>(n_slots);
                       slot_of.emplace(tid, slot);
                       slot_tids[n_slots++] = tid;
                     } else {
                       slot = it->second;
                     }
                     for (auto& e : row)
                       if (e.first == slot) {
                         ++e.second;
                         return;
                       }
                     row.emplace_back(slot, 1);
                   });
      }
    }
    if (overflow ||
        n_entries + static_cast<int64_t>(row.size()) > cap)
      return -2;
    std::sort(row.begin(), row.end());
    for (const auto& e : row) {
      qs_slot[n_entries] = e.first;
      qs_cnt[n_entries] = e.second;
      ++n_entries;
    }
    qs_start[qi + 1] = n_entries;
  }
  out_counts[0] = n_entries;
  out_counts[1] = n_slots;
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Device-segment impact precomputation (device/index.py::DeviceSegment).
//
// One pass over the [n_rows, 128] posting blocks replaces the numpy
// pipeline that dominated reader-open time at scale (~15 full-array
// passes with temporaries; measured 89 s of 121 s reader open at 1M
// docs, 413 s at 5M). Semantics are bit-identical to the numpy
// expressions (plain SSE2 float ops, no FMA contraction — the build
// passes no -march/-mfma):
//
//   norm   = avg > 0 ? dl / avg : 1
//   denom  = max(tf + k1*((1-b) + b*norm), 1e-6)
//   impact = tf * (k1+1) / denom
//
// Outputs, mirroring the numpy layout exactly:
//   bd_out      [(n_rows+1)*128] block docs with pads -> n_docs, plus
//               an all-sentinel trailing row
//   bi_out      [(n_rows+1)*128] per-posting impacts (pads 0) plus a
//               zero trailing row
//   block_max   [n_rows]        per-row max impact
//   docs_flat   [n_post]        pad-stripped doc ordinals, row order
//   impacts_flat[n_post]        matching impacts
// Returns the number of flat postings written (== sum(term_df)).

extern "C" int64_t slt_impacts(
    const int32_t* block_docs, int64_t n_rows,
    const int32_t* row_field, const float* block_tfs,
    const float* doc_len, int64_t n1, const float* avgdl,
    double k1, double b, int32_t n_docs,
    int32_t* bd_out, float* bi_out, float* block_max,
    int32_t* docs_flat, float* impacts_flat) {
  const float bb = static_cast<float>(b);
  const float one_minus_b = static_cast<float>(1.0 - b);
  const float k1f = static_cast<float>(k1);
  const float k1p1 = static_cast<float>(k1 + 1.0);
  int64_t n_flat = 0;
  for (int64_t r = 0; r < n_rows; ++r) {
    const int32_t* drow = block_docs + r * 128;
    const float* trow = block_tfs + r * 128;
    int32_t* od = bd_out + r * 128;
    float* oi = bi_out + r * 128;
    const float* dl_tbl = doc_len + static_cast<int64_t>(row_field[r]) * n1;
    const float avg = avgdl[row_field[r]];
    float rmax = 0.0f;
    if (avg > 0.0f) {
      // the doc-length gathers are the bound (random-ish strides over
      // a multi-MB table; ~one DRAM latency each without prefetch)
      const int32_t* dnext = (r + 1 < n_rows) ? drow + 128 : drow;
      for (int i = 0; i < 16; ++i) {
        const int32_t p = drow[i];
        __builtin_prefetch(dl_tbl + (p >= 0 ? p : 0));
      }
      for (int i = 0; i < 128; ++i) {
        const int32_t pf =
            (i + 16 < 128) ? drow[i + 16] : dnext[i - 112];
        __builtin_prefetch(dl_tbl + (pf >= 0 ? pf : 0));
        const int32_t d = drow[i];
        if (d < 0) {
          od[i] = n_docs;
          oi[i] = 0.0f;
          continue;
        }
        const float tf = trow[i];
        const float norm = dl_tbl[d] / avg;
        float denom = tf + k1f * (one_minus_b + bb * norm);
        if (!(denom > 1e-6f)) denom = 1e-6f;
        const float imp = tf * k1p1 / denom;
        od[i] = d;
        oi[i] = imp;
        if (imp > rmax) rmax = imp;
        docs_flat[n_flat] = d;
        impacts_flat[n_flat] = imp;
        ++n_flat;
      }
    } else {
      for (int i = 0; i < 128; ++i) {
        const int32_t d = drow[i];
        if (d < 0) {
          od[i] = n_docs;
          oi[i] = 0.0f;
          continue;
        }
        const float tf = trow[i];
        float denom = tf + k1f * (one_minus_b + bb);  // norm = 1
        if (!(denom > 1e-6f)) denom = 1e-6f;
        const float imp = tf * k1p1 / denom;
        od[i] = d;
        oi[i] = imp;
        if (imp > rmax) rmax = imp;
        docs_flat[n_flat] = d;
        impacts_flat[n_flat] = imp;
        ++n_flat;
      }
    }
    block_max[r] = rmax;
  }
  // trailing sentinel row: docs -> n_docs, impacts -> 0
  int32_t* od = bd_out + n_rows * 128;
  float* oi = bi_out + n_rows * 128;
  for (int i = 0; i < 128; ++i) {
    od[i] = n_docs;
    oi[i] = 0.0f;
  }
  return n_flat;
}
