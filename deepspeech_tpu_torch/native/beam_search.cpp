// CTC prefix beam search with optional ARPA n-gram LM fusion.
//
// Native replacement for the reference's `ctcdecode.CTCBeamDecoder` C++
// extension and its KenLM scorer (reference decoder.py:90-143, opts.py:1-16).
// Semantics are parity-exact with the in-tree Python implementation
// (deepspeech_tpu_torch/decoders/beam.py `ctc_beam_search` and decoders/lm.py
// `ArpaLM.score_word`) so either backend can serve the same decode, and the
// test suite asserts bit-equality between them.
//
// Design notes (why it is fast where the Python one is not):
//   * prefixes live in a trie keyed by (parent, char) so prefix identity is
//     content-based and extension/merge is O(1) hash lookup — no tuple
//     hashing of ever-growing prefixes;
//   * per-beam offset lists and completed-word histories are immutable
//     parent-pointer chains in arenas (the C++ analogue of Python's shared
//     tuples) — no copying on extension;
//   * everything is double precision, same log-space formulas, so results
//     match the numpy path to the last bit on identical inputs.
//
// Exposed via a C ABI and loaded with ctypes
// (deepspeech_tpu_torch/native/__init__.py). A copy of the JAX package's
// native/beam_search.cpp.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kNegInf = -std::numeric_limits<double>::infinity();
const double kLn10 = std::log(10.0);

inline double log_add(double a, double b) {
  // Same formula as beam.py:_logaddexp for bit-parity.
  if (a == kNegInf) return b;
  if (b == kNegInf) return a;
  const double m = a > b ? a : b;
  return m + std::log1p(std::exp(-std::fabs(a - b)));
}

// ---------------------------------------------------------------------------
// ARPA n-gram LM (decoders/lm.py parity: the backoff weights of the
// successive shortened contexts ACCUMULATE, as in ARPA/KenLM semantics; the
// JAX package's copy of this file adds only the most recent one, which
// differs from its Python ArpaLM wherever a context of two or more words
// backs off).
// ---------------------------------------------------------------------------

struct ArpaLM {
  // n-gram (words joined by ' ') -> (log10 prob, backoff weight)
  std::unordered_map<std::string, std::pair<double, double>> ngrams;
  int order = 0;
  bool has_unk = false;
  double unk_logp = -10.0;

  const std::pair<double, double>* find(const std::string& key) const {
    auto it = ngrams.find(key);
    return it == ngrams.end() ? nullptr : &it->second;
  }

  static std::string join(const std::vector<std::string>& ctx, size_t begin,
                          const std::string* word) {
    std::string key;
    for (size_t i = begin; i < ctx.size(); ++i) {
      if (!key.empty()) key.push_back(' ');
      key += ctx[i];
    }
    if (word) {
      if (!key.empty()) key.push_back(' ');
      key += *word;
    }
    return key;
  }

  // log10 P(word | context) with Katz backoff; the context is truncated to
  // the last (order-1) words (none at order 1), exactly like
  // lm.py:score_word, and the penalty sums in the same order.
  double score_word(const std::vector<std::string>& context,
                    const std::string& word) const {
    size_t begin = context.size();
    if (order > 1 && context.size() > static_cast<size_t>(order - 1))
      begin = context.size() - static_cast<size_t>(order - 1);
    else if (order > 1)
      begin = 0;
    double penalty = 0.0;
    while (true) {
      if (const auto* e = find(join(context, begin, &word)))
        return penalty + e->first;
      if (begin >= context.size()) return penalty + unk_logp;
      // back off: add the context's backoff weight, shorten the context
      if (const auto* bo = find(join(context, begin, nullptr)))
        penalty += bo->second;
      ++begin;
    }
  }
};

ArpaLM* parse_arpa(const char* data, int64_t len) {
  ArpaLM* lm = new ArpaLM();
  const char* p = data;
  const char* end = data + len;
  int section = 0;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* line_end = nl ? nl : end;
    // strip() both sides
    const char* s = p;
    const char* e = line_end;
    while (s < e && (*s == ' ' || *s == '\t' || *s == '\r')) ++s;
    while (e > s && (e[-1] == ' ' || e[-1] == '\t' || e[-1] == '\r')) --e;
    p = nl ? nl + 1 : end;
    if (s == e) continue;
    std::string line(s, e);
    if (line[0] == '\\' && line.find("-grams:") != std::string::npos) {
      section = std::atoi(line.c_str() + 1);
      if (section > lm->order) lm->order = section;
      continue;
    }
    if (line[0] == '\\' || line.rfind("ngram ", 0) == 0) continue;
    // "logp\twords[\tbackoff]" — tab-separated, like lm.py:36.
    size_t t1 = line.find('\t');
    if (t1 == std::string::npos || section == 0) continue;
    size_t t2 = line.find('\t', t1 + 1);
    const double logp = std::atof(line.substr(0, t1).c_str());
    std::string words = t2 == std::string::npos
                            ? line.substr(t1 + 1)
                            : line.substr(t1 + 1, t2 - t1 - 1);
    const double backoff =
        t2 == std::string::npos ? 0.0 : std::atof(line.substr(t2 + 1).c_str());
    // normalize internal whitespace to single spaces (tuple(split()) parity)
    std::string key;
    for (size_t i = 0; i < words.size();) {
      if (words[i] == ' ') {
        while (i < words.size() && words[i] == ' ') ++i;
        if (i < words.size() && !key.empty()) key.push_back(' ');
      } else {
        key.push_back(words[i++]);
      }
    }
    if (key.empty()) continue;
    lm->ngrams[key] = {logp, backoff};
  }
  if (const auto* unk = lm->find("<unk>")) {
    lm->has_unk = true;
    lm->unk_logp = unk->first;
  }
  return lm;
}

// ---------------------------------------------------------------------------
// Beam search
// ---------------------------------------------------------------------------

struct TrieNode {
  int32_t parent;  // -1 for root
  int32_t ch;
  int32_t depth;
};

struct OffsetNode {
  int32_t parent;  // -1 for empty
  int32_t t;
};

struct WordNode {
  int32_t parent;  // -1 for no completed words yet
  int32_t depth;
  std::string word;
};

struct Beam {
  int32_t node;     // trie node (prefix identity)
  double p_b;       // log P(prefix, ending in blank)
  double p_nb;      // log P(prefix, ending in non-blank)
  int32_t off;      // offsets chain head (-1 = empty)
  int32_t words;    // completed-words chain head (-1 = none)
  std::string partial;  // current partial word (LM mode only)
  double total;     // cached log_add(p_b, p_nb) for sorting
};

struct Decoder {
  std::vector<TrieNode> trie;
  std::unordered_map<int64_t, int32_t> children;  // parent*C+ch -> node
  std::vector<OffsetNode> offsets;
  std::vector<WordNode> words;

  int64_t C;

  explicit Decoder(int64_t num_classes) : C(num_classes) {
    trie.push_back({-1, -1, 0});  // root = empty prefix
  }

  int32_t child(int32_t parent, int32_t ch) {
    const int64_t key = static_cast<int64_t>(parent) * C + ch;
    auto it = children.find(key);
    if (it != children.end()) return it->second;
    const int32_t id = static_cast<int32_t>(trie.size());
    trie.push_back({parent, ch, trie[parent].depth + 1});
    children.emplace(key, id);
    return id;
  }

  int32_t push_offset(int32_t head, int32_t t) {
    offsets.push_back({head, t});
    return static_cast<int32_t>(offsets.size() - 1);
  }

  int32_t push_word(int32_t head, std::string w) {
    const int32_t depth = head < 0 ? 1 : words[head].depth + 1;
    words.push_back({head, depth, std::move(w)});
    return static_cast<int32_t>(words.size() - 1);
  }

  // Last (order-1) of ("<s>" + completed words), oldest first; none for a
  // unigram LM.
  std::vector<std::string> lm_context(int32_t words_head, int order) const {
    const int need = order > 1 ? order - 1 : 0;
    std::vector<std::string> ctx;
    int32_t n = words_head;
    while (n >= 0 && static_cast<int>(ctx.size()) < need) {
      ctx.push_back(words[n].word);
      n = words[n].parent;
    }
    if (n < 0 && static_cast<int>(ctx.size()) < need) ctx.push_back("<s>");
    std::reverse(ctx.begin(), ctx.end());
    return ctx;
  }
};

}  // namespace

extern "C" {

void* bs_lm_load(const char* data, int64_t len) { return parse_arpa(data, len); }

void bs_lm_free(void* lm) { delete static_cast<ArpaLM*>(lm); }

int32_t bs_lm_order(void* lm) { return static_cast<ArpaLM*>(lm)->order; }

// context: space-separated words ("" = empty context). For tests.
double bs_lm_score_word(void* lm_ptr, const char* context, const char* word) {
  const ArpaLM* lm = static_cast<ArpaLM*>(lm_ptr);
  std::vector<std::string> ctx;
  std::string tok;
  for (const char* p = context; *p; ++p) {
    if (*p == ' ') {
      if (!tok.empty()) ctx.push_back(tok);
      tok.clear();
    } else {
      tok.push_back(*p);
    }
  }
  if (!tok.empty()) ctx.push_back(tok);
  return lm->score_word(std::move(ctx), word);
}

// Decode one utterance.
//   log_probs: (T, C) row-major float64 log posteriors.
//   labels_nl: newline-separated UTF-8 label strings per class id (used only
//              to build words for LM lookup; may be NULL when lm is NULL).
//   out_ids / out_offsets: caller buffers of top_paths*T int32.
//   out_lens: top_paths int32; out_scores: top_paths float64.
// Returns the number of hypotheses written (<= top_paths).
int32_t bs_decode(const double* log_probs, int64_t T, int64_t C,
                  int32_t blank, int32_t space_index, int32_t beam_width,
                  int32_t cutoff_top_n, double cutoff_prob, void* lm_ptr,
                  double alpha, double beta, const char* labels_nl,
                  int32_t top_paths, int32_t* out_ids, int32_t* out_offsets,
                  int32_t* out_lens, double* out_scores) {
  const ArpaLM* lm = static_cast<ArpaLM*>(lm_ptr);

  // Per-class label strings for LM word building.
  std::vector<std::string> labels;
  if (labels_nl) {
    std::string all(labels_nl);
    size_t start = 0;
    while (start <= all.size()) {
      size_t nl = all.find('\n', start);
      if (nl == std::string::npos) {
        labels.push_back(all.substr(start));
        break;
      }
      labels.push_back(all.substr(start, nl - start));
      start = nl + 1;
    }
  }
  labels.resize(C);

  Decoder dec(C);
  std::vector<Beam> beams;
  beams.push_back({0, 0.0, kNegInf, -1, -1, std::string(), 0.0});

  // alpha * log10 P(word|ctx) * ln10 + beta when a word completes
  // (beam.py:lm_word_bonus).
  auto word_bonus = [&](const Beam& b, int32_t* new_words) -> double {
    if (b.partial.empty()) {
      *new_words = b.words;
      return 0.0;
    }
    const double s =
        alpha * lm->score_word(dec.lm_context(b.words, lm->order), b.partial) *
            kLn10 +
        beta;
    *new_words = dec.push_word(b.words, b.partial);
    return s;
  };

  std::vector<int32_t> order_buf(C);
  std::vector<Beam> next;
  std::unordered_map<int32_t, int32_t> next_index;  // trie node -> next[] slot

  for (int64_t t = 0; t < T; ++t) {
    const double* lp = log_probs + t * C;

    // Candidate pruning: descending sort, optional cumulative-prob cutoff,
    // then top cutoff_top_n (beam.py:70-75).
    for (int64_t c = 0; c < C; ++c) order_buf[c] = static_cast<int32_t>(c);
    std::stable_sort(order_buf.begin(), order_buf.end(),
                     [&](int32_t a, int32_t b) { return lp[a] > lp[b]; });
    int64_t n_cand = C;
    if (cutoff_prob < 1.0) {
      double cum = 0.0;
      int64_t below = 0;  // np.searchsorted(cum, cutoff_prob, side='left')
      for (int64_t i = 0; i < C; ++i) {
        cum += std::exp(lp[order_buf[i]]);
        if (cum < cutoff_prob) ++below;
      }
      n_cand = std::min<int64_t>(C, below + 1);
    }
    n_cand = std::min<int64_t>(n_cand, cutoff_top_n);

    next.clear();
    next_index.clear();

    // First-insert wins for offsets / LM state (Python dict semantics):
    // beams are iterated in their stored (stable-sorted) order.
    auto bump = [&](int32_t node, int which, double value, int32_t off,
                    int32_t words_head, const std::string& partial) {
      auto it = next_index.find(node);
      Beam* e;
      if (it == next_index.end()) {
        next_index.emplace(node, static_cast<int32_t>(next.size()));
        next.push_back({node, kNegInf, kNegInf, off, words_head, partial, 0.0});
        e = &next.back();
      } else {
        e = &next[it->second];
      }
      double& slot = which == 0 ? e->p_b : e->p_nb;
      slot = log_add(slot, value);
    };

    for (const Beam& b : beams) {
      const double total = log_add(b.p_b, b.p_nb);
      const int32_t last = dec.trie[b.node].ch;  // -1 at root
      for (int64_t ci = 0; ci < n_cand; ++ci) {
        const int32_t c = order_buf[ci];
        const double p_c = lp[c];
        if (c == blank) {
          bump(b.node, 0, total + p_c, b.off, b.words, b.partial);
        } else if (c == last) {
          bump(b.node, 1, b.p_nb + p_c, b.off, b.words, b.partial);
          if (b.p_b != kNegInf) {
            // blank intervened: the repeat extends the prefix
            double bonus = 0.0;
            int32_t new_words = b.words;
            std::string new_partial = b.partial;
            if (lm) {
              if (c == space_index) {
                bonus = word_bonus(b, &new_words);
                new_partial.clear();
              } else {
                new_partial += labels[c];
              }
            }
            bump(dec.child(b.node, c), 1, b.p_b + p_c + bonus,
                 dec.push_offset(b.off, static_cast<int32_t>(t)), new_words,
                 new_partial);
          }
        } else {
          double bonus = 0.0;
          int32_t new_words = b.words;
          std::string new_partial = b.partial;
          if (lm) {
            if (c == space_index) {
              bonus = word_bonus(b, &new_words);
              new_partial.clear();
            } else {
              new_partial += labels[c];
            }
          }
          bump(dec.child(b.node, c), 1, total + p_c + bonus,
               dec.push_offset(b.off, static_cast<int32_t>(t)), new_words,
               new_partial);
        }
      }
    }

    // Keep top beam_width prefixes by merged probability (stable sort ==
    // Python sorted() on insertion-ordered dict).
    for (Beam& b : next) b.total = log_add(b.p_b, b.p_nb);
    std::stable_sort(next.begin(), next.end(),
                     [](const Beam& a, const Beam& b) { return a.total > b.total; });
    if (static_cast<int64_t>(next.size()) > beam_width) next.resize(beam_width);
    beams.swap(next);
  }

  // Final scoring: flush any partial word through the LM (beam.py:126-131).
  for (Beam& b : beams) {
    b.total = log_add(b.p_b, b.p_nb);
    if (lm && !b.partial.empty()) {
      int32_t ignored;
      b.total += word_bonus(b, &ignored);
    }
  }
  std::stable_sort(beams.begin(), beams.end(),
                   [](const Beam& a, const Beam& b) { return a.total > b.total; });

  const int32_t n_out =
      static_cast<int32_t>(std::min<int64_t>(beams.size(), top_paths));
  for (int32_t k = 0; k < n_out; ++k) {
    const Beam& b = beams[k];
    const int32_t len = dec.trie[b.node].depth;
    out_lens[k] = len;
    out_scores[k] = b.total;
    int32_t* ids = out_ids + static_cast<int64_t>(k) * T;
    int32_t* offs = out_offsets + static_cast<int64_t>(k) * T;
    int32_t node = b.node;
    for (int32_t i = len - 1; i >= 0; --i) {
      ids[i] = dec.trie[node].ch;
      node = dec.trie[node].parent;
    }
    int32_t off = b.off;
    for (int32_t i = len - 1; i >= 0; --i) {
      offs[i] = dec.offsets[off].t;
      off = dec.offsets[off].parent;
    }
  }
  return n_out;
}

}  // extern "C"
