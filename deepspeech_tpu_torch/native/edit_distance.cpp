// Levenshtein edit distance over uint32 token sequences.
//
// In-tree replacement for the reference's python-Levenshtein C extension
// (reference decoder.py:18,62,73). Exposed via a C ABI and loaded with ctypes;
// tokens are uint32 so the same routine serves both character-level CER and
// the word->token-mapped WER trick (reference decoder.py:53-62).
//
// A copy of the JAX package's native/edit_distance.cpp, built with the other
// sources by deepspeech_tpu_torch/native/__init__.py.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Classic two-row DP. Returns the edit distance between a[0..na) and b[0..nb).
int64_t edit_distance_u32(const uint32_t* a, int64_t na,
                          const uint32_t* b, int64_t nb) {
  if (na == 0) return nb;
  if (nb == 0) return na;
  // Iterate over the shorter sequence in the inner loop for cache friendliness.
  if (nb > na) {
    std::swap(a, b);
    std::swap(na, nb);
  }
  std::vector<int64_t> row(nb + 1);
  for (int64_t j = 0; j <= nb; ++j) row[j] = j;
  for (int64_t i = 1; i <= na; ++i) {
    int64_t prev_diag = row[0];  // D[i-1][0]
    row[0] = i;
    const uint32_t ai = a[i - 1];
    for (int64_t j = 1; j <= nb; ++j) {
      const int64_t prev_row = row[j];  // D[i-1][j]
      int64_t cost = prev_diag + (ai != b[j - 1]);
      cost = std::min(cost, prev_row + 1);
      cost = std::min(cost, row[j - 1] + 1);
      prev_diag = prev_row;
      row[j] = cost;
    }
  }
  return row[nb];
}

// Batched variant: sequences packed back to back with offset tables, writing
// one distance per pair. Lets the host compute a whole batch of CER/WER with
// one FFI crossing.
void edit_distance_u32_batch(const uint32_t* a, const int64_t* a_off,
                             const uint32_t* b, const int64_t* b_off,
                             int64_t n_pairs, int64_t* out) {
  for (int64_t i = 0; i < n_pairs; ++i) {
    out[i] = edit_distance_u32(a + a_off[i], a_off[i + 1] - a_off[i],
                               b + b_off[i], b_off[i + 1] - b_off[i]);
  }
}

}  // extern "C"
