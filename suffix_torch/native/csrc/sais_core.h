// Shared SA-IS core, used by both the ctypes library (saistpu.cpp) and
// the CPython extension (fastpath.cpp) so the two paths cannot diverge.
//
// From-scratch implementation of the SA-IS algorithm (Nong, Zhang & Chan,
// 2009) using the conventional explicit-sentinel formulation; the suffix
// array of a text is unique, so its output matches the reference crate
// (src/table.rs:388-574, a sentinel-free variant) byte for byte.
#ifndef SUFFIX_TPU_SAIS_CORE_H_
#define SUFFIX_TPU_SAIS_CORE_H_

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace stpu {

// Generic SA-IS over an integer alphabet [0, sigma). The input sequence
// `s` must end with a unique smallest sentinel (value 0) at s[n-1].
// Writes the suffix array of s (including the sentinel suffix) to sa.
inline void sais_core(const std::vector<uint32_t>& s, uint32_t sigma,
                      std::vector<uint32_t>& sa) {
  const size_t n = s.size();
  sa.assign(n, 0);
  if (n == 1) {
    sa[0] = 0;
    return;
  }

  // Types: true = S-type (suffix smaller than its right neighbor).
  std::vector<bool> is_s(n);
  is_s[n - 1] = true;
  for (size_t i = n - 1; i-- > 0;) {
    is_s[i] = (s[i] < s[i + 1]) || (s[i] == s[i + 1] && is_s[i + 1]);
  }
  auto is_lms = [&](size_t i) { return i > 0 && is_s[i] && !is_s[i - 1]; };

  std::vector<uint32_t> bucket(sigma, 0);
  for (size_t i = 0; i < n; i++) bucket[s[i]]++;

  std::vector<uint32_t> heads(sigma), tails(sigma);
  auto reset_ptrs = [&]() {
    uint32_t sum = 0;
    for (uint32_t c = 0; c < sigma; c++) {
      heads[c] = sum;
      sum += bucket[c];
      tails[c] = sum;  // exclusive end; insert with --tails[c]
    }
  };

  const uint32_t EMPTY = UINT32_MAX;

  // Induced sort: seed with the given LMS positions (in the order
  // provided, inserted from bucket tails), then induce L left-to-right
  // and S right-to-left.
  auto induce = [&](const std::vector<uint32_t>& lms_seed) {
    std::fill(sa.begin(), sa.end(), EMPTY);
    reset_ptrs();
    for (size_t j = lms_seed.size(); j-- > 0;) {
      uint32_t i = lms_seed[j];
      sa[--tails[s[i]]] = i;
    }
    for (size_t k = 0; k < n; k++) {
      uint32_t i = sa[k];
      if (i != EMPTY && i > 0 && !is_s[i - 1]) {
        sa[heads[s[i - 1]]++] = i - 1;
      }
    }
    reset_ptrs();
    for (size_t k = n; k-- > 0;) {
      uint32_t i = sa[k];
      if (i != EMPTY && i > 0 && is_s[i - 1]) {
        sa[--tails[s[i - 1]]] = i - 1;
      }
    }
  };

  // Pass 1: approximate — seed with LMS positions in text order.
  std::vector<uint32_t> lms;
  lms.reserve(n / 2);
  for (size_t i = 1; i < n; i++) {
    if (is_lms(i)) lms.push_back(static_cast<uint32_t>(i));
  }
  induce(lms);

  // Name LMS substrings in the sorted order they appear in sa.
  const size_t m = lms.size();
  if (m > 0) {
    std::vector<uint32_t> sorted_lms;
    sorted_lms.reserve(m);
    for (size_t k = 0; k < n; k++) {
      uint32_t i = sa[k];
      if (i != EMPTY && i > 0 && is_lms(i)) sorted_lms.push_back(i);
    }

    std::vector<uint32_t> name_of(n, EMPTY);
    uint32_t names = 0;
    uint32_t prev = EMPTY;
    for (uint32_t i : sorted_lms) {
      if (prev == EMPTY) {
        names = 1;
      } else {
        // Compare the two LMS substrings (inclusive of both endpoints).
        size_t a = prev, b = i;
        bool differ = false;
        while (true) {
          if (s[a] != s[b] || is_s[a] != is_s[b]) {
            differ = true;
            break;
          }
          a++;
          b++;
          bool a_end = is_lms(a), b_end = is_lms(b);
          if (a_end || b_end) {
            differ = !(a_end && b_end);
            break;
          }
        }
        if (differ) names++;
      }
      name_of[i] = names - 1;
      prev = i;
    }

    if (names < m) {
      // Recurse on the reduced string of LMS names (text order). No
      // appended sentinel needed: the final LMS position is the
      // sentinel itself (smallest, unique), acting as the sentinel of
      // the reduced problem.
      std::vector<uint32_t> reduced;
      reduced.reserve(m);
      for (uint32_t i : lms) reduced.push_back(name_of[i]);
      std::vector<uint32_t> sub_sa;
      sais_core(reduced, names, sub_sa);
      std::vector<uint32_t> ordered(m);
      for (size_t k = 0; k < m; k++) ordered[k] = lms[sub_sa[k]];
      induce(ordered);
    } else {
      induce(sorted_lms);
    }
  }
}

// Small-text direct path: binary-insertion sort of suffix offsets with
// memcmp suffix compares. The suffix array is the unique byte-lex order
// (shorter proper-prefix suffix first, matching src/table.rs:367-376's
// slice order), so this is bit-identical to the SA-IS path. For tiny n
// the O(n^2)-compare sort beats SA-IS's fixed alphabet-sized costs
// (5 x 257-entry bucket tables + their reset scans dominate an 11-byte
// build). Measured (scripts/small_crossover.cpp, this box): 181 ns vs
// 1,450 ns at n=11; random text crosses over near n=56 (2.6 vs 2.7 us
// at 48) but the all-equal-byte worst case crosses at 32 (1.54 vs
// 1.48 us), so the threshold stays at 32 where the adversarial loss is
// within noise.
inline constexpr uint32_t kSmallDirectMax = 32;

inline void small_sort_u8(const uint8_t* text, uint32_t n, uint32_t* sa) {
  for (uint32_t i = 0; i < n; i++) {
    const uint32_t la = n - i;
    uint32_t j = i;
    while (j > 0) {
      const uint32_t b = sa[j - 1];
      const uint32_t lb = n - b;
      const uint32_t m = la < lb ? la : lb;
      const int c = std::memcmp(text + i, text + b, m);
      if (!(c < 0 || (c == 0 && la < lb))) break;
      sa[j] = b;
      --j;
    }
    sa[j] = i;
  }
}

// Suffix array of `text` (byte-lexicographic, NO sentinel in the output).
inline void sais_u8(const uint8_t* text, uint32_t n, uint32_t* out_sa) {
  if (n == 0) return;
  if (n <= kSmallDirectMax) {
    small_sort_u8(text, n, out_sa);
    return;
  }
  // Top-level scratch is thread-local so back-to-back builds (serving
  // many small documents) pay no allocation; recursion levels inside
  // sais_core still allocate, but only run for larger inputs where the
  // allocations are noise.
  thread_local std::vector<uint32_t> s;
  thread_local std::vector<uint32_t> sa;
  s.resize(static_cast<size_t>(n) + 1);
  for (uint32_t i = 0; i < n; i++) s[i] = static_cast<uint32_t>(text[i]) + 1;
  s[n] = 0;  // sentinel, strictly smallest
  sais_core(s, 257, sa);
  // sa[0] is the sentinel suffix; drop it.
  std::memcpy(out_sa, sa.data() + 1, sizeof(uint32_t) * n);
}

// The reference's naive oracle in C: sort suffix offsets with full
// byte-slice comparison (src/table.rs:367-376: fill 0..n, sort by
// suffix). O(n^2 log n) worst case; the second, independent oracle.
inline void naive_u8(const uint8_t* text, uint32_t n, uint32_t* out_sa) {
  std::iota(out_sa, out_sa + n, 0u);
  std::sort(out_sa, out_sa + n, [&](uint32_t a, uint32_t b) {
    uint32_t la = n - a, lb = n - b;
    uint32_t m = la < lb ? la : lb;
    int c = std::memcmp(text + a, text + b, m);
    if (c != 0) return c < 0;
    return la < lb;  // shorter suffix (a proper prefix) sorts first
  });
}

}  // namespace stpu

#endif  // SUFFIX_TPU_SAIS_CORE_H_
