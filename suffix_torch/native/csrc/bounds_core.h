// Shared core of the host-side query bounds search, used by both the
// ctypes library (saistpu.cpp) and the CPython extension (fastpath.cpp)
// so the two paths cannot diverge.
//
// Semantics mirror the reference's positions() (src/table.rs:223-259):
// lower bound = first rank whose suffix >= query (full comparison, a
// shorter suffix that is a prefix of the query compares below it);
// upper bound = first rank >= lower whose suffix does not start with the
// query. count = upper - lower. Empty queries match nothing.
#ifndef SUFFIX_TPU_BOUNDS_CORE_H_
#define SUFFIX_TPU_BOUNDS_CORE_H_

#include <cstdint>
#include <cstring>

namespace stpu {

inline void bounds_core(const uint8_t* text, uint32_t n, const uint32_t* sa,
                        const uint8_t* q, uint32_t qlen, uint32_t* out_start,
                        uint32_t* out_count) {
  if (qlen == 0 || n == 0) {
    *out_start = 0;
    *out_count = 0;
    return;
  }
  // Lower bound: first rank with suffix >= query (full comparison).
  uint32_t lo = 0, hi = n;
  while (lo < hi) {
    uint32_t mid = lo + (hi - lo) / 2;
    const uint8_t* suf = text + sa[mid];
    uint32_t avail = n - sa[mid];
    uint32_t cmp_len = avail < qlen ? avail : qlen;
    int c = std::memcmp(suf, q, cmp_len);
    bool suffix_lt = c < 0 || (c == 0 && avail < qlen);
    if (suffix_lt) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  uint32_t start = lo;
  // Upper bound: first rank >= start whose suffix does not start with q.
  hi = n;
  while (lo < hi) {
    uint32_t mid = lo + (hi - lo) / 2;
    const uint8_t* suf = text + sa[mid];
    uint32_t avail = n - sa[mid];
    bool starts_with = avail >= qlen && std::memcmp(suf, q, qlen) == 0;
    if (starts_with) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  *out_start = start;
  *out_count = lo - start;
}

// Existence-only test with early exit: the reference's contains() is
// any_position().is_some() (src/table.rs:197-199, 279-293) — a single
// binary_search_by that RETURNS as soon as a probe's suffix starts with
// the query, without locating the bounds. Matching that shape makes the
// common hit case O(few probes) instead of two full searches (published
// 8 ns for a 1-char hit vs 162 ns for positions, README.md:91-92).
// Result is boolean, so it cannot diverge from bounds_core's count > 0.
inline bool contains_core(const uint8_t* text, uint32_t n,
                          const uint32_t* sa, const uint8_t* q,
                          uint32_t qlen) {
  if (qlen == 0 || n == 0) return false;
  uint32_t lo = 0, hi = n;
  while (lo < hi) {
    uint32_t mid = lo + (hi - lo) / 2;
    const uint8_t* suf = text + sa[mid];
    uint32_t avail = n - sa[mid];
    uint32_t cmp_len = avail < qlen ? avail : qlen;
    int c = std::memcmp(suf, q, cmp_len);
    if (c == 0 && avail >= qlen) return true;  // suffix starts with q
    bool suffix_lt = c < 0 || (c == 0 && avail < qlen);
    if (suffix_lt) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return false;
}

}  // namespace stpu

#endif  // SUFFIX_TPU_BOUNDS_CORE_H_
