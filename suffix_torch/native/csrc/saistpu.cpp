// Native host-side components: linear-time suffix array (SA-IS) and
// Kasai LCP over raw bytes.
//
// Role in the framework (SURVEY.md §2): a fast CPU oracle for conformance
// testing at corpus scale, and the single-core CPU baseline that the TPU
// engines are measured against. This is a from-scratch implementation of
// the SA-IS algorithm (Nong, Zhang & Chan, 2009) using the conventional
// explicit-sentinel formulation; the suffix array of a text is unique, so
// its output matches the reference crate (src/table.rs:388-574, which uses
// a sentinel-free variant) byte for byte.
//
// Build: g++ -O3 -march=native -shared -fPIC saistpu.cpp -o libsaistpu.so

#include <cstdint>
#include <cstring>
#include <vector>

#include "bounds_core.h"
#include "sais_core.h"



extern "C" {

// Suffix array of `text` (byte-lexicographic, NO sentinel in the output).
// Returns 0 on success.
int stpu_sais_u8(const uint8_t* text, uint32_t n, uint32_t* out_sa) {
  stpu::sais_u8(text, n, out_sa);
  return 0;
}

// Kasai LCP: lcp[0] = 0, lcp[r] = lcp_len(suffix[sa[r-1]], suffix[sa[r]]).
void stpu_kasai_u8(const uint8_t* text, const uint32_t* sa, uint32_t n,
                   uint32_t* out_lcp) {
  if (n == 0) return;
  std::vector<uint32_t> rank(n);
  for (uint32_t r = 0; r < n; r++) rank[sa[r]] = r;
  uint32_t h = 0;
  for (uint32_t i = 0; i < n; i++) {
    uint32_t r = rank[i];
    if (r == 0) {
      h = 0;
      out_lcp[0] = 0;
      continue;
    }
    uint32_t j = sa[r - 1];
    while (i + h < n && j + h < n && text[i + h] == text[j + h]) h++;
    out_lcp[r] = h;
    if (h > 0) h--;
  }
}

// Batched binary-search queries: for each query, find (start, count) rank
// bounds in the suffix array — the CPU reference path for the batched
// device query engine (same semantics as src/table.rs:223-259).
void stpu_bounds_batch(const uint8_t* text, uint32_t n, const uint32_t* sa,
                       const uint8_t* queries, const uint32_t* q_offsets,
                       uint32_t n_queries, uint32_t* out_start,
                       uint32_t* out_count) {
  for (uint32_t q = 0; q < n_queries; q++) {
    const uint8_t* qs = queries + q_offsets[q];
    const uint32_t qlen = q_offsets[q + 1] - q_offsets[q];
    stpu::bounds_core(text, n, sa, qs, qlen, out_start + q, out_count + q);
  }
}

// Single-query fast path: identical semantics to stpu_bounds_batch with
// one query, but a flat signature so the Python side can call it with
// cached ctypes arguments and no per-call array marshalling.
// out[0] = start, out[1] = count.
void stpu_bounds_one(const uint8_t* text, uint32_t n, const uint32_t* sa,
                     const uint8_t* q, uint32_t qlen, uint32_t* out) {
  uint32_t offsets[2] = {0, qlen};
  stpu_bounds_batch(text, n, sa, q, offsets, 1, out, out + 1);
}

}  // extern "C"
