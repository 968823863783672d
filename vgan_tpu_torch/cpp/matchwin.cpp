// Copied from vgan_tpu/cpp/matchwin.cpp (unchanged below this line).
// RY-match window scanning (native).
//
// Exact twin of pipelines/keelime.py::_match_count_windows semantics
// (isSubset / findAlignmentPosition inner loops,
// src/assembly.cpp:1036-1097) with per-window early exit: a window's
// effective count is the full match count when total mismatches <=
// allowed, else the match count accumulated before the (allowed+1)-th
// mismatch — so the scan can stop at that mismatch, and also as soon
// as the remaining positions cannot reach the threshold. Random
// non-overlapping windows die after a handful of characters, turning
// the O(n*la) sliding-matrix pass into ~O(n).
//
// The 256x256 RY-match table is passed in from Python (the single
// source of truth lives in keelime._build_tables).
//
// Built into libgamcodec.so (see Makefile).

#include <cstdint>

extern "C" {

// Returns the number of windows whose effective match count reaches
// `thresh`, writing their start positions to out_hits (up to cap).
// first_only != 0 stops at the first hit.
int64_t ry_window_hits(
    const uint8_t* hay, int64_t nh,
    const uint8_t* needle, int64_t la,
    const uint8_t* match_tab,  // [256*256] 0/1
    int64_t allowed, int64_t thresh, int32_t first_only,
    int64_t* out_hits, int64_t cap) {
  int64_t n = nh - la + 1;
  int64_t found = 0;
  if (n <= 0 || la <= 0) return 0;
  for (int64_t s = 0; s < n; ++s) {
    int64_t m = 0, mm = 0;
    const uint8_t* h = hay + s;
    for (int64_t j = 0; j < la; ++j) {
      if (match_tab[(static_cast<int64_t>(h[j]) << 8) | needle[j]]) {
        ++m;
      } else if (++mm > allowed) {
        break;  // capped count = matches before this mismatch
      }
      // remaining positions cannot reach thresh
      if (m + (la - j - 1) < thresh) break;
    }
    if (m >= thresh) {
      if (found < cap) out_hits[found] = s;
      ++found;
      if (first_only) return found;
    }
  }
  return found;
}

}  // extern "C"
