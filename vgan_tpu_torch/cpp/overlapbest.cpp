// Copied from vgan_tpu/cpp/overlapbest.cpp (unchanged below this line).
// Suffix-prefix overlap scoring (native).
//
// Exact twin of pipelines/keelime.py::overlap_score
// (get_overlap_length_and_score, src/assembly.cpp:523-610): slide b
// along a from every start; overlap length at start s is
// min(len(b), len(a)-s); winner = largest olen with score >= min_score
// among olen >= min_olen, ties by score.
//
// The combined char-pair table holds multiples of 0.5 only
// (keelime._build_tables), so scores accumulate as int32 (table x 2)
// and divide by 2 at the end — bit-identical to the float64 numpy
// sums regardless of summation order.
//
// Full-length starts (olen == len(b)) all tie on length, so their
// block reduces to one max over start scores; when any qualifies the
// tail block (olen < len(b)) can never win and is skipped. Otherwise
// tail starts scan in increasing s (decreasing olen) and stop at the
// first qualifying one — the same early exit the numpy path takes.
//
// overlap_best_batch scores a whole candidate-pair list (the
// find_overlaps fan-out, src/assembly.cpp:669-701) across threads.
//
// Built into libgamcodec.so (see Makefile).

#include <cstdint>
#include <thread>
#include <vector>

namespace {

int64_t best_one(const uint8_t* a, int64_t la, const uint8_t* b,
                 int64_t lb, const int16_t* table2, int64_t min_olen,
                 double min_score, double* score_out) {
  *score_out = 0.0;
  if (la < min_olen || lb <= 0) return 0;

  // full-length block: starts where the whole of b fits inside a
  int64_t n_full = la - lb + 1;
  if (n_full > 0 && lb >= min_olen) {
    int64_t best2 = INT64_MIN;
    for (int64_t s = 0; s < n_full; ++s) {
      const uint8_t* ap = a + s;
      int64_t sc2 = 0;
      for (int64_t j = 0; j < lb; ++j) {
        sc2 += table2[(static_cast<int64_t>(ap[j]) << 8) | b[j]];
      }
      if (sc2 > best2) best2 = sc2;
    }
    double best = static_cast<double>(best2) * 0.5;
    if (best >= min_score) {
      *score_out = best;
      return lb;
    }
  }

  // tail block: olen = la - s < lb; first qualifying start wins
  int64_t t0 = n_full > 0 ? n_full : 0;
  int64_t hi = la - min_olen + 1;
  for (int64_t s = t0; s < hi; ++s) {
    int64_t olen = la - s;
    if (olen >= lb) continue;
    const uint8_t* ap = a + s;
    int64_t sc2 = 0;
    for (int64_t j = 0; j < olen; ++j) {
      sc2 += table2[(static_cast<int64_t>(ap[j]) << 8) | b[j]];
    }
    double sc = static_cast<double>(sc2) * 0.5;
    if (sc >= min_score && olen >= min_olen) {
      *score_out = sc;
      return olen;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// table2: [256*256] int16 = combined score table x 2.
// Returns best overlap length; *score_out gets the score.
int64_t overlap_best(
    const uint8_t* a, int64_t la,
    const uint8_t* b, int64_t lb,
    const int16_t* table2,
    int64_t min_olen, double min_score,
    double* score_out) {
  return best_one(a, la, b, lb, table2, min_olen, min_score, score_out);
}

// Batched pair scoring: pair i is (abuf[aoff[i]:aoff[i+1]],
// bbuf[boff[i]:boff[i+1]]); results land in out_len/out_score.
void overlap_best_batch(
    const uint8_t* abuf, const int64_t* aoff,
    const uint8_t* bbuf, const int64_t* boff,
    int64_t n, const int16_t* table2,
    int64_t min_olen, double min_score,
    int64_t* out_len, double* out_score, int32_t nthreads) {
  if (nthreads < 1) nthreads = 1;
  auto work = [&](int64_t t) {
    for (int64_t i = t; i < n; i += nthreads) {
      out_len[i] = best_one(
          abuf + aoff[i], aoff[i + 1] - aoff[i],
          bbuf + boff[i], boff[i + 1] - boff[i],
          table2, min_olen, min_score, &out_score[i]);
    }
  };
  if (nthreads == 1) {
    work(0);
    return;
  }
  std::vector<std::thread> ts;
  for (int32_t t = 0; t < nthreads; ++t) ts.emplace_back(work, t);
  for (auto& th : ts) th.join();
}

}  // extern "C"
