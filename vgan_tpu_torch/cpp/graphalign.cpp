// Copied from vgan_tpu/cpp/graphalign.cpp (unchanged below this line).
// Sequence-to-graph affine alignment with traceback (native).
//
// Exact port of vgan_tpu/mapper/graph_align.py::align_to_window — the
// winner-refinement stage of the mapper. Columns are topologically
// ordered graph positions with CSR predecessor lists; scoring matches
// the Python/Pallas engines (match 1, mismatch -4, gap open 6,
// gap extend 1, full-length bonus 5 at both read ends).
//
// Built into libgamcodec.so (see Makefile).

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {
constexpr int32_t MATCH = 1;
constexpr int32_t MISMATCH = -4;
constexpr int32_t GAP_OPEN = 6;
constexpr int32_t GAP_EXT = 1;
constexpr int32_t BONUS = 5;
constexpr int32_t NEG = -1000000000;
}

extern "C" {

// Returns walk length (>=0) or -1 when no positive-scoring alignment.
// out_meta: [score, read_start, read_end, n_matches, aligned_cols]
int64_t graph_align(
    const uint8_t* q, int32_t n,
    const uint8_t* ref, int32_t ncols,
    const int64_t* pred_off,  // [ncols+1] CSR offsets
    const int32_t* pred_idx,  // predecessor position ids
    int32_t* out_ops,         // [cap] 0=M 1=X 2=D 3=I (read-order)
    int32_t* out_cols,        // [cap] column id (-1 for I)
    int64_t cap,
    int64_t* out_meta         // [5]
) {
  if (n <= 0 || ncols <= 0) return -1;
  const int64_t stride = n + 1;
  // thread_local slabs: the finalize calls this per error-bearing read
  // (hundreds per chunk); per-call vector alloc + full-matrix init was
  // ~half the DP cost. Only the base column (index 0) needs init —
  // every other column is fully written before any successor reads it
  // (predecessors have smaller indices).
  thread_local std::vector<int32_t> H, E, Hp, Ep;
  const int64_t slab = (int64_t)(ncols + 1) * stride;
  if ((int64_t)H.size() < slab) {
    H.resize(slab);
    E.resize(slab);
  }
  if ((int64_t)Hp.size() < stride) {
    Hp.resize(stride);
    Ep.resize(stride);
  }
  std::fill(H.begin(), H.begin() + stride, 0);
  std::fill(E.begin(), E.begin() + stride, NEG);

  for (int32_t c = 0; c < ncols; ++c) {
    int64_t np_ = pred_off[c + 1] - pred_off[c];
    const int32_t* HpP;
    const int32_t* EpP;
    if (np_ == 0) {
      HpP = H.data();
      EpP = E.data();
    } else if (np_ == 1) {
      // single predecessor (the common case): no copy, alias the row
      const int32_t p0 = pred_idx[pred_off[c]] + 1;
      HpP = H.data() + (int64_t)p0 * stride;
      EpP = E.data() + (int64_t)p0 * stride;
    } else {
      const int32_t p0 = pred_idx[pred_off[c]] + 1;
      std::memcpy(Hp.data(), H.data() + (int64_t)p0 * stride,
                  stride * sizeof(int32_t));
      std::memcpy(Ep.data(), E.data() + (int64_t)p0 * stride,
                  stride * sizeof(int32_t));
      for (int64_t k = 1; k < np_; ++k) {
        const int32_t p = pred_idx[pred_off[c] + k] + 1;
        const int32_t* hrow = H.data() + (int64_t)p * stride;
        const int32_t* erow = E.data() + (int64_t)p * stride;
        for (int64_t i = 0; i <= n; ++i) {
          Hp[i] = std::max(Hp[i], hrow[i]);
          Ep[i] = std::max(Ep[i], erow[i]);
        }
      }
      HpP = Hp.data();
      EpP = Ep.data();
    }
    int32_t* Hc = H.data() + (int64_t)(c + 1) * stride;
    int32_t* Ec = E.data() + (int64_t)(c + 1) * stride;
    const uint8_t rc = ref[c];
    // one fused pass: E from the pred column, H diag, exact F via the
    // running max of (post-F H[i'] + i'*ext) — identical values to the
    // former three passes (F reads the already-F-updated prefix)
    Ec[0] = std::max(HpP[0] - GAP_OPEN, EpP[0] - GAP_EXT);
    Hc[0] = std::max(0, Ec[0]);
    int64_t run = (int64_t)Hc[0];
    {
      // i == 1 (start bonus)
      int32_t s = (q[0] == rc && q[0] < 4) ? MATCH : MISMATCH;
      Ec[1] = std::max(HpP[1] - GAP_OPEN, EpP[1] - GAP_EXT);
      int32_t h = std::max({0, HpP[0] + s + BONUS, Ec[1]});
      int64_t f = run - GAP_OPEN;
      if (f > h) h = (int32_t)f;
      Hc[1] = h;
      int64_t cand = (int64_t)h + GAP_EXT;
      if (cand > run) run = cand;
    }
    for (int64_t i = 2; i <= n; ++i) {
      int32_t s = (q[i - 1] == rc && q[i - 1] < 4) ? MATCH : MISMATCH;
      int32_t e = std::max(HpP[i] - GAP_OPEN, EpP[i] - GAP_EXT);
      Ec[i] = e;
      int32_t h = std::max({0, HpP[i - 1] + s, e});
      int64_t f = run - GAP_OPEN - (i - 1) * GAP_EXT;
      if (f > h) h = (int32_t)f;
      Hc[i] = h;
      int64_t cand = (int64_t)h + i * GAP_EXT;
      if (cand > run) run = cand;
    }
  }

  // best cell with end bonus at row n
  int64_t best = 0;
  int32_t c_best = -1, i_best = -1;
  for (int32_t c = 0; c < ncols; ++c) {
    const int32_t* Hc = H.data() + (int64_t)(c + 1) * stride;
    for (int64_t i = 1; i <= n; ++i) {
      int64_t v = Hc[i] + (i == n ? BONUS : 0);
      if (v > best) {
        best = v;
        c_best = c;
        i_best = (int32_t)i;
      }
    }
  }
  if (c_best < 0 || H[(int64_t)(c_best + 1) * stride + i_best] <= 0) return -1;

  // traceback (mirrors the python H/E state machine)
  std::vector<int32_t> ops, cols;
  int32_t c = c_best;
  int64_t i = i_best;
  int n_matches = 0, aligned = 0;
  bool stateH = true;
  bool done = false;
  int64_t guard = 0, guard_max = 10 * ((int64_t)n + ncols + 2);
  auto hval = [&](int64_t p, int64_t row) { return H[p * stride + row]; };
  auto eval_ = [&](int64_t p, int64_t row) { return E[p * stride + row]; };
  while (!done && i >= 0 && guard++ < guard_max) {
    int64_t np_ = pred_off[c + 1] - pred_off[c];
    // fold predecessors
    auto predH = [&](int64_t row) {
      if (np_ == 0) return hval(0, row);
      int32_t m = NEG;
      for (int64_t k = 0; k < np_; ++k)
        m = std::max(m, hval(pred_idx[pred_off[c] + k] + 1, row));
      return m;
    };
    auto predE = [&](int64_t row) {
      if (np_ == 0) return eval_(0, row);
      int32_t m = NEG;
      for (int64_t k = 0; k < np_; ++k)
        m = std::max(m, eval_(pred_idx[pred_off[c] + k] + 1, row));
      return m;
    };
    auto bestPredH = [&](int64_t row) -> int64_t {
      if (np_ == 0) return 0;
      int64_t bp = pred_idx[pred_off[c]] + 1;
      for (int64_t k = 1; k < np_; ++k) {
        int64_t p = pred_idx[pred_off[c] + k] + 1;
        if (hval(p, row) > hval(bp, row)) bp = p;
      }
      return bp;
    };
    auto bestPredE = [&](int64_t row) -> int64_t {
      if (np_ == 0) return 0;
      int64_t bp = pred_idx[pred_off[c]] + 1;
      for (int64_t k = 1; k < np_; ++k) {
        int64_t p = pred_idx[pred_off[c] + k] + 1;
        if (eval_(p, row) > eval_(bp, row)) bp = p;
      }
      return bp;
    };
    if (stateH) {
      int32_t cur = hval(c + 1, i);
      if (cur <= 0 || i == 0) break;
      int32_t s = (q[i - 1] == ref[c] && q[i - 1] < 4) ? MATCH : MISMATCH;
      int32_t diag = predH(i - 1) + s + (i == 1 ? BONUS : 0);
      if (cur == diag) {
        ops.push_back(s == MATCH ? 0 : 1);
        cols.push_back(c);
        if (s == MATCH) n_matches++;
        aligned++;
        int64_t bp = bestPredH(i - 1);
        i -= 1;
        if (bp == 0 || i == 0) done = true;
        else c = (int32_t)(bp - 1);
      } else if (cur == eval_(c + 1, i)) {
        stateH = false;
      } else {
        // vertical gap: find the opener
        int64_t opener = -1;
        for (int64_t i2 = i - 1; i2 >= 1; --i2) {
          if (hval(c + 1, i2) - GAP_OPEN - (i - i2 - 1) * GAP_EXT == cur) {
            opener = i2;
            break;
          }
        }
        if (opener < 0) break;
        for (int64_t k = 0; k < i - opener; ++k) {
          ops.push_back(3);
          cols.push_back(-1);
        }
        i = opener;
      }
    } else {
      ops.push_back(2);
      cols.push_back(c);
      aligned++;
      int32_t ecur = eval_(c + 1, i);
      int64_t bp;
      if (predE(i) - GAP_EXT == ecur) {
        bp = bestPredE(i);
        stateH = false;
      } else {
        bp = bestPredH(i);
        stateH = true;
      }
      if (bp == 0) done = true;
      else c = (int32_t)(bp - 1);
    }
  }
  int64_t wl = (int64_t)ops.size();
  if (wl > cap) wl = cap;
  // reverse into output
  for (int64_t k = 0; k < wl; ++k) {
    out_ops[k] = ops[ops.size() - 1 - k];
    out_cols[k] = cols[cols.size() - 1 - k];
  }
  out_meta[0] = H[(int64_t)(c_best + 1) * stride + i_best];
  out_meta[1] = i;  // read_start
  out_meta[2] = i_best;
  out_meta[3] = n_matches;
  out_meta[4] = aligned;
  return wl;
}

}  // extern "C"
