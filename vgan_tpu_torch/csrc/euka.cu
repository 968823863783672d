// euka's per-base two-model scorer, for Hopper (sm_90a).
//
// Replaces the XLA program vgan_tpu/pipelines/euka.py::_score_batch_impl
// (:111-184, jitted at :187) with the damage-matrix lookup it inlines,
// vgan_tpu/models/damage.py::dinuc_gather (:128-141). The plain PyTorch
// version is vgan_tpu_torch/pipelines/euka.py::score_batch_plain.
//
// What it computes, for each row b over its L columns (f64):
//   (il[b], nl[b]) = (sum of m1, sum of m2) over the columns where valid;
//   an invalid column adds nothing.
// A column is, in this order of precedence:
//   N        g == N or r == N:    m1 = m2 = bfreq[r] (a negative r counts
//                                 from the end of the table, then clamps);
//   gap      g or r == GAP:       m1 = log 0.002, m2 = log 0.2;
//   rare     g or r == RARE:      m1 = log((1 - pd) 0.001), m2 = log 0.001;
//   softclip g or r == SOFTCLIP:  m2 = log 0.25; m1 = log1p(-qv) where the
//            row's inclusive running count of softclip columns (valid or
//            not, in column order, as JAX's cumsum) is 0 mod 3, else
//            log(qv / 3);
//   ACGT     any other column:    m2 = log(1 - 0.25536) if g == r, else
//            log 0.25536; m1 = logsumexp over d of
//            log(max(post[d], 1e-300)) + log(d == r4 ? 1 - qv : qv / 3),
//            which equals log(sum over d of max(post[d], 1e-300) err[d]),
//            err[d] = d == r4 ? 1 - qv : qv / 3 (the form computed here),
//            post[d] = sum over o of pre[o] D[o][d],
//            pre[o] = o == g4 ? 1 - pd : pd ttr[g4][o],
//            D[o] = sub5p[l5][o] if sub5p[l5][o][o] <= sub3p[l3][o][o]
//                   else sub3p[l3][o],
//            l5 = clamp(n, 0, maxlen - 1), l3 = clamp(L_read - n - 1, 0,
//            maxlen - 1) in int32 arithmetic that wraps, as JAX's does;
// with qv = qtab[clamp(q, 0, n_q - 1)], g4 = clamp(g, 0, 3),
// r4 = clamp(r, 0, 3), pd = pair_dist[b].
//
// Bound. The five [B, L] inputs (17 bytes a column), the three [B] ones and
// the tables read once and the two [B] outputs written once, over 3.35
// TB/s, against the f64 instructions the function needs (an ACGT column
// ~72: the 4 x 4 product, the clamps, 1 - qv, qv / 3, one log) over 132
// SMs x 64 FP64 lanes. Bytes bound it at both shapes it runs at: euka's
// calls (B ~ 4,096, L = 64: ~1.4 us; operations ~1.1 us) and a 1,000-bp
// batch (B = 2,048, L = 1,024: ~10.7 us; operations ~8.5 us). The first
// design (a warp a row, columns in tiles of 32) stood at 4-5 % of that:
// an ACGT column reads 24 f64 of two 128-byte table rows, and 32 lanes
// reading 32 different rows through L1 take 32 wavefronts an
// instruction, ~24 cycles of an SM a column. What bounds this design on
// the card is the instructions a column issues (its items take most of
// a CTA's time, and the table reads and the log little of that); PERF.md
// has its clock64 split.
//
// Design.
// * One transcendental a valid column: the log of the sum above for
//   ACGT, log(qv / 3) or log1p(-qv) for a softclip (log1p only where a
//   lane of the warp needs it), none for N, gap and rare (the rare term
//   is a row constant, one log a row). Lanes without a log of their own
//   take log(1), the fast path.
// * The damage-table rows a CTA's valid columns touch are staged in
//   shared memory: the CTA reads its columns' n_pos and valid first,
//   reduces the 5' and 3' row ranges (warp min / max, then the CTA's),
//   and copies those rows with cp.async, as many as the shared memory
//   left by the rows' tables holds (~370 of both). A lane's four columns
//   are consecutive, so the lanes of a row read rows four apart: staged
//   rows are kept by slot mod 4 in four quarters, 17 doubles a row, and
//   16 lanes reading consecutive rows of a quarter hit 16 bank pairs. A
//   column reads the four diagonal entries of both rows, then row o of
//   the table each compare chooses (its diagonal entry reused): 20
//   8-byte loads.
// * Reads of both orientations: a forward read's 5' rows follow its
//   columns and its 3' rows lie far from them, a reverse read's the other
//   way round (euka counts a reverse read's n_pos down). Long reads of
//   both in one CTA touch two far-apart ranges of each table, more rows
//   than fit. So the range pass also puts each row in a class (0 where
//   its 5' rows lie no farther from its columns than its 3' rows, else 1)
//   and keeps each class's ranges; a CTA whose ranges do not fit but whose
//   classes' ranges do, each alone, stages and scores them in two rounds,
//   a class a round (where a warp is a row, G = 32, so that a warp skips
//   a row of the other class whole). A row is scored whole in one round,
//   so its sum runs in the same order either way. A CTA whose classes do
//   not fit either, or that holds no valid column, reads the tables
//   through L1.
// * Columns in flight: a lane takes four consecutive columns (16-byte
//   loads of g, r, q, n_pos and one 4-byte word of valid where the rows
//   are 16-byte aligned; scalar loads otherwise), G = 8, 16 or 32 lanes a
//   row (L <= 32, <= 64, more), a CTA of eight warps P passes of 256 / G
//   rows. An item (a lane's four columns of a pass's row) starts the next
//   item's loads after its row sum: a second register buffer, to start
//   them before the item's scoring, spills and measured slower (PERF.md).
//   80 registers a thread, three CTAs (24 warps) an SM.
// * Long rows are split over a thread-block cluster: a row of more than
//   128 columns takes nc = min(8, ceil(L / 128)) CTAs, each a span of
//   ceil(L / 1,024) x 128 of its columns, for the same 16 rows; so a
//   1,000-bp batch stages ~350 rows a CTA. Ranks 1.. write their rows'
//   partial sums into rank 0's shared memory, arrive on the cluster
//   barrier and leave; only rank 0 waits, then adds.
// * The softclip count only matters mod 3: a chunk's flags by
//   __ballot_sync, a lane's count the popcount of the lanes below it in
//   its row's group plus the row's count so far; a CTA whose span does
//   not start the row counts the softclips before it (the row's g and r
//   from column 0) only when the span holds a valid softclip column.
// * Deterministic sums: a lane adds its columns in column order, a
//   butterfly of xor shuffles adds the G lanes of a row, and rank 0 adds
//   the spans' partials in rank order; no atomics. G, the spans and the
//   cluster size depend only on L, so a row gives the same bits in any
//   batch, at any place in it (and padded with invalid columns), through
//   staged or L1 tables, in one round or two.
// * Exactness: max(post, 1e-300) keeps a NaN (a compare that fails keeps
//   post), as jnp.maximum does; CUDA's fmax would drop it. A NaN diagonal
//   fails the compare and takes the 3' row, as the plain version's where()
//   does. Each class's terms are picked by a select, never arithmetic,
//   so an inf or NaN of an unused class never reaches a sum. The products
//   of the ACGT term contract to fused multiply-adds (__fma_rn), so the
//   kernel rounds otherwise than torch's einsum and logsumexp: it agrees
//   with the plain version to rtol 1e-12, not bit for bit. Every index
//   clamps with min / max (clamp_index), around a ptxas fault of CUDA 12.9.
//
// Builds for measurement and tests only (nvcc -D...; the results do not
// change): VGAN_EUKA_PHASE_CLOCKS (clock64 phases, euka_phase_clocks),
// VGAN_EUKA_TABLES_L1 (every CTA reads the tables through L1),
// VGAN_EUKA_SCALAR_LOADS (no 16-byte code loads), VGAN_EUKA_MIN_BLOCKS=N
// (the registers sized for N CTAs an SM).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// CTAs an SM the registers are sized for: 3, at most 80 registers a thread
#ifndef VGAN_EUKA_MIN_BLOCKS
#define VGAN_EUKA_MIN_BLOCKS 3
#endif
constexpr int kMinBlocks = VGAN_EUKA_MIN_BLOCKS;
#ifdef VGAN_EUKA_TABLES_L1
constexpr bool kTablesL1 = true;
#else
constexpr bool kTablesL1 = false;
#endif
#ifdef VGAN_EUKA_SCALAR_LOADS
constexpr bool kScalarLoads = true;
#else
constexpr bool kScalarLoads = false;
#endif
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxReads = 32;   // rows a CTA
constexpr int kMaxCluster = 8;  // CTAs a row's columns split over (portable)
constexpr int kChunkCols = 128;  // columns 32 lanes take at once (4 a lane)
constexpr int kSmemBytes = 57344;  // dynamic shared memory a CTA
constexpr int kRowStride = 17;  // doubles a staged row takes (16 + 1 pad)
constexpr int kQCap = 128;      // qtab entries staged as (1 - qv, qv / 3)
// dna codes (vgan_tpu_torch/utils/dna.py)
constexpr int kN = 4, kGap = 5, kSoft = 6, kRare = 7;
// the constant terms, as Python's math.log gives them
constexpr double kGapM1 = -0x1.8dbc239b0b862p+2;       // log 0.002
constexpr double kGapM2 = -0x1.9c041f7ed8d33p+0;       // log 0.2
constexpr double kRareM2 = -0x1.ba18a998fffa0p+2;      // log 0.001
constexpr double kSoftM2 = -0x1.62e42fefa39efp+0;      // log 0.25
constexpr double kMatchM2 = -0x1.2dee4fc0e1ffcp-2;     // log(1 - 0.25536)
constexpr double kMismatchM2 = -0x1.5d75f233de14fp+0;  // log 0.25536

#ifdef VGAN_EUKA_PHASE_CLOCKS
// Cycles summed over CTAs (thread 0) of [0] the prologue and the range
// pass (the first codes' loads), [1] the range reduction, [2] the
// staging, [3] the items, [4] rank 0's wait for its cluster; over items
// (lane 0 of each warp) of [5] the wait for the item's codes, the classes
// and the softclip count, [6] the table reads, the 4 x 4 products, the
// logs and the row sums, [7] the row's lane sum and the next item's
// loads; then [8] CTAs, [9] items and [10] CTAs that staged their rows
// counted; [11 + k] the items' cycles of rank k's CTAs (k < 8); [19] CTAs
// that staged their rows in two rounds. euka_phase_clocks reads and
// clears them.
constexpr int kClocks = 20;
__device__ unsigned long long g_euka_clocks[kClocks];
#define EUKA_STAMP(t) const long long t = clock64()
#else
#define EUKA_STAMP(t)
#endif

struct Args {
  const int32_t* g;
  const int32_t* r;
  const int32_t* q;
  const int32_t* n_pos;
  const int32_t* L_read;
  const double* pair_dist;
  const uint8_t* valid;
  const double* sub5p;  // [maxlen, 4, 4]
  const double* sub3p;  // [maxlen, 4, 4]
  int maxlen;
  const double* qtab;  // [n_q]
  int n_q;
  const double* bfreq;  // [n_bf]
  int n_bf;
  const double* ttr;  // [4, 4]
  long long B;
  int L;
  double* il;
  double* nl;
};

// The launch's shape, from L and B (geometry()).
struct Geo {
  int G;     // lanes a row: 8, 16 or 32
  int rpp;   // rows a pass: kThreads / G
  int P;     // passes: a CTA takes rpp * P rows
  int S;     // columns of a row a CTA takes (its span), a multiple of 4 G
  int nc;    // CTAs a cluster: a row's columns in nc spans
  int cap;   // staged table rows a CTA holds, a multiple of 4
};

// A CTA's shared memory (kSmemBytes): the staged rows fill what the
// rows' tables leave.
struct Smem {
  double* rows;     // [cap, 17]: staged rows (slot_index)
  double* pre;      // [R, 16]: a row's pre[g4][o]
  double* rare;     // [R]: a row's log((1 - pd) 0.001)
  double* part;     // [kMaxCluster, R, 2]: each span's (m1, m2) partial
                    // sums of the rows, written into rank 0's
  double2* qt;      // [kQCap]: (1 - qv, qv / 3) of qtab's entries
  int* red;         // [kWarps, 8]: the warps' table-row ranges by class
  int* win;         // [9]: the rounds, then each round's (lo5, n5, lo3, n3)
  int* cls;         // [R]: a row's class (0 or 1)
  int quarter;      // cap / 4
};

// The bytes of Smem's arrays besides the rows, for R rows a CTA.
__host__ __device__ constexpr int smem_fixed(int R) {
  return R * (16 + 1 + 2 * kMaxCluster) * 8 + kQCap * 16 + kWarps * 8 * 4 +
         9 * 4 + R * 4;
}

__device__ __forceinline__ Smem carve(unsigned char* raw, int cap, int R) {
  Smem sm;
  sm.rows = reinterpret_cast<double*>(raw);
  sm.pre = sm.rows + kRowStride * cap;
  sm.rare = sm.pre + 16 * R;
  sm.part = sm.rare + R;
  sm.qt = reinterpret_cast<double2*>(sm.part + 2 * kMaxCluster * R);
  sm.red = reinterpret_cast<int*>(sm.qt + kQCap);
  sm.win = sm.red + 8 * kWarps;
  sm.cls = sm.win + 9;
  sm.quarter = cap / 4;
  return sm;
}

// A lane's four columns of one row, 0 past the span or past B.
struct Codes {
  int g[4], r[4], q[4], n[4];
  unsigned v;  // byte j: column j valid
  int Lr;      // the row's L_read
};

// i clamped to 0..n - 1, with min / max: ptxas of CUDA 12.9 (V12.9.86) at
// -O1 and above miscompiles the same clamp written as nested ternaries
// where its result meets the constants of an unrolled loop (a compare
// with o or d = 3 took the wrong side). The standalone repro is
// csrc/ptxas_select_repro.cu; tests/test_torch_cuda.py holds this kernel
// to its plain version when built at ptxas -O0 to -O3.
__device__ __forceinline__ int clamp_index(int i, int n) {
  return min(max(i, 0), n - 1);
}

// The first double of staged slot s in Smem::rows. A lane's four columns
// are consecutive, so in one instruction the lanes of a row read slots
// four apart: slots are kept by s mod 4 in four quarters, each in slot
// order, rows of 17 doubles, and 16 lanes reading 8-byte entries of
// consecutive rows of a quarter hit 16 different bank pairs.
__device__ __forceinline__ int slot_index(const Smem& sm, int s) {
  return kRowStride * ((s & 3) * sm.quarter + (s >> 2));
}

__device__ __forceinline__ bool soft_code(int g, int r) {
  const bool n = g == kN || r == kN;
  const bool gap = g == kGap || r == kGap;
  const bool rare = g == kRare || r == kRare;
  return !n && !gap && !rare && (g == kSoft || r == kSoft);
}

__device__ __forceinline__ int l3_row(int Lr, int n, int maxlen) {
  // L_read - n - 1 in int32 arithmetic that wraps, as JAX's does
  return clamp_index((int)((unsigned)Lr - (unsigned)n - 1u), maxlen);
}

__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// Copies rows lo5.. (n5 of them) of sub5p, then rows lo3.. (n3) of sub3p
// into the staged slots 0.., every copy in flight at once, then one wait.
__device__ __forceinline__ void stage(const Args& a, const Smem& sm, int lo5,
                                      int n5, int lo3, int n3) {
  for (int i = threadIdx.x; i < 16 * (n5 + n3); i += kThreads) {
    const int s = i >> 4, e = i & 15;
    cp_async8(sm.rows + slot_index(sm, s) + e,
              s < n5 ? a.sub5p + 16 * (long long)(lo5 + s) + e
                     : a.sub3p + 16 * (long long)(lo3 + s - n5) + e);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// Four int32 at p, a 16-byte boundary.
__device__ __forceinline__ void load4(const int32_t* p, int* x) {
  const int4 t = __ldg(reinterpret_cast<const int4*>(p));
  x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
}

// Loads a lane's four columns [c0, c0 + 4) of row b (those below c_hi):
// n_pos and valid, and g, r and q when `full`.
template <bool kVec>
__device__ __forceinline__ void load_codes(const Args& a, long long b, int c0,
                                           int c_hi, bool full, Codes& x) {
#pragma unroll
  for (int j = 0; j < 4; ++j) x.g[j] = x.r[j] = x.q[j] = x.n[j] = 0;
  x.v = 0;
  x.Lr = 0;
  if (b >= a.B) return;
  x.Lr = __ldg(a.L_read + b);
  if (c0 >= c_hi) return;
  const long long i = b * (long long)a.L + c0;
  if (kVec) {  // c_hi is L or a span's end, both multiples of 4
    if (full) {
      load4(a.g + i, x.g);
      load4(a.r + i, x.r);
      load4(a.q + i, x.q);
    }
    load4(a.n_pos + i, x.n);
    x.v = __ldg(reinterpret_cast<const unsigned*>(a.valid + i));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c0 + j < c_hi) {
        if (full) {
          x.g[j] = __ldg(a.g + i + j);
          x.r[j] = __ldg(a.r + i + j);
          x.q[j] = __ldg(a.q + i + j);
        }
        x.n[j] = __ldg(a.n_pos + i + j);
        x.v |= (unsigned)(__ldg(a.valid + i + j) != 0) << (8 * j);
      }
    }
  }
}

// The softclip columns of row b in [0, c_end), summed over the G lanes of
// its group (every lane of the warp calls it; G divides 32); four steps
// of the group's columns loaded at once.
template <bool kVec>
__device__ int soft_before(const Args& a, long long b, int c_end, int G,
                           int gl) {
  int cnt = 0;
  if (b < a.B) {
    const long long base = b * (long long)a.L;
    for (int c = 4 * gl; c < c_end; c += 16 * G) {
      Codes x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int cu = c + 4 * G * u;
#pragma unroll
        for (int j = 0; j < 4; ++j) x[u].g[j] = x[u].r[j] = 0;
        if (kVec) {
          if (cu < c_end) {
            load4(a.g + base + cu, x[u].g);
            load4(a.r + base + cu, x[u].r);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (cu + j < c_end) {
              x[u].g[j] = __ldg(a.g + base + cu + j);
              x[u].r[j] = __ldg(a.r + base + cu + j);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j) cnt += soft_code(x[u].g[j], x[u].r[j]);
    }
  }
  for (int o = G >> 1; o > 0; o >>= 1) cnt += __shfl_xor_sync(kFull, cnt, o);
  return cnt;
}

// sum over d of max(post[d], 1e-300) err[d] of an ACGT column (see the
// header): for each o the diagonal entries of both rows, then row o of
// the table the compare chooses; k5 / k3 are the column's staged slots
// (kStaged) or its table rows.
template <bool kStaged>
__device__ __forceinline__ double acgt_sum(const Args& a, const Smem& sm,
                                           const double* pre, int k5, int k3,
                                           int r4, double e_hit,
                                           double e_miss) {
  double post[4];
  if constexpr (kStaged) {
    const int i5 = slot_index(sm, k5), i3 = slot_index(sm, k3);
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      const double d5 = sm.rows[i5 + 5 * o], d3 = sm.rows[i3 + 5 * o];
      // a NaN diagonal fails the compare and takes the 3' row
      const bool use5 = d5 <= d3;
      const int i = (use5 ? i5 : i3) + 4 * o;
      const double po = pre[o];
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        // the chosen row's diagonal entry is the one just compared
        const double D = d == o ? (use5 ? d5 : d3) : sm.rows[i + d];
        post[d] = o == 0 ? __dmul_rn(po, D) : __fma_rn(po, D, post[d]);
      }
    }
  } else   {
    const double* p5 = a.sub5p + 16 * (long long)k5;
    const double* p3 = a.sub3p + 16 * (long long)k3;
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      const double* p =
          (__ldg(p5 + 5 * o) <= __ldg(p3 + 5 * o) ? p5 : p3) + 4 * o;
      const double po = pre[o];
#pragma unroll
      for (int d = 0; d < 4; ++d)
        post[d] = o == 0 ? __dmul_rn(po, __ldg(p + d))
                         : __fma_rn(po, __ldg(p + d), post[d]);
    }
  }
  double s = 0.0;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const double p = post[d] < 1e-300 ? 1e-300 : post[d];  // NaN stays
    const double e = d == r4 ? e_hit : e_miss;
    s = d == 0 ? __dmul_rn(p, e) : __fma_rn(p, e, s);
  }
  return s;
}

// Adds one column's (m1, m2) into (s1, s2) where it is valid (`ok`);
// `count` is the row's softclips before it and takes this one's.
template <bool kStaged>
__device__ __forceinline__ void score_column(
    const Args& a, const Smem& sm, const double* pre, double rare_m1,
    bool qs, int gv, int rv, int q, int nv, int Lr, bool ok, bool soft,
    int& count, int lo5, int n5, int lo3, double& s1, double& s2) {
  const bool is_n = gv == kN || rv == kN;
  const bool is_gap = !is_n && (gv == kGap || rv == kGap);
  const bool is_rare = !is_n && !is_gap && (gv == kRare || rv == kRare);
  count += soft;
  const bool third = ok && soft && count % 3 == 0;
  const bool acgt = ok && !is_n && !is_gap && !is_rare && !soft;
  const int qi = clamp_index(q, a.n_q);
  double e_hit, e_miss;
  if (qs) {
    const double2 t = sm.qt[qi];
    e_hit = t.x;
    e_miss = t.y;
  } else {
    const double qv = __ldg(a.qtab + qi);
    e_hit = __dsub_rn(1.0, qv);
    e_miss = qv / 3.0;
  }
  const int l5 = clamp_index(nv, a.maxlen);
  const int l3 = l3_row(Lr, nv, a.maxlen);
  // a column of another class reads slot 0 (staged: the round's windows
  // are not empty) or its clamped table rows, and drops the value
  const int k5 = kStaged ? (acgt ? l5 - lo5 : 0) : l5;
  const int k3 = kStaged ? (acgt ? n5 + l3 - lo3 : 0) : l3;
  const double s = acgt_sum<kStaged>(a, sm, pre + 4 * clamp_index(gv, 4), k5,
                                     k3, clamp_index(rv, 4), e_hit, e_miss);
  // one log a column; log(1) where the column needs none
  const double lx = log(acgt ? s : (ok && soft && !third ? e_miss : 1.0));
  double m1 = 0.0, m2 = 0.0;
  if (is_n) {
    if (ok)
      m1 = m2 = __ldg(a.bfreq + clamp_index(rv < 0 ? rv + a.n_bf : rv,
                                            a.n_bf));
  } else if (is_gap) {
    m1 = kGapM1;
    m2 = kGapM2;
  } else if (is_rare) {
    m1 = rare_m1;
    m2 = kRareM2;
  } else if (soft) {
    m1 = third ? log1p(-__ldg(a.qtab + qi)) : lx;
    m2 = kSoftM2;
  } else {
    m1 = lx;
    m2 = gv == rv ? kMatchM2 : kMismatchM2;
  }
  if (ok) {
    s1 = __dadd_rn(s1, m1);
    s2 = __dadd_rn(s2, m2);
  }
}

// Scores the CTA's items (a pass's row, a chunk of its span), adding into
// the row sums: every item, or (kByClass) those whose rows are of class
// `cls`; the tables staged (kStaged: rows lo5.. of sub5p, n5 of them, and
// lo3.. of sub3p) or not. `cur` holds the first item's codes where
// `have_cur`.
template <bool kVec, bool kStaged, bool kByClass>
__device__ void run_items(const Args& a, const Geo& geo, const Smem& sm,
                          double* part, Codes cur, bool have_cur, int cls,
                          long long b0, int rank, int c_lo, int c_hi, int lo5,
                          int n5, int lo3) {
  const int lane = threadIdx.x & 31;
  const int G = geo.G;
  const int gl = lane & (G - 1);
  const int slot0 = (threadIdx.x >> 5) * (32 / G) + lane / G;
  const unsigned gmask =
      G == 32 ? kFull : ((1u << G) - 1u) << (lane & ~(G - 1));
  const unsigned below = ((1u << lane) - 1u) & gmask;
  const int chunks = geo.S / (4 * G);
  const int items = geo.P * chunks;
  const bool qs = a.n_q <= kQCap;
  // the first item at or after `it` (at a row's first chunk, or inside a
  // row of the class) whose row is of the class; warp-uniform, since
  // classes split a CTA's rows only where a warp is a row
  auto next_item = [&](int it) {
    if (kByClass)
      while (it < items && sm.cls[(it / chunks) * geo.rpp + slot0] != cls)
        it += chunks;
    return it;
  };
  int it = next_item(0);
  if ((it != 0 || !have_cur) && it < items) {
    const int p = it / chunks, ch = it - p * chunks;
    load_codes<kVec>(a, b0 + p * geo.rpp + slot0, c_lo + ch * 4 * G + 4 * gl,
                     c_hi, true, cur);
  }
  double s1 = 0.0, s2 = 0.0;
  // the row's softclips in its span before this item's chunk (the
  // group's), and before the span (-1: not counted yet)
  int carry = 0, base = rank == 0 ? 0 : -1;
  while (it < items) {
    EUKA_STAMP(t0);
    const int p = it / chunks, ch = it - p * chunks;
    const int rs = p * geo.rpp + slot0;  // the row's slot in the CTA
    const long long b = b0 + rs;
    const int c0 = c_lo + ch * 4 * G + 4 * gl;
    int is_soft = 0, count = carry;  // count: the softclips before a column
    bool want = false;  // a valid softclip column, whose m1 needs the count
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool soft = c0 + j < c_hi && soft_code(cur.g[j], cur.r[j]);
      is_soft |= (int)soft << j;
      want |= soft && ((cur.v >> (8 * j)) & 0xffu) != 0;
      const unsigned ballot = __ballot_sync(kFull, soft);
      count += __popc(ballot & below);  // in the lanes below this one
      carry += __popc(ballot & gmask);
    }
    // a span that does not start its row counts the softclips before it
    // only where it holds a valid softclip column; every group of the
    // warp starts a row at the same item, so base is unknown in all of
    // them at once and the count runs for all
    const bool some_want = __any_sync(kFull, want);
    if (base < 0 && some_want) base = soft_before<kVec>(a, b, c_lo, G, gl);
    count += base;
    EUKA_STAMP(t1);
    const double* pre = sm.pre + 16 * rs;
    if constexpr (kStaged) {  // the four columns interleaved
#pragma unroll
      for (int j = 0; j < 4; ++j)
        score_column<true>(a, sm, pre, sm.rare[rs], qs, cur.g[j], cur.r[j],
                           cur.q[j], cur.n[j], cur.Lr,
                           ((cur.v >> (8 * j)) & 0xffu) != 0,
                           (is_soft >> j) & 1, count, lo5, n5, lo3, s1, s2);
    } else {  // one at a time: the L1 gathers run faster so (measured)
      Codes c = cur;  // its column 0 is the step's column
#pragma unroll 1
      for (int j = 0; j < 4; ++j) {
        score_column<false>(a, sm, pre, sm.rare[rs], qs, c.g[0], c.r[0],
                            c.q[0], c.n[0], c.Lr, (c.v & 0xffu) != 0,
                            (is_soft >> j) & 1, count, lo5, n5, lo3, s1, s2);
        c.g[0] = c.g[1], c.g[1] = c.g[2], c.g[2] = c.g[3];
        c.r[0] = c.r[1], c.r[1] = c.r[2], c.r[2] = c.r[3];
        c.q[0] = c.q[1], c.q[1] = c.q[2], c.q[2] = c.q[3];
        c.n[0] = c.n[1], c.n[1] = c.n[2], c.n[2] = c.n[3];
        c.v >>= 8;
      }
    }
    EUKA_STAMP(t2);
    if (ch == chunks - 1) {  // the row's span is done: add the G lanes
      for (int o = G >> 1; o > 0; o >>= 1) {
        s1 = __dadd_rn(s1, __shfl_xor_sync(kFull, s1, o));
        s2 = __dadd_rn(s2, __shfl_xor_sync(kFull, s2, o));
      }
      if (gl == 0 && b < a.B) {
        if (geo.nc == 1) {
          a.il[b] = s1;
          a.nl[b] = s2;
        } else {  // into rank 0's slots of this rank
          part[2 * rs] = s1;
          part[2 * rs + 1] = s2;
        }
      }
      s1 = s2 = 0.0;
      carry = 0;
      base = rank == 0 ? 0 : -1;
    }
    // the next item's loads (started here rather than before this item's
    // scoring: a second register buffer of codes spills, PERF.md)
    const int it_next = next_item(it + 1);
    if (it_next < items) {
      const int pn = it_next / chunks, chn = it_next - pn * chunks;
      load_codes<kVec>(a, b0 + pn * geo.rpp + slot0,
                       c_lo + chn * 4 * G + 4 * gl, c_hi, true, cur);
    }
    it = it_next;
#ifdef VGAN_EUKA_PHASE_CLOCKS
    EUKA_STAMP(t3);
    if (lane == 0) {
      atomicAdd(&g_euka_clocks[5], (unsigned long long)(t1 - t0));
      atomicAdd(&g_euka_clocks[6], (unsigned long long)(t2 - t1));
      atomicAdd(&g_euka_clocks[7], (unsigned long long)(t3 - t2));
      atomicAdd(&g_euka_clocks[9], 1ull);
    }
#endif
  }
}

// Folds a row's table-row ranges (lane-local) into its class's: lo / hi
// [class * 2 + table].
__device__ __forceinline__ void fold_row(int k, int rlo5, int rhi5, int rlo3,
                                         int rhi3, int* lo, int* hi) {
  if (k == 0) {
    lo[0] = min(lo[0], rlo5), hi[0] = max(hi[0], rhi5);
    lo[1] = min(lo[1], rlo3), hi[1] = max(hi[1], rhi3);
  } else {
    lo[2] = min(lo[2], rlo5), hi[2] = max(hi[2], rhi5);
    lo[3] = min(lo[3], rlo3), hi[3] = max(hi[3], rhi3);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    euka_score_kernel(Args a, Geo geo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  EUKA_STAMP(k0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = geo.G;
  const int gl = lane & (G - 1);
  const int slot0 = warp * (32 / G) + lane / G;
  const int rank = (int)(blockIdx.x % (unsigned)geo.nc);
  const int R = geo.rpp * geo.P;
  const Smem sm = carve(smem_raw, geo.cap, R);
  const long long b0 = (long long)(blockIdx.x / (unsigned)geo.nc) * R;
  const int c_lo = rank * geo.S;
  const int c_hi = min(a.L, c_lo + geo.S);
  const int chunks = geo.S / (4 * G);
  const int items = geo.P * chunks;
  const bool split = geo.nc > 1;  // a row's columns over a cluster
  if (split)  // the cluster barrier's first phase: this CTA has started
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // the first item's codes, then the rows' constants and qtab's
  // (1 - qv, qv / 3)
  Codes cur;
  load_codes<kVec>(a, b0 + slot0, c_lo + 4 * gl, c_hi, true, cur);
  for (int i = tid; i < 16 * R; i += kThreads) {
    const long long b = b0 + (i >> 4);
    const double pd = b < a.B ? a.pair_dist[b] : 0.0;
    const int g4 = (i >> 2) & 3, o = i & 3;
    sm.pre[i] =
        g4 == o ? __dsub_rn(1.0, pd) : __dmul_rn(pd, __ldg(a.ttr + 4 * g4 + o));
  }
  for (int i = tid; i < R; i += kThreads) {
    const long long b = b0 + i;
    const double pd = b < a.B ? a.pair_dist[b] : 0.0;
    sm.rare[i] = log(__dmul_rn(__dsub_rn(1.0, pd), 0.001));
  }
  if (a.n_q <= kQCap) {
    for (int i = tid; i < a.n_q; i += kThreads) {
      const double qv = __ldg(a.qtab + i);
      sm.qt[i] = make_double2(__dsub_rn(1.0, qv), qv / 3.0);
    }
  }

  // the range pass: each row's class (0 where its valid columns' 5' rows
  // lie no farther from the columns than their 3' rows, as a forward
  // read's do, else 1) and each class's 5' and 3' table rows (two items'
  // n_pos and valid loaded at once)
  int lo[4] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX};
  int hi[4] = {INT_MIN, INT_MIN, INT_MIN, INT_MIN};
  int rlo5 = INT_MAX, rhi5 = INT_MIN, rlo3 = INT_MAX, rhi3 = INT_MIN;
  int d5 = -1, d3 = -1;  // the row's farthest 5' and 3' rows from a column
  for (int it0 = 0; it0 < items; it0 += 2) {
    Codes x[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int it = it0 + u;
      const int p = it / chunks, ch = it - p * chunks;
      if (it == 0)
        x[u] = cur;
      else if (it < items)
        load_codes<kVec>(a, b0 + p * geo.rpp + slot0,
                         c_lo + ch * 4 * G + 4 * gl, c_hi, false, x[u]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int it = it0 + u;
      if (it >= items) break;
      const int p = it / chunks, ch = it - p * chunks;
      const int c0 = c_lo + ch * 4 * G + 4 * gl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if ((x[u].v >> (8 * j)) & 0xffu) {
          const int l5 = clamp_index(x[u].n[j], a.maxlen);
          const int l3 = l3_row(x[u].Lr, x[u].n[j], a.maxlen);
          rlo5 = min(rlo5, l5);
          rhi5 = max(rhi5, l5);
          rlo3 = min(rlo3, l3);
          rhi3 = max(rhi3, l3);
          d5 = max(d5, abs(l5 - (c0 + j)));
          d3 = max(d3, abs(l3 - (c0 + j)));
        }
      }
      if (ch == chunks - 1) {  // the row's span is done: its class
        for (int o = G >> 1; o > 0; o >>= 1) {
          d5 = max(d5, __shfl_xor_sync(kFull, d5, o));
          d3 = max(d3, __shfl_xor_sync(kFull, d3, o));
        }
        const int k = d5 <= d3 ? 0 : 1;
        fold_row(k, rlo5, rhi5, rlo3, rhi3, lo, hi);
        if (gl == 0) sm.cls[p * geo.rpp + slot0] = k;
        rlo5 = rlo3 = INT_MAX;
        rhi5 = rhi3 = INT_MIN;
        d5 = d3 = -1;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lo[i] = __reduce_min_sync(kFull, lo[i]);
    hi[i] = __reduce_max_sync(kFull, hi[i]);
    if (lane == 0) {
      sm.red[8 * warp + i] = lo[i];
      sm.red[8 * warp + 4 + i] = hi[i];
    }
  }
  EUKA_STAMP(k1);
  __syncthreads();
  // thread 0 decides the rounds of staged rows: 1 (both classes), 2 (a
  // class a round), or 0 (the tables through L1); their windows wait in
  // shared memory, out of the items' registers
  if (tid == 0) {
    int n[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      for (int w = 1; w < kWarps; ++w) {
        lo[i] = min(lo[i], sm.red[8 * w + i]);
        hi[i] = max(hi[i], sm.red[8 * w + 4 + i]);
      }
      n[i] = hi[i] >= lo[i] ? hi[i] - lo[i] + 1 : 0;
    }
    // both classes' rows together
    const int lo5 = min(lo[0], lo[2]), hi5 = max(hi[0], hi[2]);
    const int lo3 = min(lo[1], lo[3]), hi3 = max(hi[1], hi[3]);
    const int n5 = hi5 >= lo5 ? hi5 - lo5 + 1 : 0;
    const int n3 = hi3 >= lo3 ? hi3 - lo3 + 1 : 0;
    int rounds = 0;
    if (!kTablesL1 && n5 + n3 > 0) {
      if (n5 + n3 <= geo.cap)
        rounds = 1;
      else if (G == 32 && n[0] + n[1] <= geo.cap && n[2] + n[3] <= geo.cap)
        rounds = 2;
    }
    sm.win[0] = rounds;
    if (rounds == 1) {
      sm.win[1] = lo5, sm.win[2] = n5, sm.win[3] = lo3, sm.win[4] = n3;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sm.win[1 + 2 * i] = lo[i], sm.win[2 + 2 * i] = n[i];
    }
  }
  __syncthreads();
  const int rounds = sm.win[0];
  EUKA_STAMP(k2);
  // a split row's partials go into rank 0's slots of this rank: once
  // every CTA of the cluster has started (the barrier's first phase,
  // arrived at on entry), the rank's pointer into rank 0's memory
  double* part = sm.part;
  auto join_cluster = [&]() {
    if (split) {
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
      part = cg::this_cluster().map_shared_rank(sm.part, 0) + 2 * R * rank;
    }
  };
#ifdef VGAN_EUKA_PHASE_CLOCKS
  long long staging = 0;  // the rounds' staging, inside [k3, k4)
#endif
  // each call site once, so that `cur` dies with the first round
  EUKA_STAMP(k3);
  if (rounds == 0) {
    join_cluster();
    run_items<kVec, false, false>(a, geo, sm, part, cur, true, 0, b0, rank,
                                  c_lo, c_hi, 0, 0, 0);
  } else {
    stage(a, sm, sm.win[1], sm.win[2], sm.win[3], sm.win[4]);
    EUKA_STAMP(k3b);
    join_cluster();
    if (rounds == 1) {
      run_items<kVec, true, false>(a, geo, sm, part, cur, true, 0, b0, rank,
                                   c_lo, c_hi, sm.win[1], sm.win[2],
                                   sm.win[3]);
    } else {
      run_items<kVec, true, true>(a, geo, sm, part, cur, true, 0, b0, rank,
                                  c_lo, c_hi, sm.win[1], sm.win[2],
                                  sm.win[3]);
      __syncthreads();  // every read of round 0's rows done
      EUKA_STAMP(k3c);
      stage(a, sm, sm.win[5], sm.win[6], sm.win[7], sm.win[8]);
      EUKA_STAMP(k3d);
      run_items<kVec, true, true>(a, geo, sm, part, Codes{}, false, 1, b0,
                                  rank, c_lo, c_hi, sm.win[5], sm.win[6],
                                  sm.win[7]);
#ifdef VGAN_EUKA_PHASE_CLOCKS
      staging += k3d - k3c;
#endif
    }
#ifdef VGAN_EUKA_PHASE_CLOCKS
    staging += k3b - k3;
#endif
  }
  EUKA_STAMP(k4);

  if (split) {
    // the second phase: every rank arrives after its partials are written
    // (release) and leaves; rank 0 waits for them (acquire) and adds the
    // spans' partials of each row in rank order
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    if (rank == 0) {
      asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
      for (int i = tid; i < R; i += kThreads) {
        const long long b = b0 + i;
        if (b >= a.B) continue;
        double t1 = sm.part[2 * i], t2 = sm.part[2 * i + 1];
        for (int k = 1; k < geo.nc; ++k) {
          t1 = __dadd_rn(t1, sm.part[2 * (k * R + i)]);
          t2 = __dadd_rn(t2, sm.part[2 * (k * R + i) + 1]);
        }
        a.il[b] = t1;
        a.nl[b] = t2;
      }
    }
  }
#ifdef VGAN_EUKA_PHASE_CLOCKS
  EUKA_STAMP(k5);
  if (tid == 0) {
    atomicAdd(&g_euka_clocks[0], (unsigned long long)(k1 - k0));
    atomicAdd(&g_euka_clocks[1], (unsigned long long)(k2 - k1));
    atomicAdd(&g_euka_clocks[2], (unsigned long long)staging);
    atomicAdd(&g_euka_clocks[3], (unsigned long long)(k4 - k3 - staging));
    atomicAdd(&g_euka_clocks[4], (unsigned long long)(k5 - k4));
    atomicAdd(&g_euka_clocks[8], 1ull);
    if (rounds > 0) atomicAdd(&g_euka_clocks[10], 1ull);
    if (rounds == 2) atomicAdd(&g_euka_clocks[19], 1ull);
    atomicAdd(&g_euka_clocks[11 + rank],
              (unsigned long long)(k4 - k3 - staging));
  }
#endif
}

// The launch's shape for B rows of L columns of a table of maxlen rows on
// a card of `sms` SMs.
Geo geometry(long long B, int L, int maxlen, int sms) {
  Geo geo{};
  geo.G = L > 64 ? 32 : (L > 32 ? 16 : 8);
  geo.rpp = kThreads / geo.G;
  if (geo.G == 32) {
    const int chunks = (L + kChunkCols - 1) / kChunkCols;
    const int per_cta = (chunks + kMaxCluster - 1) / kMaxCluster;
    geo.nc = (chunks + per_cta - 1) / per_cta;
    geo.S = per_cta * kChunkCols;
  } else {
    geo.nc = 1;
    geo.S = 4 * geo.G;
  }
  if (geo.nc > 1) {
    geo.P = 2;  // two passes' rows fit the staged rows at 1,000 bp
  } else {  // the most rows a CTA that still leave ~3 CTAs an SM
    geo.P = kMaxReads / geo.rpp;
    const long long want = 3LL * sms;
    while (geo.P > 1 &&
           (B + geo.rpp * geo.P - 1) / (geo.rpp * geo.P) * geo.nc < want)
      geo.P >>= 1;
  }
  // the rows the shared memory holds beside the rows' tables, at most
  // both tables
  const int fit = (kSmemBytes - smem_fixed(geo.rpp * geo.P)) /
                  (8 * kRowStride) & ~3;
  const int both = (2 * maxlen + 3) & ~3;
  geo.cap = fit < both ? fit : both;
  return geo;
}

// The kernels' attributes (dynamic shared memory over 48 KB, all of the
// unified memory as shared), set once a device; *sms: its SM count, read
// then.
cudaError_t configure(int* sms) {
  static int count[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (count[dev] == 0) {
    const void* fns[2] = {(const void*)euka_score_kernel<true>,
                          (const void*)euka_score_kernel<false>};
    for (const void* f : fns) {
      err = cudaFuncSetAttribute(
          f, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
      if (err != cudaSuccess) return err;
      err = cudaFuncSetAttribute(
          f, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
      if (err != cudaSuccess) return err;
    }
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    count[dev] = n > 0 ? n : 1;
  }
  *sms = count[dev];
  return cudaSuccess;
}

bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

}  // namespace

extern "C" {

// (il [B], nl [B]) of B rows of L columns on `stream`. g, r, q, n_pos
// [B, L] and L_read [B] int32; pair_dist [B] f64; valid [B, L] uint8;
// sub5p, sub3p [maxlen, 4, 4], qtab [n_q], bfreq [n_bf], ttr [4, 4] f64.
// All device pointers, contiguous; il and nl may be two rows of one
// [2, B] tensor. B = 0 launches nothing. Returns the launch's CUDA error
// (0 = launched), or cudaErrorInvalidValue for arguments it cannot take.
int euka_score_launch(const int32_t* g, const int32_t* r, const int32_t* q,
                      const int32_t* n_pos, const int32_t* L_read,
                      const double* pair_dist, const uint8_t* valid,
                      const double* sub5p, const double* sub3p, int maxlen,
                      const double* qtab, int n_q, const double* bfreq,
                      int n_bf, const double* ttr, long long B, int L,
                      double* il, double* nl, void* stream) {
  if (B < 0 || L < 0 || maxlen < 1 || n_q < 1 || n_bf < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  int sms = 0;
  cudaError_t err = configure(&sms);
  if (err != cudaSuccess) return (int)err;
  const Geo geo = geometry(B, L, maxlen, sms);
  const long long R = (long long)geo.rpp * geo.P;
  const long long ctas = (B + R - 1) / R * geo.nc;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Args a{g,     r,    q,     n_pos, L_read, pair_dist, valid,
               sub5p, sub3p, maxlen, qtab, n_q,   bfreq,     n_bf,
               ttr,   B,    L,     il,    nl};
  const bool vec = !kScalarLoads && L % 4 == 0 && aligned(g, 16) &&
                   aligned(r, 16) && aligned(q, 16) && aligned(n_pos, 16) &&
                   aligned(valid, 4);
  const void* fn = vec ? (const void*)euka_score_kernel<true>
                       : (const void*)euka_score_kernel<false>;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3((unsigned)ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = geo.nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = geo.nc > 1 ? 1 : 0;
  void* params[2] = {(void*)&a, (void*)&geo};
  err = cudaLaunchKernelExC(&cfg, fn, params);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The launch's shape and the card's occupancy for B rows of L columns
// (damage tables of 1,000 rows), into out[11]: G (lanes a row), nc (CTAs
// a cluster), S (columns a CTA of a row), P (passes), rows a CTA, CTAs,
// CTAs an SM (the 16-byte-load kernel's occupancy), its registers a
// thread, its local (spill) bytes a thread, its dynamic shared bytes a
// CTA, the staged table rows a CTA holds. Returns a CUDA error (0 =
// done).
int euka_score_config(long long B, int L, int* out) {
  if (B < 0 || L < 0) return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = configure(&sms);
  if (err != cudaSuccess) return (int)err;
  const Geo geo = geometry(B > 0 ? B : 1, L, 1000, sms);
  const long long R = (long long)geo.rpp * geo.P;
  cudaFuncAttributes fa{};
  const void* fn = (const void*)euka_score_kernel<true>;
  err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fn, kThreads, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const long long ctas = (B + R - 1) / R * geo.nc;
  out[0] = geo.G;
  out[1] = geo.nc;
  out[2] = geo.S;
  out[3] = geo.P;
  out[4] = (int)R;
  out[5] = (int)(ctas < INT_MAX ? ctas : INT_MAX);
  out[6] = per_sm;
  out[7] = fa.numRegs;
  out[8] = (int)fa.localSizeBytes;
  out[9] = kSmemBytes;
  out[10] = geo.cap;
  return 0;
}

#ifdef VGAN_EUKA_PHASE_CLOCKS
// The cycles summed since the last call (see g_euka_clocks) into
// out [20]; then clears them. Returns a CUDA error code.
int euka_phase_clocks(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_euka_clocks,
                                       sizeof(g_euka_clocks));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[kClocks] = {};
  return (int)cudaMemcpyToSymbol(g_euka_clocks, zero, sizeof(zero));
}
#endif

}  // extern "C"
