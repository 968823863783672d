// keelime's batched suffix/prefix overlap scans for Hopper (sm_90a): every
// pair read by index from one sequence table, short pairs a warp each,
// long pairs a thread-block cluster each.
//
// Replaces the XLA program vgan_tpu/pipelines/keelime_device.py::
// _overlap_scores_device (:40-62) with its host winner rule (:107-124),
// and is the exact twin of the native host scan cpp/overlapbest.cpp::
// best_one (a copy of vgan_tpu/cpp/overlapbest.cpp). The plain PyTorch
// version is vgan_tpu_torch/pipelines/keelime_device.py::plain_indexed.
//
// What it computes, per pair i: a = the sequence ai[i] of the table, b =
// the sequence bi[i] (seq[off[k]:off[k+1]]),
//   score(s) = sum_{j < olen(s)} T[a[s + j], b[j]],  olen(s) = min(lb, la - s)
// with T the combined char-pair table (keelime._COMBINED), and
//   1. (0, 0.0) when la < min_olen or lb <= 0;
//   2. over the full-length block s in [0, la - lb] (when lb >= min_olen)
//      the max score; if max >= min_score the result is (lb, max);
//   3. else over the tail block s in [max(0, la - lb + 1), la - min_olen]
//      (olen = la - s < lb) the first start whose score >= min_score:
//      the largest qualifying olen, (olen, score); else (0, 0.0).
// T holds multiples of 0.5 only, so the kernels sum the doubled table in
// int32 (|2T| <= 12: a genome-length overlap stays far inside int32) and
// the result is score2 * 0.5 as f64, bit-identical to the f64 sums.
//
// The table. Both scans read the table's bytes and map them to the
// 16-code alphabet (the 15 characters of keelime._ALPHABET, then one code
// for every other byte, whose row and column of T are 0) through a
// 256-byte lut in shared memory as they stage a pair. The pairs reuse few
// contents (find_overlaps: ~9,000 distinct reads in ~785,000 pairs), so
// the table stays in L2 and a pair costs two int32 indices.
//
// Bound. A cell (one start, one overlap position) is at least a table
// lookup and an integer add: 2 lane operations, at 132 SMs x 128 lanes x
// 1.98 GHz. The cells are those best_one scans: the whole full-length
// block, and the tail block only when the full block fails, up to the
// winning start. The bytes are the table, its offsets, the two index
// arrays read once and the two outputs written once, over 3.35 TB/s. The
// operations bound both batches keelime runs (chip_smoke.py,
// overlap_bound_ms).
//
// overlap_warp_kernel: the pairs with la <= kLWarp, one warp a pair.
// * Grid-stride over the short pairs, 16 warps a block, three blocks an
//   SM; after the prologue no block barrier: a warp owns its pair and its
//   slice of shared memory.
// * The prologue builds a 64 KB pair table in shared memory,
//   ptab[(a0 | a1 << 4) | (b0 | b1 << 4) << 8] = T2[a0][b0] + T2[a1][b1]
//   (int8, |.| <= 24): one lookup scores two cells.
// * The slice holds a's codes (the zero code, whose row and column of T
//   are 0, past la) and b's first min(la, lb) codes as pair words: b's
//   codes two to a byte, in bytes 1 and 3 of a word of four.
// * A lane reads four a codes at once (two aligned words and a funnel
//   shift), folds them into two pair bytes (iv | iv >> 4) and ors in b's
//   pair word: two table indices, two lookups, four cells, ~11
//   instructions. b is the same for every lane, so a lookup's lanes
//   differ only in a's pair byte: few bank conflicts.
// * Full-length block of fewer than 32 starts (the 64-bp x 64-bp reads
//   of find_overlaps: one start): the lanes split the overlap positions,
//   __reduce_add_sync sums a start, the max over starts is kept in
//   registers (order-free). Otherwise a lane a start, __reduce_max_sync.
// * Tail block: a lane a start, 32 starts a chunk in best_one's order,
//   every lane summing the longest overlap of the chunk; positions past
//   la read the zero code, so each lane's sum is its own start's. The
//   first qualifying start is __ffs of a __ballot_sync; the scan stops
//   after the first chunk that holds one.
// * kLWarp = 256 (mirrored by keelime_device.L_WARP): a slice is 576
//   bytes, so three blocks' pair tables and slices fit an SM's shared
//   memory, and the warp kernel's longest pair stays short beside the
//   block kernel's.
// * What bounds it (PERF.md): the instructions issued a pair, much of
//   them the pair's metadata and staging, not latency: more warps an
//   SM, the metadata of 32 pairs loaded at once, or staging batched
//   ahead each left its time within a few per cent.
//
// overlap_best_kernel: the pairs with la > kLWarp (contig merges), one
// thread-block cluster of G CTAs a pair (G = 1, 2, 4, 8 or 16, chosen on
// the host by keelime_device.long_cluster_size so that every pair's
// cluster is resident at once; 16 is a non-portable size), the clusters
// striding over the pairs. A merge call holds 4-80 such pairs, so one
// block a pair left most SMs idle; the cluster splits each pair's work
// over G SMs, in one of two shapes, chosen per pair (the same in every
// CTA) by its estimated cost:
// * The position split: the pair's span L = min(la, lb) cut into chunks
//   of at least kMinChunk positions (fewer CTAs take part in a short
//   pair), a multiple of 4 each; CTA r owns chunk r. Rounds of starts in
//   best_one's order (the full-length block first, then the tail): in a
//   round CTA r scores every start over its chunk, a's window and b's
//   chunk staged in shared memory kTile positions at a time. A round is
//   narrow (kNarrow starts, the CTA's threads in kGroups groups each
//   taking a share of the chunk) or, where the chunk is short, wide
//   (kThreads starts, a thread a start over the whole chunk). Every CTA
//   leaves its int32 partial of each start in its own shared memory;
//   after ONE cluster barrier every CTA adds the G partials of each start
//   through distributed shared memory (map_shared_rank, kMaxCluster
//   remote reads in flight) and takes the same decision: the full
//   block's max over its rounds ((lb, max) once it is >= min_score after
//   the last), in the tail the smallest qualifying start of the first
//   round that has one. The partials are double-buffered by the rounds'
//   parity, so the next round's writes never meet a slower CTA's reads,
//   and a last cluster barrier keeps every CTA until no other can read
//   its memory. The partials cover disjoint positions and |2T| <= 12, so
//   they add up exactly, in any order, to best_one's sums. This is the
//   shape of two long contigs of about the same length, whose winner lies
//   in the first round or two.
// * The start split, for a full-length block of many starts over a short
//   b (a long contig against a short one: 15,000 starts of 776
//   positions): CTA r takes the starts [r * s_per, (r + 1) * s_per), a
//   thread a start over all of b (staged once where it fits a tile); the
//   CTAs meet once, at the max.
// Each thread scores four cells with two lookups of the 64 KB pair table
// (lane_sum, as the warp kernel does; the table is built once on the
// host side and copied in 16 bytes a load), with no barrier inside the
// cell loop. What bounds it: the cells of the pair's scanned rounds over
// G SMs at lane_sum's rate, plus per round the staging, the barriers and
// the remote reads; a call's time is its heaviest pair's.
//
// The class split (keelime_device.split_by_length) is torch ops on the
// card: `order` holds the short pairs first, then the long ones, each in
// index order, and n_short[0] their boundary. Both kernels read n_short
// on the card and write out[order[k]] themselves; only overlap_best_
// kernel's wrapper reads the long pairs' count back (one wait, behind
// the warp kernel) to choose G and size its grid.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCodes = 16;
constexpr uint8_t kZeroCode = 15;  // every byte outside the alphabet
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------- warp
constexpr int kLWarp = 256;  // the longest a of overlap_warp_kernel
constexpr int kWarps = 16;   // warps a block of overlap_warp_kernel
constexpr int kPadA = 40;    // zero codes past la: the widest overread
constexpr int kPairTab = 1 << 16;

constexpr int round16(int x) { return (x + 15) & ~15; }
// a warp's slice: a's codes, then b's pair words
constexpr int kSliceA = round16(kLWarp + kPadA + 8);
constexpr int kSlice = kSliceA + round16(kLWarp + 8);
// the pair table, T2 and the lut, then the warps' slices
constexpr int kWarpSmem = kPairTab + 2 * 256 + kWarps * kSlice;

// The doubled score of the start `s` over positions [0, round4(n)) of
// the warp's slice: a's codes `sa` (word aligned, the zero code past la)
// and b's pair words `sbw`. A word of four a codes becomes two pair bytes
// (a0 | a1 << 4, a2 | a3 << 4) in bytes 0 and 2, or'ed with b's pair
// bytes shifted into bytes 1 and 3: two indices of the pair table.
__device__ __forceinline__ int lane_sum(const uint8_t* sa,
                                        const uint32_t* sbw,
                                        const int8_t* ptab, int s, int n) {
  const uint32_t* aw = reinterpret_cast<const uint32_t*>(sa) + (s >> 2);
  const int sh = (s & 3) * 8;
  uint32_t lo = aw[0];
  int acc = 0;
  const int words = (n + 3) >> 2;
#pragma unroll 4
  for (int w = 0; w < words; ++w) {
    const uint32_t hi = aw[w + 1];
    uint32_t iv = __funnelshift_r(lo, hi, sh);  // a[s + 4w .. s + 4w + 3]
    lo = hi;
    iv |= iv >> 4;
    const uint32_t x = (iv & 0x00ff00ffu) | sbw[w];
    acc += ptab[x & 0xffff] + ptab[x >> 16];
  }
  return acc;
}

// The winner of one pair (a's codes staged in `sa`, b's pair words in
// `sbw`), the whole warp; lane 0 writes it.
__device__ __forceinline__ void scan_pair(const uint8_t* sa,
                                          const uint32_t* sbw,
                                          const int8_t* ptab, int la, int lb,
                                          long long min_olen,
                                          double min_score, int lane,
                                          int64_t* out_len,
                                          double* out_score) {
  // full-length block: starts where the whole of b fits inside a
  const int n_full = la - lb + 1;
  if (n_full > 0 && lb >= min_olen) {
    int best2;
    if (n_full < 32) {  // the lanes split the positions of a start
      best2 = INT_MIN;
      for (int s = 0; s < n_full; ++s) {
        int acc = 0;
        for (int j = lane; j < lb; j += 32) {
          // b[j]: nibble j & 1 of pair byte 1 or 3 of word j / 4
          const uint32_t bj = sbw[j >> 2] >> (8 + ((j & 2) << 3) + ((j & 1) << 2));
          acc += ptab[sa[s + j] | (bj & 15) << 8 | 0xf0f0];
        }
        best2 = max(best2, __reduce_add_sync(kFull, acc));
      }
    } else {  // a lane a start
      int m = INT_MIN;
      for (int s0 = 0; s0 < n_full; s0 += 32) {
        const int s = s0 + lane;
        const int acc = lane_sum(sa, sbw, ptab, s, lb);
        if (s < n_full) m = max(m, acc);
      }
      best2 = __reduce_max_sync(kFull, m);
    }
    const double best = static_cast<double>(best2) * 0.5;
    if (best >= min_score) {
      if (lane == 0) {
        *out_len = lb;
        *out_score = best;
      }
      return;
    }
  }

  // tail block: olen = la - s < lb; the first qualifying start wins
  const int t0 = n_full > 0 ? n_full : 0;
  const int hi = la - (int)min_olen + 1;
  for (int s0 = t0; s0 < hi; s0 += 32) {
    const int s = s0 + lane;
    const int acc = lane_sum(sa, sbw, ptab, s, la - s0);
    const double sc = static_cast<double>(acc) * 0.5;
    const unsigned ok = __ballot_sync(kFull, s < hi && sc >= min_score);
    if (ok) {
      if (lane == __ffs(ok) - 1) {
        *out_len = la - s;
        *out_score = sc;
      }
      return;
    }
  }
  if (lane == 0) {
    *out_len = 0;
    *out_score = 0.0;
  }
}

__global__ void __launch_bounds__(kWarps * 32, 3)
overlap_warp_kernel(const uint8_t* __restrict__ seq,
                    const int64_t* __restrict__ off,
                    const int32_t* __restrict__ ai,
                    const int32_t* __restrict__ bi,
                    const int32_t* __restrict__ order,
                    const int32_t* __restrict__ n_short,
                    const uint8_t* __restrict__ lut,
                    const int8_t* __restrict__ table2,
                    long long min_olen, double min_score,
                    int64_t* __restrict__ out_len,
                    double* __restrict__ out_score) {
  extern __shared__ __align__(16) uint8_t smem[];
  // the pair table: ptab[(a0 | a1 << 4) | (b0 | b1 << 4) << 8] =
  // T2[a0][b0] + T2[a1][b1] (|.| <= 24); a single cell is the pair with
  // a1 = b1 = the zero code
  int8_t* ptab = reinterpret_cast<int8_t*>(smem);
  int8_t* t2s = ptab + kPairTab;
  uint8_t* slut = smem + kPairTab + 256;
  for (int k = threadIdx.x; k < 256; k += blockDim.x) {
    t2s[k] = table2[k];
    slut[k] = lut[k];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < kPairTab; k += blockDim.x) {
    ptab[k] = t2s[(k & 15) * kCodes + ((k >> 8) & 15)]
              + t2s[((k >> 4) & 15) * kCodes + (k >> 12)];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint8_t* sa = smem + kPairTab + 2 * 256 + warp * kSlice;
  uint32_t* sbw = reinterpret_cast<uint32_t*>(sa + kSliceA);
  const int n = *n_short;
  const int stride = gridDim.x * kWarps;
  for (int k = blockIdx.x * kWarps + warp; k < n; k += stride) {
    const int i = order[k];
    const int64_t oa = off[ai[i]];
    const int64_t ob = off[bi[i]];
    const int la = (int)(off[ai[i] + 1] - oa);  // <= kLWarp
    const int64_t lbl = off[bi[i] + 1] - ob;
    if (la < min_olen || lbl <= 0) {
      if (lane == 0) {
        out_len[i] = 0;
        out_score[i] = 0.0;
      }
      continue;
    }
    // no overlap reaches past b[la - 1]: la + 1 stands for any longer b
    const int lb = lbl > la ? la + 1 : (int)lbl;
    const int nb = lb < la ? lb : la;  // the b codes read
    __syncwarp();  // the previous pair's reads of the slice are done
    for (int p = lane; p < la + kPadA; p += 32) {
      sa[p] = p < la ? slut[seq[oa + p]] : kZeroCode;
    }
    for (int w = lane; w <= (nb + 3) >> 2; w += 32) {
      uint32_t c[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = 4 * w + q;
        c[q] = j < nb ? slut[seq[ob + j]] : kZeroCode;
      }
      sbw[w] = ((c[0] | c[1] << 4) << 8) | ((c[2] | c[3] << 4) << 24);
    }
    __syncwarp();
    scan_pair(sa, sbw, ptab, la, lb, min_olen, min_score, lane,
              out_len + i, out_score + i);
  }
}

// ---------------------------------------------------------------- cluster
constexpr int kThreads = 512;  // threads a CTA of overlap_best_kernel
constexpr int kNarrow = 128;   // starts a narrow round
constexpr int kGroups = kThreads / kNarrow;  // position groups a narrow round
constexpr int kTile = 2048;    // overlap positions a CTA stages at once
constexpr int kMinChunk = 256;  // the fewest positions a CTA of a cluster takes
constexpr int kMaxCluster = 16;  // remote reads kept in flight at once
// Costs in cells a thread, by which a pair's scan picks its shape: a
// round of the position split pays ~kRoundCost beside its cells (the
// staging, the block barriers, one cluster barrier, the remote reads), a
// round of the full block's start split ~kStageCost (its staging and two
// block barriers).
constexpr int kRoundCost = 512;
constexpr int kStageCost = 256;

// A CTA's shared memory after its pair table.
struct LongSmem {
  uint8_t lut[256];
  uint8_t sa[kThreads + kTile + 16];  // a's codes from s0 + jt
  uint32_t sbw[kTile / 4 + 4];        // b's pair words from jt
  int red[kGroups - 1][kNarrow];  // a narrow round: groups 1.. partials
  int part[2][kThreads];    // the CTA's partials, by the round's parity
  int wred[kThreads / 32];  // warp results
};
constexpr int kLongSmem = kPairTab + (int)sizeof(LongSmem);

// Stages a's codes [g0, g0 + n) (the zero code from la on) into sm.sa and,
// unless `a_only`, b's pair words for positions [jt, jt + tl) (the zero
// code from L on) into sm.sbw. Every thread of the CTA calls it, between
// barriers.
__device__ __forceinline__ void stage(LongSmem& sm, const uint8_t* a,
                                      int la, long long g0, int n,
                                      const uint8_t* b, int L, int jt,
                                      int tl, bool a_only) {
  for (int p = threadIdx.x; p < n; p += kThreads) {
    const long long g = g0 + p;
    sm.sa[p] = g < la ? sm.lut[a[g]] : kZeroCode;
  }
  if (a_only) return;
  for (int w = threadIdx.x; w <= (tl + 3) >> 2; w += kThreads) {
    uint32_t c[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = jt + 4 * w + k;
      c[k] = j < L ? sm.lut[b[j]] : kZeroCode;
    }
    sm.sbw[w] = ((c[0] | c[1] << 4) << 8) | ((c[2] | c[3] << 4) << 24);
  }
}

// The sum (or the max) over the cluster's G CTAs of their ints at `p`,
// an address in this CTA's shared memory: kMaxCluster remote reads in
// flight at once.
template <bool kMax>
__device__ __forceinline__ int cluster_reduce(cg::cluster_group& cluster,
                                              int* p, int G) {
  int acc = kMax ? INT_MIN : 0;
  for (int r0 = 0; r0 < G; r0 += kMaxCluster) {
    int v[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      v[r] = r0 + r < G ? *cluster.map_shared_rank(p, r0 + r)
                        : (kMax ? INT_MIN : 0);
    }
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      acc = kMax ? max(acc, v[r]) : acc + v[r];
    }
  }
  return acc;
}

// The max over the CTA of each thread's `v` (INT_MIN for none), for every
// thread. Every thread of the CTA calls it.
__device__ __forceinline__ int block_max(LongSmem& sm, int v) {
  v = __reduce_max_sync(kFull, v);
  __syncthreads();  // the previous reads of sm.wred are done
  if ((threadIdx.x & 31) == 0) sm.wred[threadIdx.x >> 5] = v;
  __syncthreads();
  for (int w = 0; w < kThreads / 32; ++w) v = max(v, sm.wred[w]);
  return v;
}

// One round of the position split: the CTA's doubled partial sums of the
// starts s0 + t (t < S, S = kNarrow or kThreads) over its positions
// [j0, e), a's window and b's positions staged a tile of kTile at a
// time. A narrow round has kGroups groups of kNarrow threads, group q
// taking its share of each tile; a wide round a thread a start over the
// whole tile. Positions past la read a's zero code, past L = min(la, lb) b's.
// Leaves the CTA's partial of start s0 + t in out[t]. Every thread of the
// CTA calls it.
__device__ void round_partials(LongSmem& sm, const int8_t* ptab,
                               const uint8_t* a, int la, const uint8_t* b,
                               int L, int s0, int j0, int e, int S,
                               int* out) {
  const int groups = kThreads / S;
  const int q = threadIdx.x / S;
  const int t = threadIdx.x % S;
  int acc = 0;
  for (int jt = j0; jt < e; jt += kTile) {
    const int tl = min(kTile, e - jt);
    __syncthreads();  // the previous tile's reads are done
    stage(sm, a, la, (long long)s0 + jt, S + tl + 12, b, L, jt, tl, false);
    __syncthreads();
    // group q: the positions [q * sl, min((q + 1) * sl, tl)) of the tile
    const int sl = ((tl + groups - 1) / groups + 3) & ~3;
    const int lo = q * sl;
    const int nq = min(sl, tl - lo);
    if (nq > 0) acc += lane_sum(sm.sa + lo, sm.sbw + (lo >> 2), ptab, t, nq);
  }
  if (groups == 1) {
    out[t] = acc;
    return;
  }
  if (q > 0) sm.red[q - 1][t] = acc;
  __syncthreads();
  if (q == 0) {
#pragma unroll
    for (int g = 0; g < kGroups - 1; ++g) acc += sm.red[g][t];
    out[t] = acc;
  }
}

// The full block's start split: the max of the doubled sums of the
// starts [s_lo, s_hi) over all of b's lb positions, a thread a start,
// kThreads starts a round, b staged once where it fits a tile. Returns
// the thread's max (INT_MIN where it had no start). Every thread of the
// CTA calls it.
__device__ int full_block_starts(LongSmem& sm, const int8_t* ptab,
                                 const uint8_t* a, int la, const uint8_t* b,
                                 int lb, int s_lo, int s_hi) {
  int m = INT_MIN;
  for (int s0 = s_lo; s0 < s_hi; s0 += kThreads) {
    int acc = 0;
    for (int jt = 0; jt < lb; jt += kTile) {
      const int tl = min(kTile, lb - jt);
      __syncthreads();  // the previous tile's reads are done
      stage(sm, a, la, (long long)s0 + jt, kThreads + tl + 12, b, lb, jt, tl,
            s0 > s_lo && lb <= kTile);
      __syncthreads();
      acc += lane_sum(sm.sa, sm.sbw, ptab, threadIdx.x, tl);
    }
    if (s0 + (int)threadIdx.x < s_hi) m = max(m, acc);
  }
  return m;
}

// Pair (a, b), the whole cluster; rank 0 writes the result. la >=
// min_olen and lb >= 1 (lb cut to la + 1 where b is longer). `par` is the
// parity of the cluster's rounds so far (the same in all its CTAs): a
// round's partials go to sm.part[par], so that the next round's writes
// never meet a slower CTA's reads of this one. Every CTA reads all G
// partials and takes the same decision, so one cluster barrier a round
// suffices.
__device__ void scan_long_pair(LongSmem& sm, const int8_t* ptab,
                               cg::cluster_group& cluster, int G, int rank,
                               const uint8_t* a, int la, const uint8_t* b,
                               int lb, long long min_olen, double min_score,
                               int64_t* out_len, double* out_score,
                               int& par) {
  const int tid = threadIdx.x;
  const bool writer = rank == 0;
  // this CTA's positions: chunks of at least kMinChunk, a multiple of 4
  const int L = min(la, lb);
  const int g_eff = max(1, min(G, L / kMinChunk));
  const long long C = ((L + g_eff - 1) / g_eff + 3) & ~3;
  const int j0 = (int)min(rank * C, (long long)L);
  const int j1 = (int)min((rank + 1) * C, (long long)L);
  // a round is wide (kThreads starts, a thread a start over the CTA's
  // whole chunk) where its cells a thread stay under ~kGroups x
  // kRoundCost, else narrow (kNarrow starts, kGroups groups splitting the
  // chunk)
  const int S = C < kGroups * kRoundCost ? kThreads : kNarrow;

  // full-length block: starts where the whole of b fits inside a
  const int n_full = la - lb + 1;
  if (n_full > 0 && lb >= min_olen) {
    int best2;
    const int s_per = (n_full + G - 1) / G;
    if ((long long)((s_per + kThreads - 1) / kThreads) * (kStageCost + lb)
        < (long long)((n_full + S - 1) / S)
              * (kRoundCost + (S == kNarrow ? (int)C / kGroups : (int)C))) {
      // the start split (a long contig against a short one): CTA r takes
      // starts [r * s_per, (r + 1) * s_per) over all of b, no barrier
      // between the CTAs until their maxima
      const int lo = min(n_full, rank * s_per);
      const int m = block_max(sm, full_block_starts(
                                      sm, ptab, a, la, b, lb, lo,
                                      min(n_full, lo + s_per)));
      if (tid == 0) sm.part[par][0] = m;
      cluster.sync();  // every CTA's max is in
      // (block_max's reads of sm.wred ended before the cluster barrier)
      if (tid == 0) {
        sm.wred[0] = cluster_reduce<true>(cluster, sm.part[par], G);
      }
      __syncthreads();
      best2 = sm.wred[0];
      par ^= 1;
    } else {  // the position split: CTA r sums its chunk of every start
      best2 = INT_MIN;
      for (int s0 = 0; s0 < n_full; s0 += S) {
        round_partials(sm, ptab, a, la, b, L, s0, j0, min(j1, lb), S,
                       sm.part[par]);
        cluster.sync();  // every CTA's partials are in
        const int tot = tid < S ? cluster_reduce<false>(
                                      cluster, sm.part[par] + tid, G)
                                : 0;
        best2 = max(best2, block_max(sm, tid < S && s0 + tid < n_full
                                             ? tot : INT_MIN));
        par ^= 1;
      }
    }
    const double best = static_cast<double>(best2) * 0.5;
    if (best >= min_score) {  // the same in every CTA
      if (writer && tid == 0) {
        *out_len = lb;
        *out_score = best;
      }
      return;
    }
  }

  // tail block: olen = la - s < lb; the first qualifying start wins
  const int t0 = n_full > 0 ? n_full : 0;
  const int hi = la - (int)min_olen + 1;
  for (int s0 = t0; s0 < hi; s0 += S) {
    round_partials(sm, ptab, a, la, b, L, s0, j0, min(j1, la - s0), S,
                   sm.part[par]);
    cluster.sync();
    const int tot = tid < S ? cluster_reduce<false>(
                                  cluster, sm.part[par] + tid, G)
                            : 0;
    par ^= 1;
    const bool ok = tid < S && s0 + tid < hi
                    && static_cast<double>(tot) * 0.5 >= min_score;
    // the first qualifying start of the round: kThreads - the max of
    // kThreads - t over the qualifying t (0: none)
    const int first = kThreads - block_max(sm, ok ? kThreads - tid : 0);
    if (first < kThreads) {  // the same in every CTA
      if (writer && tid == first) {
        *out_len = la - (s0 + tid);
        *out_score = static_cast<double>(tot) * 0.5;
      }
      return;
    }
  }
  if (writer && tid == 0) {
    *out_len = 0;
    *out_score = 0.0;
  }
}

__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
overlap_best_kernel(const uint8_t* __restrict__ seq,
                    const int64_t* __restrict__ off,
                    const int32_t* __restrict__ ai,
                    const int32_t* __restrict__ bi,
                    const int32_t* __restrict__ order,
                    const int32_t* __restrict__ n_short, int n,
                    const uint8_t* __restrict__ lut,
                    const int8_t* __restrict__ pair_table,
                    long long min_olen, double min_score,
                    int64_t* __restrict__ out_len,
                    double* __restrict__ out_score) {
  extern __shared__ __align__(16) uint8_t smem[];
  int8_t* ptab = reinterpret_cast<int8_t*>(smem);
  LongSmem& sm = *reinterpret_cast<LongSmem*>(smem + kPairTab);
  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  // the pair table (built once on the host side), 16 bytes a load
  const uint4* src = reinterpret_cast<const uint4*>(pair_table);
  uint4* dst = reinterpret_cast<uint4*>(smem);
  for (int k = threadIdx.x; k < kPairTab / 16; k += kThreads) {
    dst[k] = src[k];
  }
  for (int k = threadIdx.x; k < 256; k += kThreads) sm.lut[k] = lut[k];
  // (the first staging barrier orders these before any read)
  int par = 0;
  const int n_clusters = gridDim.x / G;
  for (int k = *n_short + (int)blockIdx.x / G; k < n; k += n_clusters) {
    const int i = order[k];
    const int64_t oa = off[ai[i]];
    const int64_t ob = off[bi[i]];
    const int64_t la = off[ai[i] + 1] - oa;
    const int64_t lb = off[bi[i] + 1] - ob;
    if (la < min_olen || lb <= 0) {  // the same for the whole cluster
      if (rank == 0 && threadIdx.x == 0) {
        out_len[i] = 0;
        out_score[i] = 0.0;
      }
      continue;
    }
    // no overlap reaches past b[la - 1]: la + 1 stands for any longer b
    scan_long_pair(sm, ptab, cluster, G, rank, seq + oa, (int)la, seq + ob,
                   lb > la ? (int)la + 1 : (int)lb, min_olen, min_score,
                   out_len + i, out_score + i, par);
  }
  // no CTA leaves while another may still read its partials
  cluster.sync();
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// Blocks of overlap_warp_kernel an SM on the current device: the
// function's attributes set on the first launch there.
int warp_blocks_per_sm() {
  static int per_sm[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 0;
  if (per_sm[dev] > 0) return per_sm[dev];
  if (cudaFuncSetAttribute(overlap_warp_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kWarpSmem) != cudaSuccess) {
    return 0;
  }
  // all of the SM's unified memory as shared: three blocks' pair tables
  if (cudaFuncSetAttribute(overlap_warp_kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared) != cudaSuccess) {
    return 0;
  }
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, overlap_warp_kernel, kWarps * 32, kWarpSmem) != cudaSuccess) {
    return 0;
  }
  per_sm[dev] = n;
  return n;
}

// The kernel's attributes (the dynamic shared memory, clusters over 8
// allowed) set once a device, and its launch configuration: `clusters`
// clusters of G CTAs.
cudaError_t configure_long(int G, long long clusters, cudaStream_t stream,
                           cudaLaunchAttribute* attr,
                           cudaLaunchConfig_t* cfg) {
  static bool done[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        overlap_best_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kLongSmem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(overlap_best_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = G;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)(clusters * G));
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = kLongSmem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The pairs order[0:n_short[0]] (each with la <= kLWarp) of the n pairs
// (seq[off[ai[i]]:off[ai[i]+1]], seq[off[bi[i]]:off[bi[i]+1]]), a warp
// each, on `stream`; lut: [256] uint8, each byte's code; table2: [16, 16]
// int8, the doubled table T2[a][b]. Returns cudaGetLastError() (0 =
// launched), or cudaErrorInvalidValue for a batch it cannot hold.
int overlap_warp_launch(const uint8_t* seq, const int64_t* off,
                        const int32_t* ai, const int32_t* bi,
                        const int32_t* order, const int32_t* n_short,
                        int64_t n, const uint8_t* lut, const int8_t* table2,
                        int64_t min_olen, double min_score, int64_t* out_len,
                        double* out_score, void* stream) {
  if (n <= 0) return 0;
  if (n > INT_MAX) return (int)cudaErrorInvalidValue;
  const int per_sm = warp_blocks_per_sm();
  if (per_sm < 1) {
    const cudaError_t e = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : cudaErrorInvalidValue);
  }
  const long long need = (n + kWarps - 1) / kWarps;
  const long long most = (long long)per_sm * sm_count();
  overlap_warp_kernel<<<(int)(need < most ? need : most), kWarps * 32,
                        kWarpSmem, (cudaStream_t)stream>>>(
      seq, off, ai, bi, order, n_short, lut, table2, (long long)min_olen,
      min_score, out_len, out_score);
  return (int)cudaGetLastError();
}

// The pairs order[n_short[0]:n] of the same layout (each with la >
// kLWarp, every sequence shorter than 2^31 bytes), one cluster of
// `cluster` CTAs a pair, `clusters` clusters striding over them, on
// `stream`; lut as above; pair_table: [65536] int8, the pair table of
// overlap_warp_kernel's prologue (16-byte aligned). Returns 0 when
// launched, or the error: cudaErrorInvalidValue for a batch or grid it
// cannot hold, else what the card says (a cluster size or shared memory
// it refuses included); nothing falls back to a smaller cluster.
int overlap_best_launch(const uint8_t* seq, const int64_t* off,
                        const int32_t* ai, const int32_t* bi,
                        const int32_t* order, const int32_t* n_short,
                        int64_t n, const uint8_t* lut,
                        const int8_t* pair_table, int64_t min_olen,
                        double min_score, int64_t* out_len,
                        double* out_score, int cluster, int64_t clusters,
                        void* stream) {
  if (n <= 0) return 0;
  if (n > INT_MAX || cluster < 1 || clusters < 1
      || clusters * cluster > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = configure_long(cluster, clusters, (cudaStream_t)stream,
                                   &attr, &cfg);
  if (err == cudaSuccess) {
    err = cudaLaunchKernelEx(&cfg, overlap_best_kernel, seq, off, ai, bi,
                             order, n_short, (int)n, lut, pair_table,
                             (long long)min_olen, min_score, out_len,
                             out_score);
  }
  // read (and so clear) the error state: a refused launch must not be
  // reported again by the next launch's check
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// How many clusters of `cluster` CTAs of overlap_best_kernel the current
// device holds at once, into *out (cudaOccupancyMaxActiveClusters).
// Returns 0 or the CUDA error.
int overlap_best_max_active_clusters(int cluster, int* out) {
  if (cluster < 1) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = configure_long(cluster, 1, 0, &attr, &cfg);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveClusters(
        out, (const void*)overlap_best_kernel, &cfg);
  }
  cudaGetLastError();  // a refused size leaves no error for the next launch
  return (int)err;
}

}  // extern "C"
