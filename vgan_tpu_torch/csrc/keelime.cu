// keelime's batched suffix/prefix overlap scans for Hopper (sm_90a): every
// pair read by index from one sequence table, short pairs a warp each,
// long pairs a block each.
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
// 128-thread block a pair, grid-stride over them. A block walks its
// starts in tiles of 128, a thread a start; a start tile runs over the
// overlap in tiles of 256 positions staged in shared memory; the full
// block reduces by a shared atomicMax, the tail by a shared atomicMin of
// the qualifying starts, stopping after the first tile that holds one.
//
// The class split (keelime_device.split_by_length) is torch ops on the
// card: `order` holds the short pairs first, then the long ones, each in
// index order, and n_short[0] their boundary. Both kernels read n_short
// on the card and write out[order[k]] themselves, so nothing waits on
// the host.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

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

// ---------------------------------------------------------------- block
constexpr int kThreads = 128;  // starts a tile, threads a block
constexpr int kTileJ = 256;    // overlap positions a tile

struct Smem {
  int t2[kCodes * kCodes];
  uint8_t lut[256];
  uint8_t sa[kThreads + kTileJ];
  uint8_t sb[kTileJ];
  int best2;
  long long first;
};

// The doubled score of start s0 + threadIdx.x over its first `olen`
// positions (olen <= 0: nothing), for a start tile whose longest overlap is
// `olen_max` (the same for the whole block). Every thread of the block
// must call it: it stages tiles in shared memory between barriers.
__device__ int tile_scores(Smem& sm, const uint8_t* a, long long la,
                           const uint8_t* b, long long s0,
                           long long olen_max, long long olen) {
  const int tid = threadIdx.x;
  int acc = 0;
  for (long long j0 = 0; j0 < olen_max; j0 += kTileJ) {
    __syncthreads();  // the previous tile's reads are done
    for (int k = tid; k < kTileJ; k += kThreads) {
      const long long j = j0 + k;
      sm.sb[k] = j < olen_max ? sm.lut[b[j]] : 0;
    }
    for (int k = tid; k < kThreads + kTileJ; k += kThreads) {
      const long long p = s0 + j0 + k;
      sm.sa[k] = p < la ? sm.lut[a[p]] : 0;
    }
    __syncthreads();
    const long long left = olen - j0;
    const int jn = left < kTileJ ? (left > 0 ? (int)left : 0) : kTileJ;
    for (int jj = 0; jj < jn; ++jj) {
      acc += sm.t2[sm.sa[tid + jj] * kCodes + sm.sb[jj]];
    }
  }
  return acc;
}

// Pair i, the whole block; the results are written by one thread.
__device__ void best_one_block(Smem& sm, const uint8_t* a, long long la,
                               const uint8_t* b, long long lb,
                               long long min_olen, double min_score,
                               int64_t* out_len, double* out_score) {
  const int tid = threadIdx.x;
  if (la < min_olen || lb <= 0) {  // the same for the whole block
    if (tid == 0) {
      *out_len = 0;
      *out_score = 0.0;
    }
    return;
  }
  __syncthreads();  // the previous pair's reads of the two slots are done
  if (tid == 0) {
    sm.best2 = INT_MIN;
    sm.first = LLONG_MAX;
  }
  // (tile_scores starts with a barrier: the two reduction slots are set
  // before any thread reads them)

  // full-length block: starts where the whole of b fits inside a
  const long long n_full = la - lb + 1;
  if (n_full > 0 && lb >= min_olen) {
    for (long long s0 = 0; s0 < n_full; s0 += kThreads) {
      const bool active = s0 + tid < n_full;
      const int acc = tile_scores(sm, a, la, b, s0, lb, active ? lb : 0);
      if (active) atomicMax(&sm.best2, acc);
    }
    __syncthreads();
    const double best = static_cast<double>(sm.best2) * 0.5;
    if (best >= min_score) {  // the same for the whole block
      if (tid == 0) {
        *out_len = lb;
        *out_score = best;
      }
      return;
    }
  }

  // tail block: olen = la - s < lb; the first qualifying start wins
  const long long t0 = n_full > 0 ? n_full : 0;
  const long long hi = la - min_olen + 1;
  for (long long s0 = t0; s0 < hi; s0 += kThreads) {
    const long long s = s0 + tid;
    const bool active = s < hi;
    const long long olen = la - s;
    const int acc = tile_scores(sm, a, la, b, s0, la - s0,
                                active ? olen : 0);
    const double sc = static_cast<double>(acc) * 0.5;
    if (active && sc >= min_score && olen >= min_olen) {
      atomicMin(&sm.first, s);
    }
    __syncthreads();
    const long long first = sm.first;
    if (first != LLONG_MAX) {  // the same for the whole block
      if (s == first) {
        *out_len = olen;
        *out_score = sc;
      }
      return;
    }
  }
  if (tid == 0) {
    *out_len = 0;
    *out_score = 0.0;
  }
}

__global__ void __launch_bounds__(kThreads)
overlap_best_kernel(const uint8_t* __restrict__ seq,
                    const int64_t* __restrict__ off,
                    const int32_t* __restrict__ ai,
                    const int32_t* __restrict__ bi,
                    const int32_t* __restrict__ order,
                    const int32_t* __restrict__ n_short, int n,
                    const uint8_t* __restrict__ lut,
                    const int* __restrict__ table2, long long min_olen,
                    double min_score, int64_t* __restrict__ out_len,
                    double* __restrict__ out_score) {
  __shared__ Smem sm;
  for (int k = threadIdx.x; k < kCodes * kCodes; k += kThreads) {
    sm.t2[k] = table2[k];
    sm.lut[k] = lut[k];
  }
  // (best_one_block barriers before the tables are read)
  for (int k = *n_short + blockIdx.x; k < n; k += gridDim.x) {
    const int i = order[k];
    const int64_t oa = off[ai[i]];
    const int64_t ob = off[bi[i]];
    best_one_block(sm, seq + oa, off[ai[i] + 1] - oa, seq + ob,
                   off[bi[i] + 1] - ob, min_olen, min_score, out_len + i,
                   out_score + i);
  }
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

// The pairs order[n_short[0]:n] of the same layout, a 128-thread block
// each, on `stream`; lut as above; table2: [16, 16] int32, the doubled
// table. Returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a batch the grid cannot hold.
int overlap_best_launch(const uint8_t* seq, const int64_t* off,
                        const int32_t* ai, const int32_t* bi,
                        const int32_t* order, const int32_t* n_short,
                        int64_t n, const uint8_t* lut, const int* table2,
                        int64_t min_olen, double min_score, int64_t* out_len,
                        double* out_score, void* stream) {
  if (n <= 0) return 0;
  if (n > INT_MAX) return (int)cudaErrorInvalidValue;
  const long long most = 16LL * sm_count();
  overlap_best_kernel<<<(int)(n < most ? n : most), kThreads, 0,
                        (cudaStream_t)stream>>>(
      seq, off, ai, bi, order, n_short, (int)n, lut, table2,
      (long long)min_olen, min_score, out_len, out_score);
  return (int)cudaGetLastError();
}

}  // extern "C"
