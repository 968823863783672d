// keelime's batched suffix/prefix overlap scans, one launch a pair list,
// for Hopper (sm_90a).
//
// Replaces the XLA program vgan_tpu/pipelines/keelime_device.py::
// _overlap_scores_device (:40-62) with its host winner rule (:107-124),
// and is the exact twin of the native host scan cpp/overlapbest.cpp::
// best_one (a copy of vgan_tpu/cpp/overlapbest.cpp). The plain PyTorch
// version is vgan_tpu_torch/pipelines/keelime_device.py::
// overlap_scores_batch.
//
// What it computes, per pair (a, b) of the ragged list (latin-1 bytes):
//   score(s) = sum_{j < olen(s)} T[a[s + j], b[j]],  olen(s) = min(lb, la - s)
// with T the combined char-pair table (keelime._COMBINED), and
//   1. (0, 0.0) when la < min_olen or lb <= 0;
//   2. over the full-length block s in [0, la - lb] (when lb >= min_olen)
//      the max score; if max >= min_score the result is (lb, max);
//   3. else over the tail block s in [max(0, la - lb + 1), la - min_olen]
//      (olen = la - s < lb) the first start whose score >= min_score:
//      the largest qualifying olen, (olen, score); else (0, 0.0).
// T holds multiples of 0.5 only, so the kernel sums the doubled table in
// int32 (|2T| <= 12: a genome-length overlap stays far inside int32) and
// the result is score2 * 0.5 as f64, bit-identical to the f64 sums.
//
// Bound. A cell (one start, one overlap position) is at least a table
// lookup and an integer add: 2 lane operations, at 132 SMs x 128 lanes x
// 1.98 GHz. The cells are those best_one scans: the whole full-length
// block, and the tail block only when the full block fails, up to the
// winning start. The bytes are every pair's characters and offsets read
// once and the two outputs written once, over 3.35 TB/s. For the 64-bp
// reads of find_overlaps the operations bound it; the host counts both
// (chip_smoke.py, overlap_bound_ms).
//
// Design (simple and right first, not fast):
// * One thread block per pair, 128 threads; the block walks its starts in
//   tiles of 128, a thread a start.
// * The prologue copies the byte -> 16-code map (the 15 characters of
//   keelime._ALPHABET, then one code for every other byte, whose row and
//   column of the table are 0) and the 16 x 16 doubled table into shared
//   memory.
// * A start tile runs over the overlap in tiles of 256 positions: the b
//   codes of the tile and the a codes under all 128 starts (128 + 256
//   bytes) are staged in shared memory, then each thread adds its start's
//   cells from there. Any length fits: nothing is sized by the pair.
// * The full block reduces by a shared atomicMax of the int32 sums, the
//   tail block by a shared atomicMin of the qualifying starts, tile by
//   tile, stopping after the first tile that holds one (best_one's early
//   exit). Both reductions are order-free, so the result does not depend
//   on the schedule.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // starts a tile, threads a block
constexpr int kTileJ = 256;    // overlap positions a tile
constexpr int kCodes = 16;

struct Smem {
  uint8_t lut[256];
  int t2[kCodes * kCodes];
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

__global__ void __launch_bounds__(kThreads)
overlap_best_kernel(const uint8_t* __restrict__ abuf,
                    const int64_t* __restrict__ aoff,
                    const uint8_t* __restrict__ bbuf,
                    const int64_t* __restrict__ boff,
                    const uint8_t* __restrict__ lut,
                    const int* __restrict__ table2, long long min_olen,
                    double min_score, int64_t* __restrict__ out_len,
                    double* __restrict__ out_score) {
  __shared__ Smem sm;
  const long long i = blockIdx.x;
  const int tid = threadIdx.x;
  const uint8_t* a = abuf + aoff[i];
  const uint8_t* b = bbuf + boff[i];
  const long long la = aoff[i + 1] - aoff[i];
  const long long lb = boff[i + 1] - boff[i];
  if (la < min_olen || lb <= 0) {  // the same for the whole block
    if (tid == 0) {
      out_len[i] = 0;
      out_score[i] = 0.0;
    }
    return;
  }
  for (int k = tid; k < 256; k += kThreads) {
    sm.lut[k] = lut[k];
    sm.t2[k] = table2[k];
  }
  if (tid == 0) {
    sm.best2 = INT_MIN;
    sm.first = LLONG_MAX;
  }
  // (tile_scores starts with a barrier: the tables and the two
  // reduction slots are set before any thread reads them)

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
        out_len[i] = lb;
        out_score[i] = best;
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
        out_len[i] = olen;
        out_score[i] = sc;
      }
      return;
    }
  }
  if (tid == 0) {
    out_len[i] = 0;
    out_score[i] = 0.0;
  }
}

}  // namespace

// Scans the n pairs (abuf[aoff[i]:aoff[i+1]], bbuf[boff[i]:boff[i+1]]) on
// `stream`. lut: [256] uint8 byte -> code; table2: [16, 16] int32, the
// doubled table. Returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a batch the grid cannot hold.
extern "C" int overlap_best_launch(const uint8_t* abuf, const int64_t* aoff,
                                   const uint8_t* bbuf, const int64_t* boff,
                                   int64_t n, const uint8_t* lut,
                                   const int* table2, int64_t min_olen,
                                   double min_score, int64_t* out_len,
                                   double* out_score, void* stream) {
  if (n <= 0) return 0;
  if (n > INT_MAX) return (int)cudaErrorInvalidValue;
  overlap_best_kernel<<<(unsigned)n, kThreads, 0, (cudaStream_t)stream>>>(
      abuf, aoff, bbuf, boff, lut, table2, (long long)min_olen, min_score,
      out_len, out_score);
  return (int)cudaGetLastError();
}
