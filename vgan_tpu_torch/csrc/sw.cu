// Batched affine Smith-Waterman scoring for the read mapper, designed for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vgan_tpu/mapper/sw_pallas.py::sw_scores
// (_sw_col_kernel / _sw_one_col / _cummax_rows, :157-214, pallas_call at
// :191) and the fused production dispatch sw_pallas.gather_score_hash
// (:339-401), whose scoring core is the kernel's XLA twin sw_scores_core
// (:235-320).
//
// What it computes, per (read, window) pair: the best local alignment
// score with match +1, mismatch -4, gap open 6, gap extend 1
// (mapper/align.py), a full-length bonus of +5 added inside the DP at
// read row 1 and at row rlen when the maximum is taken. Codes >= 4 never
// match, H is floored at 0, rows past rlen never count, and columns at or
// past the window length are frozen (they change nothing). rlen == 0
// scores the end bonus at row 0 when the window has a column. Every live
// value is a small integer, so the DP runs in int32 with a sentinel of
// -2^28 for the TPU code's NEG = -1e9, and the final cast to float equals
// the JAX f32 result bit for bit.
//
// Bound. One DP cell is 9 integer lane operations, on two pipes. Five
// run only on the integer ALU pipe: the match compare (ISETP),
// E = max(Hleft - 6, E - 1) and F = max(H - 6, F - 1) as one VIADDMNMX
// each, H = max(diag, E, F, 0) as one VIMNMX3 with relu, and the running
// best with the end bonus and the row mask folded into one VIADDMNMX.
// Four are adds, which sm_90 issues as VIADD on the FMA pipe: the
// diagonal score (an add, and a second add predicated on a mismatch),
// E - 1 and F - 1. `cuobjdump -sass` of the sm_90a build shows exactly
// this mix in the DP step of every instantiation (5.0-5.4 ALU-pipe and
// 4-6 FMA-pipe operations a cell, the excess being register moves as
// IMAD.MOV), and chip_smoke.py checks it. An H100 SM issues at most 64
// ALU-pipe lane operations a clock and 128 in all, so the ALU pipe sets
// the bound: 132 SMs x 64 lanes x 1.98 GHz / 5 = 3.3 T cells/s. Device
// memory is no limit (each pair's codes are read once, a few hundred
// bytes against tens of thousands of operations). PERF.md has the
// measured share.
//
// Design.
// * One warp per pair, blocks of up to 8 warps (fewer only when a long
//   read's band buffer needs the shared memory), one pair per warp. A
//   4,096-pair launch is 4,096 warps, enough for 132 SMs; the first
//   design (a thread per pair, a warp per block, H/E columns in shared
//   memory) fit 6 warps on an SM.
// * The DP lives in registers as a skewed wavefront. Lane l owns K
//   consecutive read rows (K = ceil(min(R, 256) / 32), a template
//   parameter) and at step t works on window column t - l. It keeps its
//   rows' H and E of the previous column in registers; the row above its
//   first row arrives from lane l - 1 by __shfl_up_sync (that lane's last
//   H and the F running into this lane's rows, both for this column; H of
//   the column before was received the step before and kept). Lane 0's
//   row above is row 0 (H = 0, so row 1's F is -6, and row 1's diagonal
//   carries the +5 bonus). A pair takes ncols + ceil(rows / K) - 1 steps.
//   Every lane runs every step (the shuffles take the full mask); a lane
//   only updates its registers where its column lies inside the window
//   and it holds a row. A step's only shared-memory access is the
//   window byte of its column (and, after the first band, lane 0's row
//   above); H, E and F never leave registers and shuffles.
// * DPX instructions carry the max chains: __vimax3_s32_relu for H,
//   __viaddmax_s32 for E, F and the best, __reduce_max_sync for the
//   warp's best. `cuobjdump -sass` of the sm_90a build shows them as
//   Hopper's VIMNMX3 and VIADDMNMX, not as emulated sequences.
// * Coalesced loads. The warp stages its window (canonical codes, one
//   byte a column) and its oriented query (an int a row: a byte would be
//   masked again at every use in the DP loop, which cost 10 % on an
//   H100) in its own shared-memory slice, lane l loading columns l,
//   l + 32, ...; in gather_score_hash each lane hashes the columns it
//   loaded and __reduce_add_sync (uint32, wrapping exactly) gives h1 and
//   h2.
// * Reads of any length. Rows are swept in bands of 32 K (256 rows at
//   K = 8). For each column the band's last row's H and F go into a
//   per-warp buffer of int2 (8 bytes a column), which the next band's
//   lane 0 reads as its row above. The buffer is overwritten in place:
//   lane 31 writes column j at step j + 31, after lane 0 read it at step
//   j, and the value lane 0 read feeds the shuffle of step j + 1 that
//   lane 31 must pass first. A warp's slice is 9 W + 4 R bytes (with a
//   band buffer) and a block holds up to 8 slices within 227 KB; a launch
//   whose single slice exceeds 227 KB (W = R = about 17,000) is refused
//   with cudaErrorInvalidValue, never truncated.
//
// Left for later: packed s16x2 DPX (two cells a lane operation, which
// halves the bound), sorting pairs by length, and SaLoBa-style load
// balance across ragged window lengths (PAPERS.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMatch = 1;
constexpr int kMismatch = -4;
constexpr int kGapOpen = 6;
constexpr int kGapExt = 1;
constexpr int kBonus = 5;
constexpr int kNeg = -(1 << 28);
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kMaxK = 8;          // rows per lane; a band is 256 rows
constexpr int kMaxWarps = 8;      // warps (pairs) per block
constexpr size_t kMaxSmem = 232448;  // opt-in limit of one block on sm_90
// canonical codes: a window code and a query code are equal only when
// both are A, C, G or T
constexpr uint8_t kWinOther = 4;
constexpr uint8_t kQueryOther = 5;

// complement over the code alphabet (utils/dna._COMP); codes >= 8 map
// to themselves (sw_pallas._COMP256)
__constant__ uint8_t kComp[8] = {3, 2, 1, 0, 4, 5, 6, 7};

__device__ __forceinline__ uint8_t canon(int c, uint8_t other) {
  return (c >= 0 && c < 4) ? (uint8_t)c : other;
}

size_t round16(size_t n) { return (n + 15) & ~(size_t)15; }

// One warp's shared-memory slice: [band buffer][window codes][query]
struct Layout {
  size_t band_bytes, win_bytes, per_warp;
  int warps;    // per block
  size_t smem;  // per block
};

Layout layout(int W, int R, int K) {
  Layout L;
  const bool bands = R > kWarp * K;  // rows in more than one band
  L.band_bytes = bands ? round16((size_t)W * sizeof(int2)) : 0;
  L.win_bytes = round16((size_t)(W > 0 ? W : 1));  // never an empty slice
  L.per_warp = L.band_bytes + L.win_bytes + round16((size_t)R * sizeof(int));
  const size_t fit = kMaxSmem / L.per_warp;
  L.warps = (int)(fit < (size_t)kMaxWarps ? fit : kMaxWarps);
  L.smem = (size_t)L.warps * L.per_warp;
  return L;
}

struct Slice {
  int2* band;   // [W] H and F of the previous band's last row
  uint8_t* win; // [W] canonical window codes
  int* qry;     // [R] canonical oriented query codes
};

__device__ __forceinline__ Slice carve(size_t band_bytes, size_t win_bytes,
                                       size_t per_warp, int warp) {
  extern __shared__ int4 smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(smem_raw) + warp * per_warp;
  Slice s;
  s.band = reinterpret_cast<int2*>(base);
  s.win = base + band_bytes;
  s.qry = reinterpret_cast<int*>(base + band_bytes + win_bytes);
  return s;
}

// Best score of one pair, computed by the whole warp (every lane returns
// it). The slice holds the window's first ncols canonical codes and the
// first min(rlen, R) query codes; __syncwarp() has made them visible.
template <int K>
__device__ int sw_warp(const Slice& s, int ncols, int rlen, int R,
                       int lane) {
  if (rlen < 0 || ncols <= 0) return 0;
  const int nr = rlen < R ? rlen : R;
  // row 0 is the sentinel row: its H is 0; it scores the end bonus when
  // rlen == 0
  int best = (rlen == 0) ? kBonus : 0;
  for (int top = 0; top < nr; top += kWarp * K) {
    const int rows = (nr - top) < kWarp * K ? (nr - top) : kWarp * K;
    const int nl = (rows + K - 1) / K;  // lanes holding rows
    const bool first = top == 0;
    const bool more = top + kWarp * K < nr;  // a band follows this one
    int q[K], add[K], H[K], E[K];
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int i = top + lane * K + r + 1;  // DP row, 1-based
      q[r] = i <= nr ? s.qry[i - 1] : kQueryOther;
      // end bonus at row rlen; rows past nr never count
      add[r] = i == rlen ? kBonus : (i <= nr ? 0 : kNeg);
      H[r] = 0;
      E[r] = kNeg;
    }
    int hout = 0, fout = kNeg;  // this lane's last row, latest column
    // H of the row above at the previous column (row 1 adds the bonus)
    int hdiag = (first && lane == 0) ? kBonus : 0;
    const int steps = ncols + nl - 1;
    for (int t = 0; t < steps; ++t) {
      int hup = __shfl_up_sync(kFull, hout, 1);
      int fup = __shfl_up_sync(kFull, fout, 1);
      const int j = t - lane;
      const bool active = lane < nl && (unsigned)j < (unsigned)ncols;
      if (lane == 0) {
        if (first) {
          hup = kBonus;
          fup = -kGapOpen;
        } else if (active) {
          const int2 v = s.band[j];
          hup = v.x;
          fup = v.y;
        }
      }
      if (active) {
        const int wc = s.win[j];
        int hd = hdiag;
        int f = fup;
#pragma unroll
        for (int r = 0; r < K; ++r) {
          const int diag = hd + (q[r] == wc ? kMatch : kMismatch);
          const int e = __viaddmax_s32(H[r], -kGapOpen, E[r] - kGapExt);
          const int h = __vimax3_s32_relu(diag, e, f);
          f = __viaddmax_s32(h, -kGapOpen, f - kGapExt);
          best = __viaddmax_s32(h, add[r], best);
          hd = H[r];
          H[r] = h;
          E[r] = e;
        }
        hout = H[K - 1];
        fout = f;
        if (more && lane == kWarp - 1) s.band[j] = make_int2(hout, fout);
      }
      hdiag = hup;
    }
    __syncwarp();
  }
  return __reduce_max_sync(kFull, best);
}

template <int K>
__global__ void sw_scores_kernel(const int* __restrict__ read,
                                 const int* __restrict__ win,
                                 const int* __restrict__ read_len,
                                 const int* __restrict__ win_len,
                                 float* __restrict__ out, int B, int R,
                                 int W, size_t band_bytes, size_t win_bytes,
                                 size_t per_warp) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const long long b = (long long)blockIdx.x * (blockDim.x / kWarp) + warp;
  if (b >= B) return;  // whole warps leave; no block-level barrier below
  const Slice s = carve(band_bytes, win_bytes, per_warp, warp);
  const int rlen = read_len[b];
  const int wl = win_len[b];
  const int ncols = wl < W ? wl : W;
  const int nr = rlen < R ? rlen : R;
  const int* q = read + b * R;
  const int* w = win + b * W;
  for (int i = lane; i < nr; i += kWarp) s.qry[i] = canon(q[i], kQueryOther);
  for (int j = lane; j < ncols; j += kWarp) s.win[j] = canon(w[j], kWinOther);
  __syncwarp();
  const int best = sw_warp<K>(s, ncols, rlen, R, lane);
  if (lane == 0) out[b] = (float)best;
}

template <int K>
__global__ void gather_score_hash_kernel(
    const uint8_t* __restrict__ pc_buf, long long P,
    const uint8_t* __restrict__ reads_mat, int Rmax,
    const int* __restrict__ read_lens, const long long* __restrict__ aux,
    int M, const int* __restrict__ pow1, const int* __restrict__ pow2,
    int Wmax, float* __restrict__ scores, int* __restrict__ h1_out,
    int* __restrict__ h2_out, size_t band_bytes, size_t win_bytes,
    size_t per_warp) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const long long m = (long long)blockIdx.x * (blockDim.x / kWarp) + warp;
  if (m >= M) return;
  const Slice s = carve(band_bytes, win_bytes, per_warp, warp);
  const long long c_read = aux[m];
  const long long gbase = aux[M + m];
  const int wlen = (int)aux[2 * (long long)M + m];
  const int strand = (int)aux[3 * (long long)M + m];
  const long long last = P > 0 ? P - 1 : 0;
  const int ncols = wlen < Wmax ? wlen : Wmax;

  // window gather + content hashes over ALL Wmax columns (uint32,
  // wrapping); masked columns hash as code 255, so the hash depends on
  // Wmax as in JAX
  uint32_t h1 = 0, h2 = 0;
  for (int j = lane; j < Wmax; j += kWarp) {
    int code = 255;
    if (j < wlen) {
      long long p = gbase + j;
      p = p < 0 ? 0 : (p > last ? last : p);
      code = pc_buf[p];
      s.win[j] = canon(code, kWinOther);
    }
    const uint32_t v = (uint32_t)code + 1u;
    h1 += v * (uint32_t)pow1[j];
    h2 += v * (uint32_t)pow2[j];
  }
  h1 = __reduce_add_sync(kFull, h1);
  h2 = __reduce_add_sync(kFull, h2);

  // oriented query: strand 1 reads the read backwards, complemented
  const int L = read_lens[c_read];
  const int nr = L < Rmax ? L : Rmax;
  const bool flip = strand > 0;
  const uint8_t* row = reads_mat + c_read * Rmax;
  for (int j = lane; j < nr; j += kWarp) {
    int idx = flip ? L - 1 - j : j;
    idx = idx < 0 ? 0 : (idx > Rmax - 1 ? Rmax - 1 : idx);
    int code = row[idx];
    if (flip && code < 8) code = kComp[code];
    s.qry[j] = canon(code, kQueryOther);
  }
  __syncwarp();
  const int best = sw_warp<K>(s, ncols, L, Rmax, lane);
  if (lane == 0) {
    scores[m] = (float)best;
    h1_out[m] = (int)h1;
    h2_out[m] = (int)h2;
  }
}

// rows per lane for a launch of R query rows: ceil(min(R, 256) / 32)
int rows_per_lane(int R) {
  const int r = R < kWarp * kMaxK ? R : kWarp * kMaxK;
  const int k = (r + kWarp - 1) / kWarp;
  return k < 1 ? 1 : k;
}

template <class Kern>
cudaError_t prepare(Kern kernel, const Layout& L) {
  if (L.warps < 1) return cudaErrorInvalidValue;  // too long for one SM
  if (L.smem > 48 * 1024) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.smem);
  }
  return cudaSuccess;
}

using SwKern = void (*)(const int*, const int*, const int*, const int*,
                        float*, int, int, int, size_t, size_t, size_t);
using GshKern = void (*)(const uint8_t*, long long, const uint8_t*, int,
                         const int*, const long long*, int, const int*,
                         const int*, int, float*, int*, int*, size_t, size_t,
                         size_t);

const SwKern kSwKernels[kMaxK] = {
    sw_scores_kernel<1>, sw_scores_kernel<2>, sw_scores_kernel<3>,
    sw_scores_kernel<4>, sw_scores_kernel<5>, sw_scores_kernel<6>,
    sw_scores_kernel<7>, sw_scores_kernel<8>};
const GshKern kGshKernels[kMaxK] = {
    gather_score_hash_kernel<1>, gather_score_hash_kernel<2>,
    gather_score_hash_kernel<3>, gather_score_hash_kernel<4>,
    gather_score_hash_kernel<5>, gather_score_hash_kernel<6>,
    gather_score_hash_kernel<7>, gather_score_hash_kernel<8>};

}  // namespace

// C entry points (ctypes). Each launches on the given stream, does not
// synchronise, and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue when one warp's shared-memory slice would not
// fit a block.
extern "C" int sw_scores_launch(const void* read, const void* win,
                                const void* read_len, const void* win_len,
                                void* out, int B, int R, int W,
                                void* stream) {
  const int K = rows_per_lane(R);
  const Layout L = layout(W, R, K);
  const SwKern kernel = kSwKernels[K - 1];
  cudaError_t err = prepare(kernel, L);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = ((long long)B + L.warps - 1) / L.warps;
  kernel<<<(unsigned)blocks, L.warps * kWarp, L.smem,
           (cudaStream_t)stream>>>(
      (const int*)read, (const int*)win, (const int*)read_len,
      (const int*)win_len, (float*)out, B, R, W, L.band_bytes, L.win_bytes,
      L.per_warp);
  return (int)cudaGetLastError();
}

extern "C" int gather_score_hash_launch(
    const void* pc_buf, long long P, const void* reads_mat, int Rmax,
    const void* read_lens, const void* aux, int M, const void* pow1,
    const void* pow2, int Wmax, void* scores, void* h1, void* h2,
    void* stream) {
  const int K = rows_per_lane(Rmax);
  const Layout L = layout(Wmax, Rmax, K);
  const GshKern kernel = kGshKernels[K - 1];
  cudaError_t err = prepare(kernel, L);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = ((long long)M + L.warps - 1) / L.warps;
  kernel<<<(unsigned)blocks, L.warps * kWarp, L.smem,
           (cudaStream_t)stream>>>(
      (const uint8_t*)pc_buf, P, (const uint8_t*)reads_mat, Rmax,
      (const int*)read_lens, (const long long*)aux, M, (const int*)pow1,
      (const int*)pow2, Wmax, (float*)scores, (int*)h1, (int*)h2,
      L.band_bytes, L.win_bytes, L.per_warp);
  return (int)cudaGetLastError();
}
