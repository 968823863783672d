// HaploCart's likelihood step up to the path GEMV, in one launch, for
// Hopper (sm_90a).
//
// Replaces the body of the XLA programs
// vgan_tpu/pipelines/haplocart_device.py::score_batch (:88-96) and
// ::score_packed (:99-133) up to `c @ support`: mapping_scores (:63-85),
// the segment_sum of A - b over node ids and the sum of b. The GEMV that
// follows stays a dense f64 product (torch.matmul), as the JAX package
// leaves it to XLA. The plain PyTorch version is
// vgan_tpu_torch/pipelines/haplocart_device.py::node_scores_plain.
//
// What it computes, per mapping row m over its S positions (f64):
//   a position counts when it is valid (s < take[m], or valid[m, s]) and
//   both codes are bases (g < 4, r < 4);
//   eps   = use_bep[m] ? (g == r ? bep : 1 - bep)
//                      : (g == r ? qtab[q] : 1 - qtab[q])
//   p_obs = match_tab[pang[m]] * (1 - eps)
//   term  = consensus ? log((1 - bep) * p_obs)
//                     : log((1 - pc) * bg[r] + pc * p_obs),
//   pc    = (1 - imtab[mq[m]]) * mapp_tab[pang[m]]
//   A[m]  = sum of term over the positions that count
//   c[node[m]] += A[m] - b[m];   total_b += b[m]
// Indices clamp as JAX's gathers clamp (q and mq to 0..99 and the table;
// pang and r, after a negative one counts from the end, to each table and
// to bg); a node id outside [0, n_nodes) is dropped,
// as jax.ops.segment_sum drops it. Padding rows (g = r = 255, b = 0) add
// exactly 0 and skip the atomic add.
//
// Bound. Every byte of the batch read once (3 M S code bytes, the per-row
// columns) plus the table gathers, and c written once, over 3.35 TB/s;
// against the f64 operations of the positions that count (a log and about
// ten adds and multiplies each) at the card's 33.5 TFLOP/s FP64 rate
// outside the tensor cores. At HaploCart's flush (M = 16,384, S = 8) that
// is ~1 us either way: the launch and the atomics' latency set the time.
//
// Design: one thread a row for S <= 32 (HaploCart's graph has S = 8), a
// warp a row with its lanes strided over the positions above that (long
// reads reach S = 1,024). Codes are read in their own type (uint8 from
// the packed upload's buffer, read in place; int32 from an HcBatch).
// A[m] - b[m] goes into c with the native f64 atomicAdd, so the order of
// the additions into one node varies from run to run (results agree to
// rounding); b is summed over the block and added with one atomic a block.
// Products and sums use __dmul_rn / __dadd_rn, so no multiply-add is
// contracted where torch rounds twice.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Tables {
  const double* qtab;
  const double* imtab;
  const double* match_tab;
  const double* mapp_tab;
  const double* bg;
  int n_q, n_im, n_match, n_mapp, n_bg;
};

__device__ __forceinline__ long long clampi(long long x, long long hi) {
  return x < 0 ? 0 : (x > hi ? hi : x);
}

// x as an index into a table of n entries, as JAX's gather takes it: a
// negative index counts from the end, then the index clamps to the table
__device__ __forceinline__ long long table_index(long long x, long long n) {
  return clampi(x < 0 ? x + n : x, n - 1);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __dadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// per-row values shared by the row's positions
struct Row {
  double match;  // match_tab[pang]
  double pc;     // (1 - imtab[mq]) * mapp_tab[pang]
  bool use_bep;
};

template <typename CodeT>
__device__ __forceinline__ Row row_values(const Tables& t, const CodeT* mq,
                                          const uint8_t* use_bep,
                                          const int32_t* pang, long long m,
                                          bool consensus) {
  Row w;
  const long long p = pang[m];
  w.match = t.match_tab[table_index(p, t.n_match)];
  w.pc = 0.0;
  if (!consensus) {
    const long long iq = clampi(clampi((long long)mq[m], 99), t.n_im - 1);
    w.pc = __dmul_rn(__dsub_rn(1.0, t.imtab[iq]),
                     t.mapp_tab[table_index(p, t.n_mapp)]);
  }
  w.use_bep = use_bep == nullptr || use_bep[m] != 0;
  return w;
}

// the position's term, or 0 where it does not count
__device__ __forceinline__ double term(const Tables& t, const Row& w,
                                       long long gv, long long rv,
                                       long long qv, double bep,
                                       bool consensus) {
  if (gv >= 4 || rv >= 4) return 0.0;
  const bool match = gv == rv;
  double eps;
  if (w.use_bep) {
    eps = match ? bep : __dsub_rn(1.0, bep);
  } else {
    const double e = t.qtab[clampi(clampi(qv, 99), t.n_q - 1)];
    eps = match ? e : __dsub_rn(1.0, e);
  }
  const double p_obs = __dmul_rn(w.match, __dsub_rn(1.0, eps));
  if (consensus) return log(__dmul_rn(__dsub_rn(1.0, bep), p_obs));
  const double bgv = t.bg[table_index(rv, t.n_bg)];
  return log(__dadd_rn(__dmul_rn(__dsub_rn(1.0, w.pc), bgv),
                       __dmul_rn(w.pc, p_obs)));
}

template <typename CodeT, bool kWarpRow>
__global__ void __launch_bounds__(kThreads) hc_node_scores_kernel(
    const CodeT* __restrict__ g, const CodeT* __restrict__ r,
    const CodeT* __restrict__ q, const CodeT* __restrict__ mq,
    const uint8_t* __restrict__ use_bep, const int32_t* __restrict__ take,
    const uint8_t* __restrict__ valid, const int32_t* __restrict__ pang,
    const int32_t* __restrict__ node, const double* __restrict__ b,
    Tables t, double bep, bool consensus, long long M, int S, int n_nodes,
    double* __restrict__ c, double* __restrict__ total_b) {
  __shared__ double part[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long m = kWarpRow
      ? (long long)blockIdx.x * kWarps + warp
      : (long long)blockIdx.x * kThreads + threadIdx.x;
  double bm = 0.0;
  if (m < M) {
    const Row w = row_values(t, mq, use_bep, pang, m, consensus);
    const long long base = m * S;
    const int n_take = take ? take[m] : S;
    double A = 0.0;
    for (int s = kWarpRow ? lane : 0; s < S; s += kWarpRow ? 32 : 1) {
      const bool ok = valid ? valid[base + s] != 0 : s < n_take;
      if (ok)
        A = __dadd_rn(A, term(t, w, (long long)g[base + s],
                              (long long)r[base + s], (long long)q[base + s],
                              bep, consensus));
    }
    if (kWarpRow) A = warp_sum(A);
    if (!kWarpRow || lane == 0) {
      bm = b[m];
      const double d = __dsub_rn(A, bm);
      const int nd = node[m];
      if (d != 0.0 && nd >= 0 && nd < n_nodes) atomicAdd(c + nd, d);
    }
  }
  bm = warp_sum(bm);
  if (lane == 0) part[warp] = bm;
  __syncthreads();
  if (warp == 0) {
    double v = lane < kWarps ? part[lane] : 0.0;
    v = warp_sum(v);
    if (lane == 0 && v != 0.0) atomicAdd(total_b, v);
  }
}

template <typename CodeT>
void launch(const void* g, const void* r, const void* q, const void* mq,
            const uint8_t* use_bep, const int32_t* take,
            const uint8_t* valid, const int32_t* pang, const int32_t* node,
            const double* b, const Tables& t, double bep, bool consensus,
            long long M, int S, int n_nodes, double* c, double* total_b,
            cudaStream_t stream) {
  const CodeT *gc = (const CodeT*)g, *rc = (const CodeT*)r,
              *qc = (const CodeT*)q, *mqc = (const CodeT*)mq;
  if (S > 32) {
    const long long blocks = (M + kWarps - 1) / kWarps;
    hc_node_scores_kernel<CodeT, true><<<(unsigned)blocks, kThreads, 0,
                                         stream>>>(
        gc, rc, qc, mqc, use_bep, take, valid, pang, node, b, t, bep,
        consensus, M, S, n_nodes, c, total_b);
  } else {
    const long long blocks = (M + kThreads - 1) / kThreads;
    hc_node_scores_kernel<CodeT, false><<<(unsigned)blocks, kThreads, 0,
                                          stream>>>(
        gc, rc, qc, mqc, use_bep, take, valid, pang, node, b, t, bep,
        consensus, M, S, n_nodes, c, total_b);
  }
}

}  // namespace

extern "C" {

// The node vector c [n_nodes] and sum(b) [1] of M mapping rows of S
// positions on `stream`, both added to (the caller zeroes them). g, r, q
// [M, S] and mq [M]: uint8 (code_bytes 1) or int32 (code_bytes 4);
// use_bep [M] uint8, or null for every row set (consensus on the packed
// path); exactly one of take [M] int32 and valid [M, S] uint8; pang, node
// [M] int32; b [M] f64; the tables f64 with their lengths. All device
// pointers, contiguous. Returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for arguments it cannot take.
int hc_node_scores_launch(int code_bytes, const void* g, const void* r,
                          const void* q, const void* mq,
                          const uint8_t* use_bep, const int32_t* take,
                          const uint8_t* valid, const int32_t* pang,
                          const int32_t* node, const double* b,
                          const double* qtab, int n_q, const double* imtab,
                          int n_im, const double* match_tab, int n_match,
                          const double* mapp_tab, int n_mapp,
                          const double* bg, int n_bg, double bep,
                          int consensus, long long M, int S, int n_nodes,
                          double* c, double* total_b, void* stream) {
  if (M <= 0) return 0;
  if ((take == nullptr) == (valid == nullptr) || S < 0 || n_q < 1 ||
      n_im < 1 || n_match < 1 || n_mapp < 1 || n_bg < 1 ||
      (S > 32 ? (M + kWarps - 1) / kWarps : (M + kThreads - 1) / kThreads) >
          0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Tables t{qtab, imtab, match_tab, mapp_tab, bg,
                 n_q, n_im, n_match, n_mapp, n_bg};
  cudaStream_t st = (cudaStream_t)stream;
  if (code_bytes == 1)
    launch<uint8_t>(g, r, q, mq, use_bep, take, valid, pang, node, b, t, bep,
                    consensus != 0, M, S, n_nodes, c, total_b, st);
  else if (code_bytes == 4)
    launch<int32_t>(g, r, q, mq, use_bep, take, valid, pang, node, b, t, bep,
                    consensus != 0, M, S, n_nodes, c, total_b, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
