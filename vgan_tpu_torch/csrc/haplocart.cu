// HaploCart's likelihood step up to the path GEMV, for Hopper (sm_90a).
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
// columns) plus each table once, and c written once, over 3.35 TB/s;
// against the f64 operations of the positions that count (a log and about
// ten adds and multiplies each) at the card's 33.5 TFLOP/s FP64 rate
// outside the tensor cores. At HaploCart's flush (M = 65,536, S = 8) that
// is ~1 us, bytes.
//
// Design. The call is a latency chain, not bytes or operations: a launch,
// the row's loads, the table gathers they index, the logs, an atomic add.
// The first design (a thread a row) ran the S positions' loads and logs
// one after another in each thread and was preceded by two zero fills of
// c and sum(b), each a kernel of its own; its atomics cost little
// (hc_ab.py's ablations, PERF.md). So:
// * a group of G lanes a row, each lane kPerLane contiguous positions
//   (G = S / 4 rounded up to a power of two, 2 for HaploCart's S = 8),
//   their codes loaded with the row's columns before any gather, so a
//   row's loads are one round trip and its logs run on G lanes at once;
//   A is summed with width-G xor shuffles; rows over 128 positions take
//   a warp each, every 32nd position a lane;
// * the grid is one wave of resident blocks that loops over row tiles,
//   the next tile's loads issued before the current tile's gathers;
// * the launch zeroes c and sum(b) itself, with a small kernel, and
//   launches the main kernel as its programmatic dependent (Hopper's
//   PDL): the main kernel's launch, loads and logs overlap the zeroing,
//   and it waits on the grid dependency (griddepcontrol.wait) only before
//   its first atomic add;
// * A[m] - b[m] goes into c with the native f64 atomicAdd from the row's
//   first lane, so the order of the additions into one node varies from
//   run to run (results agree to rounding); b is summed over the block
//   and added with one atomic a block. The small tables are read through
//   L1 (staging them in shared memory measured no faster), and the
//   atomics are not aggregated over a warp (they cost ~2 % of the call).
// Products and sums use __dmul_rn / __dadd_rn, so no multiply-add is
// contracted where torch rounds twice.
//
// Built with -DVGAN_HC_PHASE_CLOCKS (a build for measurement only), the
// main kernel stamps each row's phases with clock64() and sums the cycles
// over rows: the row loads, the table gathers, the S terms and the atomic
// add; hc_phase_clocks reads and clears the sums.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerLane = 4;  // positions a lane, codes loaded a tile ahead

struct Tables {
  const double* qtab;
  const double* imtab;
  const double* match_tab;
  const double* mapp_tab;
  const double* bg;
  int n_q, n_im, n_match, n_mapp, n_bg;
};

#ifdef VGAN_HC_PHASE_CLOCKS
__device__ unsigned long long g_phase_cycles[4];
#define PHASE_STAMP(t) const long long t = clock64()
#else
#define PHASE_STAMP(t)
#endif

__device__ __forceinline__ long long clampi(long long x, long long hi) {
  return x < 0 ? 0 : (x > hi ? hi : x);
}

// x as an index into a table of n entries, as JAX's gather takes it: a
// negative index counts from the end, then the index clamps to the table
__device__ __forceinline__ long long table_index(long long x, long long n) {
  return clampi(x < 0 ? x + n : x, n - 1);
}

template <int G>
__device__ __forceinline__ double group_sum(double v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ double block_sum(double v, double* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = group_sum<32>(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  v = threadIdx.x < kWarps ? part[threadIdx.x] : 0.0;
  return group_sum<32>(v);  // warp 0 holds the block's sum
}

// the position's term, or 0 where it does not count
__device__ __forceinline__ double term(const Tables& t, double match,
                                       double pc, bool use_bep, long long gv,
                                       long long rv, long long qv, double bep,
                                       bool consensus) {
  if (gv >= 4 || rv >= 4) return 0.0;
  const bool same = gv == rv;
  double eps;
  if (use_bep) {
    eps = same ? bep : __dsub_rn(1.0, bep);
  } else {
    const double e = t.qtab[clampi(clampi(qv, 99), t.n_q - 1)];
    eps = same ? e : __dsub_rn(1.0, e);
  }
  const double p_obs = __dmul_rn(match, __dsub_rn(1.0, eps));
  if (consensus) return log(__dmul_rn(__dsub_rn(1.0, bep), p_obs));
  const double bgv = t.bg[table_index(rv, t.n_bg)];
  return log(__dadd_rn(__dmul_rn(__dsub_rn(1.0, pc), bgv),
                       __dmul_rn(pc, p_obs)));
}

// c [n_nodes] and sum(b) to 0; lets the main kernel launch at once
__global__ void hc_zero_kernel(double* __restrict__ c, int n,
                               double* __restrict__ total_b) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) c[i] = 0.0;
  if (i == 0) *total_b = 0.0;
}

// A lane's loads of one row: the row's columns and, where the row's S
// positions are split over its G lanes (P contiguous positions a lane),
// the codes of the lane's own positions. They are issued a tile ahead,
// while the lane computes the tile before. P = 0: long rows, whose codes
// are loaded in the loop over every G-th position instead.
template <int P>
struct RowIn {
  static constexpr int kP = P > 0 ? P : 1;
  bool live, bep;
  int take, node;
  long long p, mq;
  double b;
  int g[kP], r[kP], q[kP];
  bool ok[kP];  // the position is valid (valid mask, or below take)
};

template <typename CodeT, int G, int P>
__device__ __forceinline__ RowIn<P> load_row(
    long long m, int sub, const CodeT* __restrict__ g,
    const CodeT* __restrict__ r, const CodeT* __restrict__ q,
    const CodeT* __restrict__ mq, const uint8_t* __restrict__ use_bep,
    const int32_t* __restrict__ take, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ pang, const int32_t* __restrict__ node,
    const double* __restrict__ b, long long M, int S) {
  RowIn<P> x{};
  x.live = m < M;
  if (!x.live) return x;
  x.p = pang[m];
  x.mq = (long long)mq[m];
  x.bep = use_bep == nullptr || use_bep[m] != 0;
  x.take = take ? take[m] : S;
  x.node = node[m];
  x.b = b[m];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int s = sub * P + j;
    x.ok[j] = false;
    if (s < S) {
      const long long i = m * S + s;
      x.g[j] = (int)g[i];
      x.r[j] = (int)r[i];
      x.q[j] = (int)q[i];
      x.ok[j] = valid ? valid[i] != 0 : s < x.take;
    }
  }
  return x;
}

template <typename CodeT, int G, int P>
__global__ void __launch_bounds__(kThreads) hc_node_scores_kernel(
    const CodeT* __restrict__ g, const CodeT* __restrict__ r,
    const CodeT* __restrict__ q, const CodeT* __restrict__ mq,
    const uint8_t* __restrict__ use_bep, const int32_t* __restrict__ take,
    const uint8_t* __restrict__ valid, const int32_t* __restrict__ pang,
    const int32_t* __restrict__ node, const double* __restrict__ b,
    Tables t, double bep, bool consensus, long long M, int S, int n_nodes,
    double* __restrict__ c, double* __restrict__ total_b) {
  __shared__ double part[kWarps];
#ifdef VGAN_HC_PHASE_CLOCKS
  __shared__ unsigned long long s_clk[4];
  if (threadIdx.x < 4) s_clk[threadIdx.x] = 0;
#endif
  constexpr int kRows = kThreads / G;  // rows a block tile
  const int sub = threadIdx.x % G;
  const long long stride = (long long)gridDim.x * kRows;
  long long m = (long long)blockIdx.x * kRows + threadIdx.x / G;
  RowIn<P> cur = load_row<CodeT, G, P>(m, sub, g, r, q, mq, use_bep, take,
                                       valid, pang, node, b, M, S);
  bool waited = false;
  double bsum = 0.0;
  // every thread of a block runs every tile (the shuffles take the whole
  // warp); a row past M computes nothing
  for (long long m0 = m - threadIdx.x / G; m0 < M; m0 += stride, m += stride) {
    PHASE_STAMP(t0);
    const RowIn<P> nxt = load_row<CodeT, G, P>(m + stride, sub, g, r, q, mq,
                                               use_bep, take, valid, pang,
                                               node, b, M, S);
    PHASE_STAMP(t1);
    double match = 0.0, pc = 0.0;
    if (cur.live) {
      match = t.match_tab[table_index(cur.p, t.n_match)];
      if (!consensus)
        pc = __dmul_rn(__dsub_rn(1.0, t.imtab[clampi(clampi(cur.mq, 99),
                                                     t.n_im - 1)]),
                       t.mapp_tab[table_index(cur.p, t.n_mapp)]);
    }
    PHASE_STAMP(t2);
    double A = 0.0;
    if (P > 0) {  // the lane's positions, their codes loaded ahead
#pragma unroll
      for (int j = 0; j < P; ++j)
        if (cur.ok[j])
          A = __dadd_rn(A, term(t, match, pc, cur.bep, cur.g[j], cur.r[j],
                                cur.q[j], bep, consensus));
    } else {  // long rows: every G-th position
      const long long base = m * S;
      for (int s = sub; cur.live && s < S; s += G) {
        const bool ok = valid ? valid[base + s] != 0 : s < cur.take;
        if (ok)
          A = __dadd_rn(A, term(t, match, pc, cur.bep, (long long)g[base + s],
                                (long long)r[base + s],
                                (long long)q[base + s], bep, consensus));
      }
    }
    A = group_sum<G>(A);
    PHASE_STAMP(t3);
    if (cur.live && sub == 0) {
      bsum = __dadd_rn(bsum, cur.b);
      const double d = __dsub_rn(A, cur.b);
      if (d != 0.0 && cur.node >= 0 && cur.node < n_nodes) {
        if (!waited) {  // c is zeroed by the kernel before this one
          asm volatile("griddepcontrol.wait;" ::: "memory");
          waited = true;
        }
        atomicAdd(c + cur.node, d);
      }
    }
#ifdef VGAN_HC_PHASE_CLOCKS
    const long long t4 = clock64();
    if (cur.live && sub == 0) {
      atomicAdd(&s_clk[0], (unsigned long long)(t1 - t0));
      atomicAdd(&s_clk[1], (unsigned long long)(t2 - t1));
      atomicAdd(&s_clk[2], (unsigned long long)(t3 - t2));
      atomicAdd(&s_clk[3], (unsigned long long)(t4 - t3));
    }
#endif
    cur = nxt;
  }
#ifdef VGAN_HC_PHASE_CLOCKS
  __syncthreads();
  if (threadIdx.x < 4) atomicAdd(&g_phase_cycles[threadIdx.x],
                                 s_clk[threadIdx.x]);
#endif
  bsum = block_sum(bsum, part);
  if (threadIdx.x == 0) {
    // every block waits, so the grid never ends before the zeroing
    asm volatile("griddepcontrol.wait;" ::: "memory");
    if (bsum != 0.0) atomicAdd(total_b, bsum);
  }
}

// resident blocks of one kernel on the current device, the grid's one
// wave (0 on an error); queried once a kernel
template <typename Kernel>
int wave_blocks(Kernel kernel) {
  static int wave = 0;
  int dev = 0, sms = 0, per_sm = 0;
  if (wave == 0 && cudaGetDevice(&dev) == cudaSuccess &&
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ==
          cudaSuccess &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, 0) ==
          cudaSuccess)
    wave = sms * per_sm;
  return wave;
}

template <typename CodeT, int G, int P>
int launch(const void* g, const void* r, const void* q, const void* mq,
           const uint8_t* use_bep, const int32_t* take, const uint8_t* valid,
           const int32_t* pang, const int32_t* node, const double* b,
           const Tables& t, double bep, bool consensus, long long M, int S,
           int n_nodes, double* c, double* total_b, cudaStream_t stream) {
  auto kernel = hc_node_scores_kernel<CodeT, G, P>;
  const int wave = wave_blocks(kernel);
  if (wave < 1) return (int)cudaGetLastError();
  constexpr int kRows = kThreads / G;
  const long long tiles = (M + kRows - 1) / kRows;
  hc_zero_kernel<<<(n_nodes + kThreads) / kThreads, kThreads, 0, stream>>>(
      c, n_nodes, total_b);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles < wave ? tiles : wave));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, (const CodeT*)g, (const CodeT*)r, (const CodeT*)q,
      (const CodeT*)mq, use_bep, take, valid, pang, node, b, t, bep,
      consensus, M, S, n_nodes, c, total_b);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <typename CodeT>
int launch_code(int S, const void* g, const void* r, const void* q,
                const void* mq, const uint8_t* use_bep, const int32_t* take,
                const uint8_t* valid, const int32_t* pang,
                const int32_t* node, const double* b, const Tables& t,
                double bep, bool consensus, long long M, int n_nodes,
                double* c, double* total_b, cudaStream_t st) {
#define HC_LAUNCH(G, P)                                                   \
  return launch<CodeT, G, P>(g, r, q, mq, use_bep, take, valid, pang, node, \
                             b, t, bep, consensus, M, S, n_nodes, c,        \
                             total_b, st)
  // up to kPerLane positions a lane on the fewest lanes; longer rows
  // take a warp a row with every 32nd position a lane
  if (S <= kPerLane) HC_LAUNCH(1, kPerLane);
  if (S <= 2 * kPerLane) HC_LAUNCH(2, kPerLane);
  if (S <= 4 * kPerLane) HC_LAUNCH(4, kPerLane);
  if (S <= 8 * kPerLane) HC_LAUNCH(8, kPerLane);
  if (S <= 16 * kPerLane) HC_LAUNCH(16, kPerLane);
  if (S <= 32 * kPerLane) HC_LAUNCH(32, kPerLane);
  HC_LAUNCH(32, 0);
#undef HC_LAUNCH
}

}  // namespace

extern "C" {

// The node vector c [n_nodes] and sum(b) [1] of M mapping rows of S
// positions on `stream`, both written (the launch zeroes them first).
// g, r, q [M, S] and mq [M]: uint8 (code_bytes 1) or int32 (code_bytes
// 4); use_bep [M] uint8, or null for every row set (consensus on the
// packed path); exactly one of take [M] int32 and valid [M, S] uint8;
// pang, node [M] int32; b [M] f64; the tables f64 with their lengths. All
// device pointers, contiguous, at any byte offset. Returns the first CUDA
// error of the launches (0 = launched), or cudaErrorInvalidValue for
// arguments it cannot take.
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
  if ((take == nullptr) == (valid == nullptr) || S < 0 || n_q < 1 ||
      n_im < 1 || n_match < 1 || n_mapp < 1 || n_bg < 1 || n_nodes < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (M <= 0) {
    hc_zero_kernel<<<(n_nodes + kThreads) / kThreads, kThreads, 0, st>>>(
        c, n_nodes, total_b);
    return (int)cudaGetLastError();
  }
  const Tables t{qtab, imtab, match_tab, mapp_tab, bg,
                 n_q, n_im, n_match, n_mapp, n_bg};
  if (code_bytes == 1)
    return launch_code<uint8_t>(S, g, r, q, mq, use_bep, take, valid, pang,
                                node, b, t, bep, consensus != 0, M, n_nodes,
                                c, total_b, st);
  if (code_bytes == 4)
    return launch_code<int32_t>(S, g, r, q, mq, use_bep, take, valid, pang,
                                node, b, t, bep, consensus != 0, M, n_nodes,
                                c, total_b, st);
  return (int)cudaErrorInvalidValue;
}

#ifdef VGAN_HC_PHASE_CLOCKS
// The cycles the main kernel's rows spent in each phase since the last
// call (row loads, table gathers, the S terms, the atomic add), summed
// over rows, into out [4]; then clears them. Returns a CUDA error code.
int hc_phase_clocks(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_phase_cycles,
                                       sizeof(g_phase_cycles));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[4] = {0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
}
#endif

}  // extern "C"
