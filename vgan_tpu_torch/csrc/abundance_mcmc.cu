// euka's abundance MCMC: S Metropolis-Hastings steps of one chain in one
// launch, for Hopper (sm_90a).
//
// Replaces the XLA program vgan_tpu/infer/abundance_mcmc.py::_run_seg
// (:60-78, a lax.scan over per-iteration keys, with _proposal_and_loglik
// :52-57). The plain PyTorch version is
// vgan_tpu_torch/infer/abundance_mcmc.py::run_segment_plain.
//
// What it computes, per step s over T taxa (every value f64):
//   x_t    = log(current_t) + alpha * z[s, t]
//   prop   = softmax(x)      (max, exp(x - max), sum, divide, as torch)
//   ll     = sum_t n_t * log(prop_t) + const_ll
//   accept = u[s] <= min(1, exp(ll - cur_ll)); a NaN ratio rejects
//   out[s] = prop            (the PROPOSAL is recorded: reference quirk)
//   on accept: current = prop, cur_ll = ll
// 0 * log(0) is NaN, as in torch, so a proposal that underflows a taxon
// with no reads rejects; const_ll = -inf gives ll = -inf, which rejects
// against the start likelihood.
//
// Bound. z read once and the proposals written once: 2 * S * T * 8 bytes,
// ~0.5 us at euka's T = 3 and S = 9,899 over 3.35 TB/s, so bytes bound
// nothing: a step is a chain of dependent f64 operations (an add and a
// multiply, a max, exp, a sum, a division, log, a third sum, exp) and its
// latency sets the time.
//
// Design: a window of proposals from one state (pre-fetching
// Metropolis-Hastings). Most steps reject, and while the state does not
// change the next proposals depend only on that state and on their own
// noise. So a round evaluates the d proposals of steps s0 .. s0 + d - 1
// at once, all from the state (log(current), cur_ll) at s0, each with the
// arithmetic of the sequential chain; the first that accepts, j*, is found
// with a ballot (and across warps through shared memory); steps
// s0 .. s0 + j* write their proposals, which are exactly the sequential
// chain's, since the state did not move before j*; the state becomes step
// j*'s log(prop) and ll, and the next round starts at s0 + j* + 1 (at
// s0 + d when nothing accepts). A step's arithmetic depends only on the
// state and on its own noise, never on where its window began, so a
// segment cut anywhere (mid-window too) resumes bit for bit.
//
// Layout, from T alone: a group of G lanes holds one proposal, each lane
// K of its taxa (t = lane-in-group + G * k) in registers: a taxon a lane
// (G = T rounded up to a power of two) up to T = 32, then a warp a
// proposal with K = ceil(T / 32). The max, the sum and the
// log-likelihood are serial over a lane's K taxa, then width-G xor
// butterflies. Not a proposal a thread with its taxa serial: exp,
// division and log each branch to a slow path, so a thread runs its
// taxa's chains one after another, where log2(G) shuffle levels add a
// few shuffle latencies. A warp holds 32 / G proposals and W consumer
// warps (1..8) a window of d = 32 W / G. W = 1 exchanges j* and the state
// by shuffles; W > 1 leave each warp's first accept and its state in
// shared memory (two sets, by round parity) behind one named barrier a
// round.
//
// Noise: z and u rows are staged in a ring of R rows in shared memory by
// a producer warp (warp W) with cp.async, up to R rows ahead of the
// consumers' progress, which they publish with a release store each time
// it has moved a batch of rows on; the producer publishes the rows landed
// the same way. A round reads its rows at shared-memory latency, wherever
// j* lands.
//
// The state itself is not held, only its log: on accept it is the
// proposal's own log(prop), the same function of the same value the plain
// version takes the next step. The final state is read back from the
// last accepted step's row of `out`. Products and sums use __dmul_rn /
// __dadd_rn, so no multiply-add is contracted where torch rounds twice.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;               // consumer warps of a window
constexpr int kRingBytes = 192 * 1024;     // the ring of staged noise rows
constexpr int kMaxShared = 227 * 1024;     // a block's shared memory
constexpr int kBarrier = 1;                // the consumers' named barrier
constexpr int kBatchValues = 2048;         // noise values a producer batch

// max that propagates a NaN, as torch's max reduction does
__device__ __forceinline__ double nan_max(double a, double b) {
  return (a > b || a != a) ? a : b;
}

template <int G>
__device__ __forceinline__ double group_max(double v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

template <int G>
__device__ __forceinline__ double group_sum(double v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    v = __dadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ long long load_acquire(const long long* p) {
  long long v;
  asm volatile("ld.acquire.cta.shared.b64 %0, [%1];"
               : "=l"(v) : "r"(smem_addr(p)) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(long long* p, long long v) {
  asm volatile("st.release.cta.shared.b64 [%0], %1;"
               :: "r"(smem_addr(p)), "l"(v) : "memory");
}

__device__ __forceinline__ void copy_async8(double* dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void consumers_sync(int n_threads) {
  asm volatile("bar.sync %0, %1;" :: "r"(kBarrier), "r"(n_threads)
               : "memory");
}

// the shared memory of a launch: ring z [R, T], ring u [R], n_reads [T],
// each warp's accepted state (log(prop) [T] and ll, two sets by round
// parity), then the two progress counters and each warp's first accept
// (two sets)
struct Smem {
  double *z, *u, *n, *st;
  long long *ready, *done;
  int* first;
};

__host__ __device__ inline size_t fixed_bytes(int T, int W) {
  return sizeof(double) * ((size_t)T + 2 * (size_t)W * (T + 1)) +
         2 * sizeof(long long) + 2 * kMaxWarps * sizeof(int);
}

__host__ __device__ inline size_t smem_bytes(int R, int T, int W) {
  return sizeof(double) * ((size_t)R * T + R) + fixed_bytes(T, W);
}

__device__ inline Smem carve(double* base, int R, int T, int W) {
  Smem m;
  m.z = base;
  m.u = m.z + (size_t)R * T;
  m.n = m.u + R;
  m.st = m.n + T;
  m.ready = (long long*)(m.st + 2 * (size_t)W * (T + 1));
  m.done = m.ready + 1;
  m.first = (int*)(m.done + 1);
  return m;
}

// Rows a producer batch: ~kBatchValues values, at most half the ring's
// slack over a window (the consumers publish their progress each time it
// has moved a batch on, so the ring always holds the next window).
__host__ __device__ inline int batch_rows(int T, int R, int d) {
  int b = kBatchValues / T;
  if (b > (R - d) / 2) b = (R - d) / 2;
  return b < 1 ? 1 : b;
}

// The producer warp: copies the rows [ready, done + R) of z and u into
// the ring as the consumers free them (row r in slot r mod R), a batch at
// a time, and publishes the rows landed.
__device__ void produce(const Smem& m, const double* __restrict__ z,
                        const double* __restrict__ u, int T, long long S,
                        int R, int batch, int lane) {
  const long long RT = (long long)R * T;
  long long ready = 0;
  while (ready < S) {
    long long lim = 0;
    if (lane == 0) lim = load_acquire(m.done) + R;
    lim = __shfl_sync(kFull, lim, 0);
    lim = lim < S ? lim : S;
    if (lim <= ready) {
      __nanosleep(32);
      continue;
    }
    if (lim > ready + batch) lim = ready + batch;
    long long i = ready * T + lane, j = i % RT;
    for (; i < lim * T; i += 32) {
      copy_async8(m.z + j, z + i);
      j += 32;
      while (j >= RT) j -= RT;
    }
    for (long long r = ready + lane; r < lim; r += 32)
      copy_async8(m.u + r % R, u + r);
    asm volatile("cp.async.commit_group;\ncp.async.wait_all;" ::: "memory");
    __syncwarp();
    if (lane == 0) store_release(m.ready, lim);
    ready = lim;
  }
}

// kBlock: the consumer warps and the producer warp
template <int G, int K, bool kOneWarp,
          int kBlock = kOneWarp ? 64 : 32 * (kMaxWarps + 1)>
__global__ void __launch_bounds__(kBlock) abundance_mcmc_segment_kernel(
    double* __restrict__ current, double* __restrict__ cur_ll_io,
    const double* __restrict__ z, const double* __restrict__ u,
    const double* __restrict__ n_reads, const double* __restrict__ const_ll,
    double alpha, int T, long long S, double* __restrict__ out, int R,
    int W) {
  extern __shared__ double smem[];
  const Smem m = carve(smem, R, T, W);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int t = tid; t < T; t += blockDim.x) m.n[t] = n_reads[t];
  if (tid == 0) {
    *m.ready = 0;
    *m.done = 0;
  }
  __syncthreads();
  constexpr int kPerWarp = 32 / G;  // proposals a warp
  const int d = W * kPerWarp;       // the window
  const int batch = batch_rows(T, R, d);
  if (warp == W) {
    produce(m, z, u, T, S, R, batch, lane);
    return;
  }
  const int sub = lane % G;                  // lane in its group
  const int p = warp * kPerWarp + lane / G;  // proposal in the window
  const int n_consumers = 32 * W;
  const double cst = *const_ll;
  // a lane's taxa; with K = 1 a lane past T computes too, on values
  // that keep exp, division and log on their fast paths (exp(0), then
  // 1 / sum), and its max, share and term are masked: no branch splits
  // the warp
  constexpr bool kRegs = K <= 8;  // n_reads in registers, else shared
  double logc[K], nr[kRegs ? K : 1];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = sub + G * k;
    logc[k] = t < T ? log(current[t]) : 0.0;
    if (kRegs) nr[k] = t < T ? n_reads[t] : 0.0;
  }
  double cll = *cur_ll_io;
  long long s0 = 0, last = -1, seen = 0, published = 0;
  int slot0 = 0;  // s0 mod R
  for (int round = 0; s0 < S; ++round) {
    const long long need = s0 + d < S ? s0 + d : S;
    while (seen < need) {
      seen = load_acquire(m.ready);
      if (seen < need) __nanosleep(16);
    }
    const long long s = s0 + p;
    const bool live = s < S;
    int slot = slot0;
    if (live) {
      slot += p;
      if (slot >= R) slot -= R;
    }
    const double* zr = m.z + (size_t)slot * T;
    const double uc = m.u[slot];
    double v[K], lp[K];
    double mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int t = sub + G * k;
      v[k] = 0.0;
      lp[k] = 0.0;
      if (K == 1 || t < T) {
        v[k] = __dadd_rn(logc[k], __dmul_rn(alpha, t < T ? zr[t] : 0.0));
        mx = nan_max(mx, t < T ? v[k] : -INFINITY);
      }
    }
    mx = group_max<G>(mx);
    double sum = 0.0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int t = sub + G * k;
      if (K == 1 || t < T) {
        v[k] = exp(t < T ? __dsub_rn(v[k], mx) : 0.0);
        sum = __dadd_rn(sum, t < T ? v[k] : 0.0);
      }
    }
    sum = group_sum<G>(sum);
    double ll = 0.0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int t = sub + G * k;
      if (K == 1 || t < T) {
        v[k] = __ddiv_rn(v[k], sum);
        lp[k] = log(v[k]);
        const double term = __dmul_rn(kRegs ? nr[kRegs ? k : 0] : m.n[t],
                                      lp[k]);
        ll = __dadd_rn(ll, t < T ? term : 0.0);
      }
    }
    ll = __dadd_rn(group_sum<G>(ll), cst);
    const double dl = __dsub_rn(ll, cll);
    const double ratio = exp(dl);
    // a NaN ratio rejects (fmin(1, NaN) would be 1 and accept)
    const bool accept = live && dl == dl && uc <= (ratio < 1.0 ? ratio : 1.0);
    // j*: the first proposal of the window that accepts, d if none
    const unsigned bal = __ballot_sync(kFull, accept && sub == 0);
    const int jw = bal ? (__ffs(bal) - 1) / G : kPerWarp;  // in this warp
    int jstar = jw;
    const double* won = nullptr;  // W > 1: the accepted state's slot
    if (!kOneWarp) {
      // each warp's first accept leaves its state in its slot, then one
      // barrier; slots and first accepts alternate by round parity
      const int slot_w = (round & 1) * W + warp;
      if (bal && lane / G == jw) {
        double* st = m.st + (size_t)slot_w * (T + 1);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int t = sub + G * k;
          if (t < T) st[t] = lp[k];
        }
        if (sub == 0) st[T] = ll;
      }
      int* first = m.first + (round & 1) * kMaxWarps;
      if (lane == 0) first[warp] = bal ? warp * kPerWarp + jw : d;
      consumers_sync(n_consumers);  // also: every ring read is done
      jstar = __reduce_min_sync(kFull, lane < W ? first[lane] : d);
      if (jstar < d)
        won = m.st + (size_t)((round & 1) * W + jstar / kPerWarp) * (T + 1);
    }
    if (live && p <= jstar) {
      double* o = out + s * T;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int t = sub + G * k;
        if (t < T) o[t] = v[k];
      }
    }
    int step = d;
    if (jstar < d) {
      if (kOneWarp) {
        const int src = jstar * G + sub;
#pragma unroll
        for (int k = 0; k < K; ++k)
          logc[k] = __shfl_sync(kFull, lp[k], src);
        cll = __shfl_sync(kFull, ll, src);
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int t = sub + G * k;
          if (t < T) logc[k] = won[t];
        }
        cll = won[T];
      }
      last = s0 + jstar;
      step = jstar + 1;
    }
    s0 += step;
    slot0 += step;
    while (slot0 >= R) slot0 -= R;
    if (s0 - published >= batch) {  // free the ring's rows below s0
      if (kOneWarp) __syncwarp();   // every lane's ring reads are done
      if (tid == 0) store_release(m.done, s0);
      published = s0;
    }
  }
  // the state is the last accepted proposal, written by its own lanes
  if (kOneWarp)
    __syncwarp();
  else
    consumers_sync(n_consumers);
  if (last >= 0)
    for (int t = tid; t < T; t += n_consumers) current[t] = out[last * T + t];
  if (tid == 0) *cur_ll_io = cll;
}

struct Args {
  double *current, *cur_ll;
  const double *z, *u, *n_reads, *const_ll;
  double alpha;
  int T;
  long long S;
  double* out;
};

template <int G, int K>
int launch(const Args& a, int W, cudaStream_t stream) {
  const int d = W * (32 / G);
  const long long room = (long long)kMaxShared - fixed_bytes(a.T, W);
  const long long ring = room < kRingBytes ? room : kRingBytes;
  const long long fit = ring / (long long)(sizeof(double) * (a.T + 1));
  const int R = (int)(a.S < fit ? a.S : fit);
  // a window must fit in the ring, unless the ring holds the whole segment
  if (R < 1 || (R <= d && R < a.S)) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(R, a.T, W);
  auto kernel = W == 1 ? abundance_mcmc_segment_kernel<G, K, true>
                       : abundance_mcmc_segment_kernel<G, K, false>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<1, 32 * (W + 1), bytes, stream>>>(
      a.current, a.cur_ll, a.z, a.u, a.n_reads, a.const_ll, a.alpha, a.T,
      a.S, a.out, R, W);
  return (int)cudaGetLastError();
}

// lanes a proposal: a taxon a lane (T rounded up to a power of two) up to
// a warp, then a warp with K = ceil(T / 32) taxa a lane
int group_lanes(int T) {
  int G = 1;
  while (G < 32 && G < T) G *= 2;
  return G;
}

// consumer warps when the caller leaves the choice: a window of about
// 24 proposals (at least a warp's 32 / G), at most kMaxWarps warps. More
// than one warp costs a barrier a round, and a wider window pays only
// where few steps accept (chip_smoke.py's window sweep; PERF.md)
int default_warps(int T) {
  const int W = (3 * group_lanes(T) + 3) / 4;
  return W < kMaxWarps ? W : kMaxWarps;
}

int dispatch(const Args& a, int W, cudaStream_t st) {
  const int G = group_lanes(a.T);
  const int K = (a.T + G - 1) / G;
  switch (G) {
    case 1: return launch<1, 1>(a, W, st);
    case 2: return launch<2, 1>(a, W, st);
    case 4: return launch<4, 1>(a, W, st);
    case 8: return launch<8, 1>(a, W, st);
    case 16: return launch<16, 1>(a, W, st);
    default:
      if (K <= 1) return launch<32, 1>(a, W, st);
      if (K <= 2) return launch<32, 2>(a, W, st);
      if (K <= 4) return launch<32, 4>(a, W, st);
      if (K <= 8) return launch<32, 8>(a, W, st);
      if (K <= 16) return launch<32, 16>(a, W, st);
      return launch<32, 32>(a, W, st);
  }
}

}  // namespace

extern "C" {

// S steps of the chain over T taxa on `stream`, with `warps` consumer
// warps (1..8; 0: the kernel's choice, a window of 32 proposals where
// T allows): current [T] and cur_ll [1] (device f64, updated in place),
// z [S, T] and u [S] (the noise), n_reads [T], const_ll [1], out [S, T]
// (the proposals), all device f64 and contiguous. Every choice of warps
// gives the same bits. Returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for T outside 1..1,024 or a window the ring
// cannot hold.
int abundance_mcmc_segment_launch_warps(double* current, double* cur_ll,
                                        const double* z, const double* u,
                                        const double* n_reads,
                                        const double* const_ll, double alpha,
                                        int T, long long S, double* out,
                                        int warps, void* stream) {
  if (S <= 0) return 0;
  if (T < 1 || T > 1024 || warps < 0 || warps > kMaxWarps)
    return (int)cudaErrorInvalidValue;
  const Args a{current, cur_ll, z, u, n_reads, const_ll, alpha, T, S, out};
  return dispatch(a, warps ? warps : default_warps(T),
                  (cudaStream_t)stream);
}

// The window (proposals a round) of the kernel for T taxa and `warps`
// (0: the kernel's choice), or 0 for arguments it does not take.
int abundance_mcmc_window(int T, int warps) {
  if (T < 1 || T > 1024 || warps < 0 || warps > kMaxWarps) return 0;
  return (warps ? warps : default_warps(T)) * (32 / group_lanes(T));
}

// The same with the kernel's choice of warps.
int abundance_mcmc_segment_launch(double* current, double* cur_ll,
                                  const double* z, const double* u,
                                  const double* n_reads,
                                  const double* const_ll, double alpha,
                                  int T, long long S, double* out,
                                  void* stream) {
  return abundance_mcmc_segment_launch_warps(current, cur_ll, z, u, n_reads,
                                             const_ll, alpha, T, S, out, 0,
                                             stream);
}

}  // extern "C"
