// soibean's tree MCMC: S Metropolis-Hastings steps of B chain rows in one
// launch, for Hopper (sm_90a).
//
// Replaces the XLA program vgan_tpu/infer/tree_mcmc.py::_run_segment
// (:647-765, a lax.scan vmapped over rows by _run_segment_batch,
// :407-425), with its tree walk update_position (:161-295) and the HKY85
// 25-vector hky25 (:69-123). The plain PyTorch version is
// vgan_tpu_torch/infer/tree_mcmc.py::run_segment_plain.
//
// What it computes, per row and step: the pre-update state is written as
// the step's trace row; each source walks its tree node / branch position
// by a N(0, sd) move (hops bounded by the caller: burn_walk_hops in
// burn-in, 8 after it), its proportion takes a truncated N(theta, 0.1)
// step by inverse CDF and the proportions are renormalised; the proposal's
// log-likelihood is
//   sum_r logsumexp_y(log theta_y + logaddexp(log pos_y + LLc_y[r],
//                                             log(1 - pos_y) + LLp_y[r]))
//   LLc_y[r] = path_map[c_y, r] + counts25[c_y, r, :] . hky25(t2_y)
//   LLp_y[r] = path_map[p_y, r] + counts25[p_y, r, :] . hky25(t1_y)
// and the proposal is accepted when u <= min(1, exp(prop - cur)) (NaN
// rejects), always at iteration 0. Masked source slots (k-sweep padding)
// keep theta = 0 and weigh nothing. All arithmetic is f64; the noise comes
// in as f32, as the JAX package draws it.
//
// Bound. Each step of a row reads 2*K slices of path_map [R] f64 and of
// counts25 [R, 25] (uint8, int16 or f64 by the counts' range), so a
// segment moves S * B * 2K * R * (25 * count bytes + 8) bytes: at 3.35
// TB/s that is the bound (the f64 FMAs, 26 per read and slice, take less
// at 34 TFLOP/s). On top of it sits a serial floor per step: the walk (up
// to 32 dependent hops of shared-memory loads), the HKY vectors and a
// block reduction, between five barriers.
//
// Design (simple and right first, not fast):
// * One thread block per chain row, 512 threads. The row's state lives in
//   shared memory for the whole segment; the carry is written back at the
//   end.
// * The tree tables (parent, n_children, children, dist) are copied to
//   shared memory when they fit (else read from device memory) and read
//   with plain indexed loads. A lookup of a node outside [0, N) returns
//   zeros, as the JAX package's one-hot select-reduce did, so no index is
//   ever -1; the walk evaluates only the branch it takes.
// * Threads 0..K-1 walk their source and update its proportion; 50*K
//   threads compute one HKY entry each (child and parent vectors); all
//   threads stride over the reads with an online logsumexp over sources;
//   a warp-shuffle then shared-memory reduction sums the reads in a fixed
//   order; thread 0 decides the accept.
// * The walk's products (delta * sd, u * n) use __dmul_rn so that no
//   multiply-add is contracted there: node ids must equal the plain
//   version's exactly.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTreeSmemMax = 160 * 1024;  // bytes of tree tables in smem

struct Args {
  int* nodes;           // [B, K] carry, in/out
  double* pos;          // [B, K]
  double* theta;        // [B, K]
  double* ll;           // [B]
  const uint8_t* mask;  // [B, K] bool
  const long long* iters;  // [S]
  const double* sd;        // [S]
  const float* deltas;     // [B, S, K]
  const float* walk_u;     // [B, S, K, hops, 4]
  const float* trunc_u;    // [B, S, K]
  const float* acc_u;      // [B, S]
  const double* pm;        // [P, R]
  const void* counts;      // [P, R, 25]
  const int* parent;       // [N]
  const double* dist;      // [N]
  const int* kids;         // [N, Cc]
  const int* nch;          // [N]
  const double* freq;      // [7] A C G T R Y M
  double con;
  int* rec_nodes;     // [B, S, K]
  double* rec_pos;    // [B, S, K]
  double* rec_theta;  // [B, S, K]
  double* rec_ll;     // [B, S]
  int B, S, K, hops, R, P, N, Cc;
  int tree_in_smem;
};

struct Tree {
  const int* parent;
  const int* nch;
  const int* kids;
  const double* dist;
  int N, Cc;
  __device__ bool in(int n) const { return n >= 0 && n < N; }
  __device__ int par(int n) const { return in(n) ? parent[n] : 0; }
  __device__ int nc(int n) const { return in(n) ? nch[n] : 0; }
  __device__ int kid(int n, int j) const {
    return in(n) ? kids[(long long)n * Cc + j] : 0;
  }
  __device__ double d(int n) const { return in(n) ? dist[n] : 0.0; }
};

// kids[j], j = min(floor(u * max(nc, 1)), max(nc, 1) - 1)
__device__ int pick(const Tree& T, int n, float u) {
  const double ncm = fmax((double)T.nc(n), 1.0);
  const double j = fmin(floor(__dmul_rn((double)u, ncm)), ncm - 1.0);
  return T.kid(n, (int)j);
}

// update_position: a move of d >= 0 in direction fwd, one branch a hop
__device__ void walk(const Tree& T, int& node, double& pos, double d,
                     bool fwd, const float* u, int hops) {
  for (int h = 0; h < hops && d > 0.0; ++h, u += 4) {
    const int par = T.par(node);
    const int nc = T.nc(node);
    const bool is_leaf = nc == 0, is_root = par < 0;
    if (fwd) {
      if (pos + d < 1.0) {  // stay on the branch
        pos = pos + d;
        d = 0.0;
      } else if (is_leaf) {  // leaf bounce
        fwd = false;
      } else {  // cross into a random child
        const double rem = fmax(d - (1.0 - pos), 0.0);
        const int child = pick(T, node, u[0]);
        if (rem > 1.0) {
          pos = 1.0;
          d = rem - 1.0;
        } else {
          pos = rem;
          d = 0.0;
        }
        node = child;
      }
    } else if (pos - d > 0.0) {  // stay on the branch
      pos = pos - d;
      d = 0.0;
    } else if (is_root) {  // root bounce into a random child
      node = pick(T, node, u[2]);
      fwd = true;
    } else {  // the parent, or (internal nodes) a sibling
      const int pr = max(par, 0);
      const double nsib =
          is_leaf ? 0.0 : fmax((double)T.nc(pr), 1.0) - 1.0;
      const double n_possible = 1.0 + nsib;
      const double pickv =
          fmin(floor(__dmul_rn((double)u[1], n_possible)),
               fmax(n_possible, 1.0) - 1.0);
      if (pickv == 0.0) {
        const double remb = fmax(d - pos, 0.0);
        if (remb > 1.0) {
          pos = 0.0;
          d = remb - 1.0;
        } else {
          pos = fmin(fmax(1.0 - remb, 1e-12), 1.0);
          d = 0.0;
        }
        node = par;
      } else {
        const double sib_j = pickv - 1.0;
        int self_pos = 0;  // argmax(kids_par == node): 0 when absent
        for (int j = 0; j < T.Cc; ++j) {
          if (T.kid(pr, j) == node) {
            self_pos = j;
            break;
          }
        }
        double sib_idx = sib_j + (sib_j >= (double)self_pos ? 1.0 : 0.0);
        sib_idx = fmin(fmax(sib_idx, 0.0), (double)(T.Cc - 1));
        const int sibling = T.kid(pr, (int)sib_idx);
        const double rems = d - pos;
        if (rems < 1.0) {
          pos = fmax(rems, 0.0);
          d = 0.0;
          node = sibling;
          fwd = true;
        } else if (T.nc(sibling) == 0) {  // keeps d, turns back
          pos = 0.0;
          node = sibling;
          fwd = false;
        } else {  // into a random child of the sibling, forward
          const double rems2 = fmax(d - 1.0, 0.0);
          const int sc = pick(T, sibling, u[3]);
          if (rems2 > 1.0) {
            pos = 1.0;
            d = rems2 - 1.0;
          } else {
            pos = rems2;
            d = 0.0;
          }
          node = sc;
          fwd = true;
        }
      }
    }
  }
}

// one entry (graph class g, read class rc) of hky25(t)
__device__ double hky_entry(double t, int g, int rc, double con,
                            const double* fr) {
  const double R = fr[4], Y = fr[5], mu = fr[6];
  const double AR = 1.0 + R * (0.0 - 1.0);  // kappa = 0 (1/22 in ints)
  const double AY = 1.0 + Y * (0.0 - 1.0);
  const double emt = exp(-(mu * t));
  const double lcm = log1p(-con), lcx = log(con / 3.0);
  const int partner = g ^ 2;  // A<->G, C<->T
  double x[4];
  double m = -INFINITY;
  for (int b = 0; b < 4; ++b) {
    const double f = fr[b];
    const bool purine = (b & 1) == 0;
    const double grp_f = purine ? R : Y;
    const double grp_A = purine ? AR : AY;
    const double e_grp = exp(-(mu * t * grp_A));
    const double jut1 = f + f * (1.0 / grp_f - 1.0) * emt;
    double p;
    if (g < 4 && b == g) {
      p = fmax(jut1 + ((grp_f - f) / grp_f) * e_grp, 1e-8);
    } else if (g < 4 && b == partner) {
      p = fmax(fabs(jut1 - (f / grp_f) * e_grp), 1e-8);
    } else {
      p = fmax(f * (1.0 - emt), 1e-8);
    }
    x[b] = log(p) + ((rc < 4 && b == rc) ? lcm : lcx);
    m = fmax(m, x[b]);
  }
  double s = 0.0;
  for (int b = 0; b < 4; ++b) s += exp(x[b] - m);
  const double v = m + log(s);
  return v > 1e-8 ? log(0.999999999) : v;
}

__device__ __forceinline__ double count_at(const uint8_t* c, size_t i) {
  return (double)c[i];
}
__device__ __forceinline__ double count_at(const int16_t* c, size_t i) {
  return (double)c[i];
}
__device__ __forceinline__ double count_at(const double* c, size_t i) {
  return c[i];
}

// shared-memory layout of one block
struct Smem {
  double *pos, *theta, *npos, *ntraw, *nt, *t, *lpos, *l1m, *lth, *h, *red;
  int *node, *nnode, *c, *p;
  int* flag;
  double* cur;
};

__host__ __device__ inline size_t align8(size_t x) { return (x + 7) & ~size_t(7); }

__host__ __device__ inline size_t tree_bytes(int N, int Cc) {
  return align8((size_t)N * 8) + align8((size_t)N * 4) * 2 +
         align8((size_t)N * Cc * 4);
}

__host__ __device__ inline size_t state_bytes(int K) {
  // 8 K-vectors and t[2K] of f64, h[2K*25], red[kWarps], cur; 4 int
  // K-vectors and a flag
  return (size_t)8 * (8 * K + 2 * K + 50 * K + kWarps + 1) +
         align8((size_t)4 * (4 * K + 1));
}

template <typename CT>
__global__ void __launch_bounds__(kThreads)
    tree_mcmc_segment_kernel(const Args a) {
  extern __shared__ double smem_raw[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int K = a.K, S = a.S, R = a.R;
  char* base = reinterpret_cast<char*>(smem_raw);

  Tree T{a.parent, a.nch, a.kids, a.dist, a.N, a.Cc};
  if (a.tree_in_smem) {
    double* sd_ = reinterpret_cast<double*>(base);
    int* sp = reinterpret_cast<int*>(base + align8((size_t)a.N * 8));
    int* sn = reinterpret_cast<int*>(reinterpret_cast<char*>(sp) +
                                     align8((size_t)a.N * 4));
    int* sk = reinterpret_cast<int*>(reinterpret_cast<char*>(sn) +
                                     align8((size_t)a.N * 4));
    for (int i = tid; i < a.N; i += kThreads) {
      sd_[i] = a.dist[i];
      sp[i] = a.parent[i];
      sn[i] = a.nch[i];
    }
    for (int i = tid; i < a.N * a.Cc; i += kThreads) sk[i] = a.kids[i];
    T = Tree{sp, sn, sk, sd_, a.N, a.Cc};
    base += tree_bytes(a.N, a.Cc);
  }
  Smem s;
  double* dp = reinterpret_cast<double*>(base);
  s.pos = dp; dp += K;
  s.theta = dp; dp += K;
  s.npos = dp; dp += K;
  s.ntraw = dp; dp += K;
  s.nt = dp; dp += K;
  s.lpos = dp; dp += K;
  s.l1m = dp; dp += K;
  s.lth = dp; dp += K;
  s.t = dp; dp += 2 * K;
  s.h = dp; dp += 50 * K;
  s.red = dp; dp += kWarps;
  s.cur = dp; dp += 1;
  int* ip = reinterpret_cast<int*>(dp);
  s.node = ip; ip += K;
  s.nnode = ip; ip += K;
  s.c = ip; ip += K;
  s.p = ip; ip += K;
  s.flag = ip;

  for (int y = tid; y < K; y += kThreads) {
    s.node[y] = a.nodes[b * K + y];
    s.pos[y] = a.pos[b * K + y];
    s.theta[y] = a.theta[b * K + y];
  }
  if (tid == 0) *s.cur = a.ll[b];
  const CT* counts = reinterpret_cast<const CT*>(a.counts);
  __syncthreads();

  for (int st = 0; st < S; ++st) {
    const long long it = a.iters[st];
    const double sd = a.sd[st];
    const size_t row = (size_t)b * S + st;
    // 1. record the pre-update state; walk; propose theta
    for (int y = tid; y < K; y += kThreads) {
      const size_t idx = row * K + y;
      int node = s.node[y];
      double pos = s.pos[y];
      const double theta = s.theta[y];
      a.rec_nodes[idx] = node;
      a.rec_pos[idx] = pos;
      a.rec_theta[idx] = theta;
      const double delta = __dmul_rn((double)a.deltas[idx], sd);
      walk(T, node, pos, fabs(delta), delta >= 0.0,
           a.walk_u + idx * a.hops * 4, a.hops);
      if (it == 0) {
        node = s.node[y];
        pos = s.pos[y];
      }
      s.nnode[y] = node;
      s.npos[y] = fmin(fmax(pos, 1e-12), 1.0 - 1e-10);
      const double lo = (0.0 - theta) / 0.1;
      const double hi = (1.0 - theta) / 0.1;
      const double plo = normcdf(lo);
      const double phi = normcdf(hi);
      const double u = fmin(fmax((double)a.trunc_u[idx], 1e-7), 1.0 - 1e-7);
      double z = normcdfinv(__dadd_rn(plo, __dmul_rn(u, phi - plo)));
      z = fmin(fmax(z, lo), hi);
      s.ntraw[y] =
          __dadd_rn(theta, __dmul_rn(0.1, a.mask[b * K + y] ? z : 0.0));
    }
    if (tid == 0) a.rec_ll[row] = *s.cur;
    __syncthreads();
    // 2. renormalise; per-source constants of the likelihood
    for (int y = tid; y < K; y += kThreads) {
      double sum = 0.0;
      for (int j = 0; j < K; ++j) sum += s.ntraw[j];
      const double nt = s.ntraw[y] / sum;
      s.nt[y] = nt;
      const int c = s.nnode[y];
      const int pr = T.par(c);
      double t = T.d(c);
      if (t == 0.0) t = 1e-5;
      const double npos = s.npos[y];
      const double t1 = __dmul_rn(npos, t);
      s.t[2 * y] = t - t1;  // child side
      s.t[2 * y + 1] = t1;  // parent side
      s.c[y] = min(max(c, 0), a.P - 1);
      s.p[y] = min(max(pr < 0 ? c : pr, 0), a.P - 1);
      s.lpos[y] = log(npos);
      s.l1m[y] = log1p(-npos);
      s.lth[y] = a.mask[b * K + y] ? log(nt) : -INFINITY;
    }
    __syncthreads();
    // 3. the 2K HKY vectors, one entry a thread
    for (int e = tid; e < 50 * K; e += kThreads) {
      const int ent = e % 25;
      s.h[e] = hky_entry(s.t[e / 25], ent / 5, ent % 5, a.con, a.freq);
    }
    __syncthreads();
    // 4. the reads: online logsumexp over the active sources
    double acc = 0.0;
    for (int r = tid; r < R; r += kThreads) {
      double m = -INFINITY, ssum = 0.0;
      for (int y = 0; y < K; ++y) {
        if (!a.mask[b * K + y]) continue;
        const int c = s.c[y], p = s.p[y];
        const double* hc = s.h + 50 * y;
        const double* hp = hc + 25;
        const size_t oc = ((size_t)c * R + r) * 25;
        const size_t op = ((size_t)p * R + r) * 25;
        double dc = 0.0, dpp = 0.0;
#pragma unroll
        for (int j = 0; j < 25; ++j) {
          dc = fma(count_at(counts, oc + j), hc[j], dc);
          dpp = fma(count_at(counts, op + j), hp[j], dpp);
        }
        const double x1 = s.lpos[y] + (a.pm[(size_t)c * R + r] + dc);
        const double x2 = s.l1m[y] + (a.pm[(size_t)p * R + r] + dpp);
        const double mx = fmax(x1, x2);
        const double v = mx + log1p(exp(-fabs(x1 - x2))) + s.lth[y];
        if (v == -INFINITY) continue;  // theta 0: weighs nothing
        if (v > m) {
          ssum = ssum * exp(m - v) + 1.0;
          m = v;
        } else {
          ssum += exp(v - m);
        }
      }
      acc += m + log(ssum);
    }
    // 5. fixed-order block sum
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if ((tid & 31) == 0) s.red[tid >> 5] = acc;
    __syncthreads();
    // 6. accept
    if (tid == 0) {
      double prop = 0.0;
      for (int w = 0; w < kWarps; ++w) prop += s.red[w];
      const double ratio = exp(prop - *s.cur);
      const double pa = isnan(ratio) ? ratio : fmin(1.0, ratio);
      const bool accept = it == 0 || (double)a.acc_u[row] <= pa;
      *s.flag = accept;
      if (accept) *s.cur = prop;
    }
    __syncthreads();
    if (*s.flag) {
      for (int y = tid; y < K; y += kThreads) {
        s.node[y] = s.nnode[y];
        s.pos[y] = s.npos[y];
        s.theta[y] = s.nt[y];
      }
    }
    __syncthreads();
  }
  for (int y = tid; y < K; y += kThreads) {
    a.nodes[b * K + y] = s.node[y];
    a.pos[b * K + y] = s.pos[y];
    a.theta[b * K + y] = s.theta[y];
  }
  if (tid == 0) a.ll[b] = *s.cur;
}

template <typename CT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = (a.tree_in_smem ? tree_bytes(a.N, a.Cc) : 0) +
                      state_bytes(a.K);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        tree_mcmc_segment_kernel<CT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  tree_mcmc_segment_kernel<CT><<<a.B, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// C entry point (ctypes). count_dtype: 0 uint8, 1 int16, 2 float64.
// Launches on the given stream, does not synchronise, and returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for an
// unknown count type or a source count whose state does not fit a block.
extern "C" int tree_mcmc_segment_launch(
    void* nodes, void* pos, void* theta, void* ll, const void* mask,
    const void* iters, const void* sd, const void* deltas,
    const void* walk_u, const void* trunc_u, const void* acc_u,
    const void* path_map_t, const void* counts25_t, int count_dtype,
    const void* parent, const void* dist, const void* children,
    const void* n_children, const void* freq, double con, void* rec_nodes,
    void* rec_pos, void* rec_theta, void* rec_ll, int B, int S, int K,
    int hops, int R, int P, int N, int Cc, void* stream) {
  Args a;
  a.nodes = (int*)nodes;
  a.pos = (double*)pos;
  a.theta = (double*)theta;
  a.ll = (double*)ll;
  a.mask = (const uint8_t*)mask;
  a.iters = (const long long*)iters;
  a.sd = (const double*)sd;
  a.deltas = (const float*)deltas;
  a.walk_u = (const float*)walk_u;
  a.trunc_u = (const float*)trunc_u;
  a.acc_u = (const float*)acc_u;
  a.pm = (const double*)path_map_t;
  a.counts = counts25_t;
  a.parent = (const int*)parent;
  a.dist = (const double*)dist;
  a.kids = (const int*)children;
  a.nch = (const int*)n_children;
  a.freq = (const double*)freq;
  a.con = con;
  a.rec_nodes = (int*)rec_nodes;
  a.rec_pos = (double*)rec_pos;
  a.rec_theta = (double*)rec_theta;
  a.rec_ll = (double*)rec_ll;
  a.B = B;
  a.S = S;
  a.K = K;
  a.hops = hops;
  a.R = R;
  a.P = P;
  a.N = N;
  a.Cc = Cc;
  a.tree_in_smem = tree_bytes(N, Cc) <= (size_t)kTreeSmemMax;
  if (state_bytes(K) + (a.tree_in_smem ? tree_bytes(N, Cc) : 0) >
      (size_t)227 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  switch (count_dtype) {
    case 0: return (int)launch<uint8_t>(a, st);
    case 1: return (int)launch<int16_t>(a, st);
    case 2: return (int)launch<double>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
