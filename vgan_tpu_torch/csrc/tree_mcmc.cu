// soibean's tree MCMC: S Metropolis-Hastings steps of B chain rows in one
// launch, for Hopper (sm_90a).
//
// Replaces the XLA program vgan_tpu/infer/tree_mcmc.py::_run_segment
// (:645-765, a lax.scan vmapped over rows by _run_segment_batch,
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
// counts25 [R, 25] (uint8, int16 or f64 by the counts' range); all of
// them fit in the 50 MB L2 at soibean's sizes (255 paths x 4,000 reads x
// 25 bytes), so a step is not bound by device memory but by its f64 work
// (per read and active source: 50 count conversions, 50 FMAs and ~3
// exp/log1p sequences) and by a serial floor: the walk (dependent
// shared-memory loads, up to 32 hops), the proposal's normcdf/normcdfinv,
// the HKY vectors and the exchange of the read sums.
//
// Design:
// * One thread-block cluster of G CTAs (1, 2, 4, 8 or 16; the caller
//   picks G so that all B clusters are resident at once) per chain row,
//   grid B * G, 512 threads a CTA. CTA `rank` owns a fixed contiguous range
//   of the row's reads, ceil(R / G) of them (possibly none).
// * Every CTA runs the serial part of a step redundantly on identical
//   inputs (the walk, the proportion proposal, the renormalisation, the
//   HKY vectors), so all hold the same proposal without exchanging it. The
//   walk's and the proposal's products use __dmul_rn / __dadd_rn, so no
//   multiply-add is contracted there and node ids equal the plain
//   version's exactly. Threads 0..K-1 hold a source's node and position,
//   threads Kw..Kw+K-1 (Kw = K rounded up to a warp) its proportion.
// * The next step's proposal is prepared one step ahead, twice: from the
//   state (if this step rejects) and from this step's proposal (if it
//   accepts), walks in warp 15 (their noise staged in shared memory) and
//   proportions in warp 14, while warps 0-12 compute this step's HKY
//   vectors and warp 13 its per-source constants. A step then starts by
//   picking one of the two by the last accept decision, and its own
//   serial part is the HKY vectors alone. The HKY constants that depend
//   only on the base frequencies are computed once a launch.
// * Each warp writes its partial read sum into the CTA's shared memory,
//   in a slot double-buffered by step parity. After ONE cluster barrier a
//   step, the warps that hold state read all G x 16 partials through
//   distributed shared memory in (rank, warp) order, all loads in flight
//   at once, and reduce them in a fixed tree, so every CTA and every such
//   warp makes the same accept decision and the sum is deterministic. The
//   parity slot makes one barrier enough: no CTA reaches step s+2's write
//   before every CTA has passed step s+1's barrier, i.e. finished reading
//   step s's partials. Two block barriers a step remain (pick -> HKY
//   vectors and candidates -> reads). Only rank 0 writes the trace and
//   the final carry; a last cluster barrier keeps every CTA's shared
//   memory alive until the others have read it.
// * Per read and source the count slices are loaded as aligned 32-bit
//   words (7 for uint8, 13 for int16), funnel-shifted into place and
//   unpacked with byte permutes on the integer pipe; a count becomes f64
//   through its bit pattern (2^52 + c minus 2^52, exact) instead of a
//   64-bit conversion instruction. The next source's words are loaded
//   while the current one is summed. The sums over j and over sources
//   keep the plain version's order. The HKY vectors are padded to 26
//   doubles and read as 16-byte pairs.
// * The tree tables (parent, n_children, children, dist) are copied to
//   shared memory when they fit (else read from device memory) and read
//   with plain indexed loads. A lookup of a node outside [0, N) returns
//   zeros, as the JAX package's one-hot select-reduce did, so no index is
//   ever -1; the walk evaluates only the branch it takes.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = kThreads / 2;  // walkers and proposers
constexpr int kHkyWarps = kWarps - 3;  // the others: constants, candidates
constexpr int kMaxCluster = 16;
constexpr int kHStride = 26;         // doubles a HKY vector (25 + pad)
constexpr int kTreeSmemMax = 160 * 1024;  // bytes of tree tables in smem
constexpr size_t kSmemMax = 227 * 1024;   // a CTA's shared memory
constexpr int kQueryHops = 32;  // the longest walk the runners ask for
constexpr double kTwo52 = 4503599627370496.0;

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
  int G;  // CTAs a row (the cluster's size)
  int tree_in_smem;
  int stage_hops;  // hops of walk noise staged in shared memory: 0 or hops
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

// update_position: a move of d >= 0 in direction fwd, one branch a hop;
// hop h's four uniforms at u[4h..4h+3] (device or shared memory)
__device__ void walk(const Tree& T, int& node, double& pos, double d,
                     bool fwd, const float* u, int hops) {
  for (int h = 0; h < hops && d > 0.0; ++h) {
    const float4 uh = *reinterpret_cast<const float4*>(u + 4 * h);
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
        const int child = pick(T, node, uh.x);
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
      node = pick(T, node, uh.z);
      fwd = true;
    } else {  // the parent, or (internal nodes) a sibling
      const int pr = max(par, 0);
      const double nsib =
          is_leaf ? 0.0 : fmax((double)T.nc(pr), 1.0) - 1.0;
      const double n_possible = 1.0 + nsib;
      const double pickv =
          fmin(floor(__dmul_rn((double)uh.y, n_possible)),
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
          const int sc = pick(T, sibling, uh.w);
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

// the per-kernel constants of hky25: kappa's A_R, A_Y, mu, log1p(-con),
// log(con / 3), log(0.999999999) and, for each base b, f, f (1/F - 1),
// (F - f) / F and f / F with F its group's frequency (R or Y)
struct HkyConst {
  double AR, AY, mu, lcm, lcx, cap;
  double f[4], c1[4], c2[4], c3[4];
};

__device__ void hky_const(HkyConst& k, const double* fr, double con) {
  const double R = fr[4], Y = fr[5];
  k.AR = 1.0 + R * (0.0 - 1.0);  // kappa = 0 (1/22 in ints)
  k.AY = 1.0 + Y * (0.0 - 1.0);
  k.mu = fr[6];
  k.lcm = log1p(-con);
  k.lcx = log(con / 3.0);
  k.cap = log(0.999999999);
  for (int b = 0; b < 4; ++b) {
    const double f = fr[b];
    const double grp_f = (b & 1) == 0 ? R : Y;
    k.f[b] = f;
    k.c1[b] = f * (1.0 / grp_f - 1.0);
    k.c2[b] = (grp_f - f) / grp_f;
    k.c3[b] = f / grp_f;
  }
}

// one entry (graph class g, read class rc) of hky25(t)
__device__ double hky_entry(double t, int g, int rc, const HkyConst& k) {
  const double emt = exp(-(k.mu * t));
  const double e_r = exp(-(k.mu * t * k.AR));
  const double e_y = exp(-(k.mu * t * k.AY));
  const int partner = g ^ 2;  // A<->G, C<->T
  double x[4];
  double m = -INFINITY;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const double f = k.f[b];
    const double e_grp = (b & 1) == 0 ? e_r : e_y;
    const double jut1 = f + k.c1[b] * emt;
    double p;
    if (g < 4 && b == g) {
      p = fmax(jut1 + k.c2[b] * e_grp, 1e-8);
    } else if (g < 4 && b == partner) {
      p = fmax(fabs(jut1 - k.c3[b] * e_grp), 1e-8);
    } else {
      p = fmax(f * (1.0 - emt), 1e-8);
    }
    x[b] = log(p) + ((rc < 4 && b == rc) ? k.lcm : k.lcx);
    m = fmax(m, x[b]);
  }
  double s = 0.0;
#pragma unroll
  for (int b = 0; b < 4; ++b) s += exp(x[b] - m);
  const double v = m + log(s);
  return v > 1e-8 ? k.cap : v;
}

// ---- count slices: one read's 25 counts at one path
// An unsigned integer below 2^31 as f64, exactly, through its bit pattern
// (2^52 + u) - 2^52: a DADD in place of a 64-bit conversion instruction.
__device__ __forceinline__ double exact_f64(uint32_t u, double bias) {
  return __hiloint2double(0x43300000, (int)u) - bias;
}

// the 32-bit word at q, or its bytes below `end` (zeros past it)
__device__ __forceinline__ uint32_t word_before(const uint32_t* q,
                                                const uint8_t* end) {
  const uint8_t* p = reinterpret_cast<const uint8_t*>(q);
  if (p + 4 <= end) return __ldg(q);
  uint32_t x = 0;
  for (int k = 0; k < 4; ++k) {
    if (p + k < end) x |= (uint32_t)__ldg(p + k) << (8 * k);
  }
  return x;
}

template <typename CT>
struct Slice;

// uint8: 25 bytes in 7 aligned words; byte j of the slice is byte j & 3
// of word j >> 2 once the words are funnel-shifted into place
template <>
struct Slice<uint8_t> {
  uint32_t w[7];
  uint32_t sh;
  __device__ __forceinline__ void load(const uint8_t* base, size_t i,
                                       const uint8_t* end) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(base + i * 25);
    const uint32_t* q = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
    sh = (uint32_t)(a & 3) * 8;
#pragma unroll
    for (int k = 0; k < 6; ++k) w[k] = __ldg(q + k);
    w[6] = word_before(q + 6, end);
  }
  __device__ __forceinline__ void align() {
#pragma unroll
    for (int k = 0; k < 6; ++k) w[k] = __funnelshift_r(w[k], w[k + 1], sh);
    w[6] >>= sh;
  }
  __device__ __forceinline__ double at(int j) const {
    return exact_f64(__byte_perm(w[j >> 2], 0, 0x4440 | (j & 3)), kTwo52);
  }
};

// int16: 50 bytes in 13 aligned words (the slice is 2-byte aligned);
// the sign bits are flipped so that c + 32768 is read as unsigned
template <>
struct Slice<int16_t> {
  uint32_t w[13];
  uint32_t sh;
  __device__ __forceinline__ void load(const int16_t* base, size_t i,
                                       const uint8_t* end) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(base + i * 25);
    const uint32_t* q = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
    sh = (uint32_t)(a & 3) * 8;
#pragma unroll
    for (int k = 0; k < 12; ++k) w[k] = __ldg(q + k);
    w[12] = word_before(q + 12, end);
  }
  __device__ __forceinline__ void align() {
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      w[k] = __funnelshift_r(w[k], w[k + 1], sh) ^ 0x80008000u;
    }
    w[12] = (w[12] >> sh) ^ 0x80008000u;
  }
  __device__ __forceinline__ double at(int j) const {
    return exact_f64(__byte_perm(w[j >> 1], 0, (j & 1) ? 0x4432 : 0x4410),
                     kTwo52 + 32768.0);
  }
};

// f64: read in place
template <>
struct Slice<double> {
  const double* p;
  __device__ __forceinline__ void load(const double* base, size_t i,
                                       const uint8_t*) {
    p = base + i * 25;
  }
  __device__ __forceinline__ void align() {}
  __device__ __forceinline__ double at(int j) const { return __ldg(p + j); }
};

// one read and source: the child and parent slices and path_map entries
template <typename CT>
struct Src {
  Slice<CT> c, p;
  double pmc, pmp;
  __device__ __forceinline__ void load(const CT* counts, const double* pm,
                                       const uint8_t* end, int cn, int pn,
                                       int r, int R) {
    const size_t ic = (size_t)cn * R + r, ip = (size_t)pn * R + r;
    c.load(counts, ic, end);
    p.load(counts, ip, end);
    pmc = __ldg(pm + ic);
    pmp = __ldg(pm + ip);
  }
  // dc = counts_c . hc, dp = counts_p . hp, each a chain of FMAs in j order
  __device__ __forceinline__ void dots(const double* hc, const double* hp,
                                       double& dc, double& dp) {
    c.align();
    p.align();
    dc = 0.0;
    dp = 0.0;
#pragma unroll
    for (int j2 = 0; j2 < 13; ++j2) {
      const double2 x = reinterpret_cast<const double2*>(hc)[j2];
      const double2 y = reinterpret_cast<const double2*>(hp)[j2];
      dc = fma(c.at(2 * j2), x.x, dc);
      dp = fma(p.at(2 * j2), y.x, dp);
      if (2 * j2 + 1 < 25) {
        dc = fma(c.at(2 * j2 + 1), x.y, dc);
        dp = fma(p.at(2 * j2 + 1), y.y, dp);
      }
    }
  }
};

// shared-memory layout of one CTA (after the tree tables, if there)
struct Smem {
  double *h;  // [2K, kHStride]: source y's child vector at 2y, parent 2y+1
  double *npos, *ntraw, *nt, *lpos, *l1m, *lth;  // [K] this step's
  double *stpos, *sttheta;  // [K] the state before this step
  double *cpos, *ctheta;    // [2, K] next step's proposal if rejected /
  int* cnode;               //   accepted (walk and proportion)
  double* red;  // [2, kWarps] warp partial sums, by step parity
  HkyConst* hk;
  int *nnode, *stnode, *c, *p, *act;  // [K]
  int* nact;
  float* wu;  // [K, stage_hops, 4] the next step's walk uniforms
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

__host__ __device__ inline size_t tree_bytes(int N, int Cc) {
  return align16((size_t)N * 8) + align16((size_t)N * 4) * 2 +
         align16((size_t)N * Cc * 4);
}

// the HKY constants, the step's vectors and per-source values, and the
// next step's walk uniforms for `stage_hops` hops
__host__ __device__ inline size_t state_bytes(int K, int stage_hops) {
  return align16(sizeof(HkyConst)) +
         (size_t)8 * (2 * K * kHStride + 12 * K + 2 * kWarps) +
         align16((size_t)4 * (7 * K + 1)) + (size_t)16 * K * stage_hops;
}

// the proportion proposal: a truncated N(theta, 0.1) step on [0, 1] by
// inverse CDF from the uniform tu (masked slots stay put)
__device__ double propose_theta(double theta, float tu, bool active) {
  const double lo = (0.0 - theta) / 0.1;
  const double hi = (1.0 - theta) / 0.1;
  const double plo = normcdf(lo);
  const double phi = normcdf(hi);
  const double u = fmin(fmax((double)tu, 1e-7), 1.0 - 1e-7);
  double z = normcdfinv(__dadd_rn(plo, __dmul_rn(u, phi - plo)));
  z = fmin(fmax(z, lo), hi);
  return __dadd_rn(theta, __dmul_rn(0.1, active ? z : 0.0));
}

// the walk proposal from (node, pos) by delta x sd with the hops'
// uniforms u (no move at iteration 0), its position clamped into the
// branch
__device__ void propose_walk(const Tree& T, float delta_f, const float* u,
                             int hops, long long it, double sd, int& node,
                             double& pos) {
  if (it != 0) {
    const double delta = __dmul_rn((double)delta_f, sd);
    walk(T, node, pos, fabs(delta), delta >= 0.0, u, hops);
  }
  pos = fmin(fmax(pos, 1e-12), 1.0 - 1e-10);
}

// one read's term: the online logsumexp over the active sources, one at a
// time, the next source's slices loaded while the current one is summed
template <typename CT>
__device__ double read_term(const Smem& s, int nact, const CT* counts,
                            const double* pm, const uint8_t* end, int r,
                            int R) {
  double m = -INFINITY, ssum = 0.0;
  Src<CT> cs, nx;
  if (nact > 0) {
    const int y = s.act[0];
    cs.load(counts, pm, end, s.c[y], s.p[y], r, R);
  }
  for (int i = 0; i < nact; ++i) {
    const int y = s.act[i];
    if (i + 1 < nact) {
      const int w = s.act[i + 1];
      nx.load(counts, pm, end, s.c[w], s.p[w], r, R);
    }
    const double* hc = s.h + 2 * kHStride * y;
    double dc, dpp;
    cs.dots(hc, hc + kHStride, dc, dpp);
    const double x1 = s.lpos[y] + (cs.pmc + dc);
    const double x2 = s.l1m[y] + (cs.pmp + dpp);
    const double mx = fmax(x1, x2);
    const double val = mx + log1p(exp(-fabs(x1 - x2))) + s.lth[y];
    if (val != -INFINITY) {  // theta 0 weighs nothing
      if (val > m) {
        ssum = ssum * exp(m - val) + 1.0;
        m = val;
      } else {
        ssum += exp(val - m);
      }
    }
    cs = nx;
  }
  return m + log(ssum);
}

template <typename CT>
__global__ void __launch_bounds__(kThreads, 1)
    tree_mcmc_segment_kernel(const Args a) {
  extern __shared__ __align__(16) double smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int G = a.G;
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = a.K, S = a.S, R = a.R;
  const int Kw = (K + 31) & ~31;
  const bool walker = tid < K;                      // source y = tid
  const bool proposer = tid >= Kw && tid < Kw + K;  // source y = tid - Kw
  // the warps that hold state (warp 0 always: it writes the trace's ll)
  const bool decider = warp == 0 || warp * 32 < Kw + K;
  const int y = walker ? tid : tid - Kw;
  char* base = reinterpret_cast<char*>(smem_raw);

  Tree T{a.parent, a.nch, a.kids, a.dist, a.N, a.Cc};
  if (a.tree_in_smem) {
    double* sd_ = reinterpret_cast<double*>(base);
    int* sp = reinterpret_cast<int*>(base + align16((size_t)a.N * 8));
    int* sn = reinterpret_cast<int*>(reinterpret_cast<char*>(sp) +
                                     align16((size_t)a.N * 4));
    int* sk = reinterpret_cast<int*>(reinterpret_cast<char*>(sn) +
                                     align16((size_t)a.N * 4));
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
  s.hk = reinterpret_cast<HkyConst*>(base);
  double* dp = reinterpret_cast<double*>(base + align16(sizeof(HkyConst)));
  s.h = dp; dp += 2 * K * kHStride;
  s.npos = dp; dp += K;
  s.ntraw = dp; dp += K;
  s.nt = dp; dp += K;
  s.lpos = dp; dp += K;
  s.l1m = dp; dp += K;
  s.lth = dp; dp += K;
  s.stpos = dp; dp += K;
  s.sttheta = dp; dp += K;
  s.cpos = dp; dp += 2 * K;
  s.ctheta = dp; dp += 2 * K;
  s.red = dp; dp += 2 * kWarps;
  int* ip = reinterpret_cast<int*>(dp);
  s.nnode = ip; ip += K;
  s.stnode = ip; ip += K;
  s.c = ip; ip += K;
  s.p = ip; ip += K;
  s.act = ip; ip += K;
  s.cnode = ip; ip += 2 * K;
  s.nact = ip;
  s.wu = reinterpret_cast<float*>(
      reinterpret_cast<char*>(s.hk) + state_bytes(K, 0));

  // the active source slots in order; the HKY constants and vector pads
  if (tid == 0) {
    int n = 0;
    for (int j = 0; j < K; ++j) {
      if (a.mask[b * K + j]) s.act[n++] = j;
    }
    *s.nact = n;
    hky_const(*s.hk, a.freq, a.con);
  }
  for (int v = tid; v < 2 * K; v += kThreads) s.h[v * kHStride + 25] = 0.0;

  // state in registers: a walker its node and position, a proposer its
  // proportion, every thread of a deciding warp the current likelihood
  // and whether the last step accepted
  int node = 0;
  double pos = 0.0, theta = 0.0;
  const bool active = (walker || proposer) && a.mask[b * K + y];
  if (walker) {
    node = a.nodes[b * K + y];
    pos = a.pos[b * K + y];
  }
  if (proposer) theta = a.theta[b * K + y];
  double cur = a.ll[b];
  bool accepted = false;
  const CT* counts = reinterpret_cast<const CT*>(a.counts);
  const uint8_t* cend = reinterpret_cast<const uint8_t*>(
      counts + (size_t)a.P * R * 25);
  const int chunk = (R + G - 1) / G;
  const int r0 = min(R, rank * chunk), r1 = min(R, r0 + chunk);
  const size_t hop_floats = (size_t)a.hops * 4;
  __syncthreads();

  for (int st = 0; st < S; ++st) {
    const long long it = a.iters[st];
    const size_t row = (size_t)b * S + st;
    const size_t idx = row * K + y;
    const float au = decider ? a.acc_u[row] : 0.f;
    // 1. record the pre-update state; the step's proposal: computed here
    //    at the segment's first step, else the one of the two prepared in
    //    the last step that its accept decision picks
    int nnode = node;
    double npos = pos;
    if (walker) {
      if (rank == 0) {
        a.rec_nodes[idx] = node;
        a.rec_pos[idx] = pos;
      }
      s.stnode[y] = node;
      s.stpos[y] = pos;
      if (st == 0) {
        propose_walk(T, a.deltas[idx], a.walk_u + idx * hop_floats, a.hops,
                     it, a.sd[st], nnode, npos);
      } else {
        nnode = s.cnode[accepted * K + y];
        npos = s.cpos[accepted * K + y];
      }
      s.nnode[y] = nnode;
      s.npos[y] = npos;
    }
    if (proposer) {
      if (rank == 0) a.rec_theta[idx] = theta;
      s.sttheta[y] = theta;
      s.ntraw[y] = st == 0 ? propose_theta(theta, a.trunc_u[idx], active)
                           : s.ctheta[accepted * K + y];
    }
    if (rank == 0 && tid == 0) a.rec_ll[row] = cur;
    __syncthreads();
    // 2. in warps of their own, side by side: the active sources' HKY
    //    vectors, one entry a thread (warps 0-12); the renormalised
    //    proportions and per-source constants (warp 13); the next step's
    //    two candidate proposals, from the state if this step rejects and
    //    from its proposal if it accepts: proportions (warp 14) and walks
    //    (warp 15, its noise first staged in shared memory by the warp)
    const int nact = *s.nact;
    const bool next = st + 1 < S;
    if (warp < kHkyWarps) {
      for (int e = tid; e < nact * 50; e += kHkyWarps * 32) {
        const int v = s.act[e / 50];
        const int side = (e % 50) / 25, ent = e % 25;
        double t = T.d(s.nnode[v]);
        if (t == 0.0) t = 1e-5;
        const double t1 = __dmul_rn(s.npos[v], t);
        s.h[(2 * v + side) * kHStride + ent] =
            hky_entry(side == 0 ? t - t1 : t1, ent / 5, ent % 5, *s.hk);
      }
    } else if (warp == kWarps - 3) {
      for (int v = lane; v < K; v += 32) {
        double sum = 0.0;
        for (int j = 0; j < K; ++j) sum += s.ntraw[j];
        const double nt = s.ntraw[v] / sum;
        s.nt[v] = nt;
        const int c = s.nnode[v];
        const int pr = T.par(c);
        s.c[v] = min(max(c, 0), a.P - 1);
        s.p[v] = min(max(pr < 0 ? c : pr, 0), a.P - 1);
        const double np = s.npos[v];
        s.lpos[v] = log(np);
        s.l1m[v] = log1p(-np);
        s.lth[v] = log(nt);  // read for active slots only
      }
    } else if (warp == kWarps - 2) {
      for (int j = lane; next && j < 2 * K; j += 32) {
        const int v = j % K;
        double th = s.sttheta[v];
        if (j >= K) {  // accepted: this step's renormalised proposal
          double sum = 0.0;
          for (int i = 0; i < K; ++i) sum += s.ntraw[i];
          th = s.ntraw[v] / sum;
        }
        s.ctheta[j] = propose_theta(th, a.trunc_u[(row + 1) * K + v],
                                    a.mask[b * K + v] != 0);
      }
    } else if (next) {
      const size_t idx1 = (row + 1) * K;
      const float4* src =
          reinterpret_cast<const float4*>(a.walk_u + idx1 * hop_floats);
      float4* wu = reinterpret_cast<float4*>(s.wu);
      for (int i = lane; i < K * a.stage_hops; i += 32) {
        wu[i] = src[i];
      }
      __syncwarp();
      const long long it1 = a.iters[st + 1];
      const double sd1 = a.sd[st + 1];
      for (int j = lane; j < 2 * K; j += 32) {
        const int v = j % K;
        int cn = j < K ? s.stnode[v] : s.nnode[v];
        double cp = j < K ? s.stpos[v] : s.npos[v];
        const float* u = a.stage_hops == a.hops
                             ? s.wu + (size_t)v * a.hops * 4
                             : a.walk_u + (idx1 + v) * hop_floats;
        propose_walk(T, a.deltas[idx1 + v], u, a.hops, it1, sd1, cn, cp);
        s.cnode[j] = cn;
        s.cpos[j] = cp;
      }
    }
    __syncthreads();
    // 3. this CTA's reads
    double acc = 0.0;
    for (int r = r0 + tid; r < r1; r += kThreads) {
      acc += read_term<CT>(s, nact, counts, a.pm, cend, r, R);
    }
    // 4. warp sums into this step's parity slot; one cluster barrier
    for (int o = 16; o > 0; o >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    }
    const int par = st & 1;
    if (lane == 0) s.red[par * kWarps + warp] = acc;
    cluster.sync();
    // 5. the deciding warps: all G x kWarps partials in (rank, warp)
    //    order, a lane every 32nd, then a butterfly that leaves the same
    //    total in every lane; the same accept decision everywhere
    if (decider) {
      double part[kMaxCluster * kWarps / 32];  // all loads in flight
#pragma unroll
      for (int k = 0; k < kMaxCluster * kWarps / 32; ++k) {
        const int i = lane + 32 * k;
        part[k] = i < G * kWarps
                      ? cluster.map_shared_rank(s.red, i / kWarps)[
                            par * kWarps + i % kWarps]
                      : 0.0;
      }
      double prop = 0.0;
#pragma unroll
      for (int k = 0; k < kMaxCluster * kWarps / 32; ++k) prop += part[k];
      for (int o = 16; o > 0; o >>= 1) {
        prop += __shfl_xor_sync(0xffffffffu, prop, o);
      }
      const double ratio = exp(prop - cur);
      const double pa = isnan(ratio) ? ratio : fmin(1.0, ratio);
      accepted = it == 0 || (double)au <= pa;
      if (accepted) {
        cur = prop;
        if (walker) {
          node = nnode;
          pos = npos;
        }
        if (proposer) theta = s.nt[y];
      }
    }
  }
  // no CTA leaves while another may still read its partials
  cluster.sync();
  if (rank == 0) {
    if (walker) {
      a.nodes[b * K + y] = node;
      a.pos[b * K + y] = pos;
    }
    if (proposer) a.theta[b * K + y] = theta;
    if (tid == 0) a.ll[b] = cur;
  }
}

// shared memory of a CTA for K sources, an N-node tree with Cc child
// slots and walks of `hops`: the tree tables when they fit kTreeSmemMax,
// the next step's walk noise when the whole fits a CTA
size_t smem_bytes(int K, int N, int Cc, int hops, int* tree_in_smem,
                  int* stage_hops) {
  *tree_in_smem = tree_bytes(N, Cc) <= (size_t)kTreeSmemMax;
  const size_t fixed =
      (*tree_in_smem ? tree_bytes(N, Cc) : 0) + state_bytes(K, 0);
  *stage_hops =
      fixed + state_bytes(K, hops) - state_bytes(K, 0) <= kSmemMax ? hops
                                                                   : 0;
  return fixed + state_bytes(K, *stage_hops) - state_bytes(K, 0);
}

bool valid_cluster(int G) {
  return G == 1 || G == 2 || G == 4 || G == 8 || G == 16;
}

// the kernel's attributes for `smem` bytes and clusters of G, and its
// launch configuration over `blocks` CTAs
template <typename CT>
cudaError_t configure(size_t smem, int G, int blocks, cudaStream_t stream,
                      cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  cudaError_t err = cudaFuncSetAttribute(
      tree_mcmc_segment_kernel<CT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (G > 8) {
    err = cudaFuncSetAttribute(tree_mcmc_segment_kernel<CT>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = G;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename CT>
cudaError_t launch(const Args& a, size_t smem, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err =
      configure<CT>(smem, a.G, a.B * a.G, stream, &attr, &cfg);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, tree_mcmc_segment_kernel<CT>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename CT>
cudaError_t max_clusters(size_t smem, int G, int* out) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = configure<CT>(smem, G, G, 0, &attr, &cfg);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(
      out, (const void*)tree_mcmc_segment_kernel<CT>, &cfg);
}

}  // namespace

// C entry point (ctypes). count_dtype: 0 uint8, 1 int16, 2 float64;
// cluster: G, the CTAs a row (1, 2, 4, 8 or 16). Launches on the given
// stream, does not synchronise, and returns cudaGetLastError() (0 =
// launched), or cudaErrorInvalidValue for an unknown count type or
// cluster size, more than 256 sources, or a source count whose state does
// not fit a CTA. A cluster launch the card refuses returns its error.
extern "C" int tree_mcmc_segment_launch(
    void* nodes, void* pos, void* theta, void* ll, const void* mask,
    const void* iters, const void* sd, const void* deltas,
    const void* walk_u, const void* trunc_u, const void* acc_u,
    const void* path_map_t, const void* counts25_t, int count_dtype,
    const void* parent, const void* dist, const void* children,
    const void* n_children, const void* freq, double con, void* rec_nodes,
    void* rec_pos, void* rec_theta, void* rec_ll, int B, int S, int K,
    int hops, int R, int P, int N, int Cc, int cluster, void* stream) {
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
  a.G = cluster;
  const size_t smem =
      smem_bytes(K, N, Cc, hops, &a.tree_in_smem, &a.stage_hops);
  if (K < 0 || K > kMaxK || hops < 0 || !valid_cluster(cluster) ||
      smem > kSmemMax) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  switch (count_dtype) {
    case 0: return (int)launch<uint8_t>(a, smem, st);
    case 1: return (int)launch<int16_t>(a, smem, st);
    case 2: return (int)launch<double>(a, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// How many clusters of G CTAs of the kernel (for K sources, an N-node tree
// with Cc child slots and this count type) the card holds at once, into
// *out (cudaOccupancyMaxActiveClusters). Returns 0 or the CUDA error.
extern "C" int tree_mcmc_max_active_clusters(int cluster, int K, int N,
                                             int Cc, int count_dtype,
                                             int* out) {
  int in_smem, staged;
  const size_t smem = smem_bytes(K, N, Cc, kQueryHops, &in_smem, &staged);
  if (K < 0 || K > kMaxK || !valid_cluster(cluster) || smem > kSmemMax) {
    return (int)cudaErrorInvalidValue;
  }
  switch (count_dtype) {
    case 0: return (int)max_clusters<uint8_t>(smem, cluster, out);
    case 1: return (int)max_clusters<int16_t>(smem, cluster, out);
    case 2: return (int)max_clusters<double>(smem, cluster, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
