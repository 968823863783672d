// soibean's Euclidean patristic-distance series of one chain source: a
// value a recorded state, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes this series on the
// host with numpy (vgan_tpu/infer/diagnostics.py::patristic_distance_series,
// held in the port as vgan_tpu_torch/infer/diagnostics.py). It carries
// soibean's chain summaries: 24 series a sample of the k-sweep at k = 1..3
// and 4 chains, each [425,000 states x 128 leaves] at the published
// settings, which numpy takes seconds for and the card milliseconds. The
// plain version is vgan_tpu_torch/infer/patristic.py::patristic_series_plain.
//
// What it computes, for state s at node x = nodes[s] and branch position
// p = pos[s], over the leaves j < n (dn, dl: the distances from x and from
// leaf j up to their lowest common ancestor; every value f64):
//   pob    = dist[x] * (1 - p)
//   ns_j   = dn[x, j] - pob
//   diff_j = ns_j >= 0 ? (ns_j + dl[x, j]) - 1 : 0
//   out[s] = sqrt(sum_j diff_j * diff_j)
// bit for bit numpy's result: each operation rounded on its own
// (__dadd_rn, __dsub_rn, __dmul_rn, __dsqrt_rn: nvcc contracts none of
// them into a multiply-add), and the sum over the leaves in the order of
// numpy's pairwise_sum, which `(diff * diff).sum(axis=1)` takes for each
// row: up to 128 terms, eight strided accumulators r[k] = sum_i x[8 i + k]
// combined as ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7)), then the
// remainder of n mod 8 in turn (a plain running sum from 0 below 8 terms);
// above 128 terms the row is halved at n2 = n / 2 - (n / 2) % 8 and the
// halves summed the same way, recursively.
//
// Bound. A state reads its node (4 B) and position (8 B) and writes its
// value (8 B): 20 B, 8.5 MB a 425,000-state series, 2.5 us over
// 3.35 TB/s. The tables (2 x nodes x leaves x 8 B, 261 KB each at 255 x
// 128) stay in L2 and L1. Operations: 6 f64 instructions a leaf term (the
// subtraction, the compare, two additions, the square, the accumulation)
// and 2 a state: 54.4 M terms a series, ~20 us over 132 SMs x 64 FP64
// lanes at 1.98 GHz. So the f64 pipe bounds it; the kernel's whole time
// is far below the host's copies around it.
//
// Design: a thread a state, the eight accumulators in registers, the
// leaves walked in order. A chain stays on one node for long runs, so the
// threads of a warp mostly load the same table row: each load is a
// broadcast of one L1 line. Nothing is staged in shared memory and
// nothing crosses threads, so the sum order is exactly the one above.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockLeaves = 128;  // numpy's PW_BLOCKSIZE

// one state's table rows and its point's distance above its node
struct Row {
  const double* dn;
  const double* dl;
  double pob;
};

// diff_j * diff_j of leaf j, each operation rounded as numpy rounds it
__device__ __forceinline__ double term(const Row& r, int j) {
  const double ns = __dsub_rn(__ldg(r.dn + j), r.pob);
  if (!(ns >= 0.0)) return 0.0;  // diff 0 (a NaN side too), 0 * 0
  const double d = __dsub_rn(__dadd_rn(ns, __ldg(r.dl + j)), 1.0);
  return __dmul_rn(d, d);
}

// numpy's pairwise_sum of leaves [j0, j0 + n), n <= 128
__device__ __forceinline__ double block_sum(const Row& r, int j0, int n) {
  if (n < 8) {
    double res = 0.0;
    for (int i = 0; i < n; ++i) res = __dadd_rn(res, term(r, j0 + i));
    return res;
  }
  double a[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = term(r, j0 + k);
  const int whole = n - n % 8;
  int i = 8;
  for (; i < whole; i += 8) {
#pragma unroll
    for (int k = 0; k < 8; ++k) a[k] = __dadd_rn(a[k], term(r, j0 + i + k));
  }
  double res = __dadd_rn(
      __dadd_rn(__dadd_rn(a[0], a[1]), __dadd_rn(a[2], a[3])),
      __dadd_rn(__dadd_rn(a[4], a[5]), __dadd_rn(a[6], a[7])));
  for (; i < n; ++i) res = __dadd_rn(res, term(r, j0 + i));
  return res;
}

// numpy's pairwise_sum of leaves [j0, j0 + n) for any n: halves cut at a
// multiple of 8 until a part holds at most 128 (depth ~log2(n / 128))
__device__ double pairwise_sum(const Row& r, int j0, int n) {
  if (n <= kBlockLeaves) return block_sum(r, j0, n);
  int n2 = n / 2;
  n2 -= n2 % 8;
  const double left = pairwise_sum(r, j0, n2);
  return __dadd_rn(left, pairwise_sum(r, j0 + n2, n - n2));
}

__global__ void __launch_bounds__(kThreads)
patristic_series_kernel(const double* __restrict__ dn,
                        const double* __restrict__ dl,
                        const double* __restrict__ dist,
                        const int* __restrict__ nodes,
                        const double* __restrict__ pos, int n_leaves,
                        long long S, double* __restrict__ out) {
  const long long s = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (s >= S) return;
  const int x = nodes[s];
  const long long row = (long long)x * n_leaves;
  const Row r{dn + row, dl + row,
              __dmul_rn(dist[x], __dsub_rn(1.0, pos[s]))};
  const double sum = n_leaves <= kBlockLeaves
                         ? block_sum(r, 0, n_leaves)
                         : pairwise_sum(r, 0, n_leaves);
  out[s] = __dsqrt_rn(sum);
}

}  // namespace

extern "C" {

// The series of S states on `stream`: dn, dl [nodes, n_leaves] and dist
// [nodes] (f64), nodes [S] (int32, each < nodes), pos [S] (f64), out [S]
// (f64), all device memory and contiguous. Allocates nothing, does not
// synchronise. Returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a negative n_leaves or a grid too large.
int patristic_series_launch(const double* dn, const double* dl,
                            const double* dist, const int* nodes,
                            const double* pos, int n_leaves, long long S,
                            double* out, void* stream) {
  if (S <= 0) return 0;
  const long long blocks = (S + kThreads - 1) / kThreads;
  if (n_leaves < 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  patristic_series_kernel<<<(unsigned)blocks, kThreads, 0,
                            (cudaStream_t)stream>>>(dn, dl, dist, nodes, pos,
                                                    n_leaves, S, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
