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
// multiply, a max reduction, exp, a sum reduction, a division, log, a
// third reduction, exp) and its latency sets the time.
//
// Design: one warp runs the chain, the latency-optimal shape for a serial
// chain (no shared memory, no block barrier). Lane l holds taxa
// l, l + 32, ... (kPerLane of them, up to 32: T <= 1,024) in registers,
// so z rows load coalesced. The max, the sum and the log-likelihood are
// reduced across lanes with __shfl_xor_sync butterflies; IEEE addition is
// commutative, so every lane ends with the same bits and takes the same
// accept decision. log(current) is never recomputed: on accept it is the
// proposal's own log(prop), the same function of the same value the
// plain version takes the next step; the state itself is not held, but
// read back at the end from the last accepted step's proposal row. The
// next step's z row and u are loaded while the current step computes.
// Products and sums use __dmul_rn / __dadd_rn, so no multiply-add is
// contracted where torch rounds twice.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// max that propagates a NaN, as torch's max reduction does
__device__ __forceinline__ double nan_max(double a, double b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __dadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

template <int kPerLane>
__global__ void __launch_bounds__(32) abundance_mcmc_segment_kernel(
    double* __restrict__ current, double* __restrict__ cur_ll_io,
    const double* __restrict__ z, const double* __restrict__ u,
    const double* __restrict__ n_reads, const double* __restrict__ const_ll,
    double alpha, int T, long long S, double* __restrict__ out) {
  const int lane = threadIdx.x;
  double logc[kPerLane], nr[kPerLane], zn[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int t = lane + 32 * k;
    const bool live = t < T;
    logc[k] = live ? log(current[t]) : 0.0;
    nr[k] = live ? n_reads[t] : 0.0;
    zn[k] = live ? z[t] : 0.0;
  }
  double cll = *cur_ll_io;
  const double cst = *const_ll;
  double un = u[0];
  long long last = -1;  // the last step that accepted
  for (long long s = 0; s < S; ++s) {
    double v[kPerLane];  // x, then exp(x - max), then the proposal
    double mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      v[k] = __dadd_rn(logc[k], __dmul_rn(alpha, zn[k]));
      if (lane + 32 * k < T) mx = nan_max(mx, v[k]);
    }
    const double uc = un;
    if (s + 1 < S) {  // the next step's noise, in flight during this one
      const double* zr = z + (s + 1) * T;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int t = lane + 32 * k;
        if (t < T) zn[k] = zr[t];
      }
      un = u[s + 1];
    }
    mx = warp_max(mx);
    double sum = 0.0;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      v[k] = exp(__dsub_rn(v[k], mx));
      if (lane + 32 * k < T) sum = __dadd_rn(sum, v[k]);
    }
    sum = warp_sum(sum);
    double lp[kPerLane];
    double ll = 0.0;
    double* o = out + s * T;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int t = lane + 32 * k;
      v[k] = __ddiv_rn(v[k], sum);
      lp[k] = log(v[k]);
      if (t < T) {
        ll = __dadd_rn(ll, __dmul_rn(nr[k], lp[k]));
        o[t] = v[k];
      }
    }
    ll = __dadd_rn(warp_sum(ll), cst);
    const double d = __dsub_rn(ll, cll);
    bool accept = false;
    if (d == d) {  // NaN rejects (fmin(1, NaN) would be 1 and accept)
      const double ratio = exp(d);
      accept = uc <= (ratio < 1.0 ? ratio : 1.0);
    }
    if (accept) {
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) logc[k] = lp[k];
      cll = ll;
      last = s;
    }
  }
  // the state is the last accepted proposal, which this lane wrote itself
  if (last >= 0) {
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int t = lane + 32 * k;
      if (t < T) current[t] = out[last * T + t];
    }
  }
  if (lane == 0) *cur_ll_io = cll;
}

template <int kPerLane>
void launch(double* current, double* cur_ll, const double* z, const double* u,
            const double* n_reads, const double* const_ll, double alpha,
            int T, long long S, double* out, cudaStream_t stream) {
  abundance_mcmc_segment_kernel<kPerLane><<<1, 32, 0, stream>>>(
      current, cur_ll, z, u, n_reads, const_ll, alpha, T, S, out);
}

}  // namespace

extern "C" {

// S steps of the chain over T taxa on `stream`: current [T] and cur_ll [1]
// (device f64, updated in place), z [S, T] and u [S] (the noise),
// n_reads [T], const_ll [1], out [S, T] (the proposals), all device f64
// and contiguous. Returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for T outside 1..1,024.
int abundance_mcmc_segment_launch(double* current, double* cur_ll,
                                  const double* z, const double* u,
                                  const double* n_reads,
                                  const double* const_ll, double alpha,
                                  int T, long long S, double* out,
                                  void* stream) {
  if (S <= 0) return 0;
  if (T < 1 || T > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int per_lane = (T + 31) / 32;
  if (per_lane <= 1)
    launch<1>(current, cur_ll, z, u, n_reads, const_ll, alpha, T, S, out, st);
  else if (per_lane <= 2)
    launch<2>(current, cur_ll, z, u, n_reads, const_ll, alpha, T, S, out, st);
  else if (per_lane <= 4)
    launch<4>(current, cur_ll, z, u, n_reads, const_ll, alpha, T, S, out, st);
  else if (per_lane <= 8)
    launch<8>(current, cur_ll, z, u, n_reads, const_ll, alpha, T, S, out, st);
  else if (per_lane <= 16)
    launch<16>(current, cur_ll, z, u, n_reads, const_ll, alpha, T, S, out, st);
  else
    launch<32>(current, cur_ll, z, u, n_reads, const_ll, alpha, T, S, out, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
