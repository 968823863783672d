# Port of vgan_tpu/infer/abundance_mcmc.py to torch (f64 on CPU and GPU; noise is an input).
"""euka's abundance MCMC as a device-resident Metropolis-Hastings chain.

Metropolis-Hastings on the abundance simplex, reimplementing
`MCMC::run` / `generate_proposal` / `get_proposal_likelihood`
(`src/MCMC.cpp:1095-1366`) with its exact effective semantics:

* proposal: componentwise Normal(log x, alpha=0.1) then softmax
  (`src/MCMC.cpp:1139-1153`).
* likelihood: sum over taxa of sum over that taxon's *mapped* reads of
  ``log(frac_t * clade_like[k] + clade_not_like[k] * (1/334))`` — and
  ``(1/334)`` is C++ integer division == 0 (`src/MCMC.cpp:1193`), so it
  collapses to ``n_t * log(frac_t) + sum_k log(clade_like[k])``.
  The first (dummy 0.0) element of each clade_like vector is skipped
  (loop starts at k=1, `src/MCMC.cpp:1192`) — our inputs exclude it.
* QUIRK: during burn-in the loop `continue`s before the accept step
  (`src/MCMC.cpp:1251-1260`), so the state never moves until
  iteration > burnin; the recorded samples are the post-burn-in
  *proposals* (recorded before accept/reject, `src/MCMC.cpp:1253-1254`).
* posterior summary: per-taxon median + 85%/95% linear-interpolated
  quantiles over the recorded proposals (`src/MCMC.cpp:1311-1361`,
  `quant` from `src/miscfunc.h:239-251`).

The noise is an input of the chain: `draw_noise` draws one normal row
z[T] and one uniform u per iteration, in f64, from an explicit CPU
generator seeded with `seed`, and the caller moves them to the chain's
device once. The same seed therefore samples the same chain on the
card and on the CPU. The reference seeds from std::random_device and
its tests assert only statistical windows, so stream-level parity with
the JAX package's threefry keys is not required; a parity test feeds
the JAX noise in through the same input.

Everything is f64 (the JAX package's f32-on-TPU rule was a TPU
compiler workaround and is not carried over).
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import resolve_device

F64 = torch.float64
# chain start: state `init` with a likelihood no proposal can lose to
# (the burn-in quirk above, emulated)
START_LL = -9999999.0


class AbundanceResult(NamedTuple):
    estimate: np.ndarray  # [T] posterior median
    ci85: np.ndarray  # [T, 2]
    ci95: np.ndarray  # [T, 2]
    samples: np.ndarray  # [n_recorded, T]


def draw_noise(n: int, T: int, seed: int):
    """Per-iteration noise of an n-iteration chain over T taxa: normals
    z [n, T] and uniforms u [n], f64, on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    z = torch.randn(n, T, generator=gen, dtype=F64)
    u = torch.rand(n, generator=gen, dtype=F64)
    return z, u


def run_segment(current, cur_ll, z, u, alpha, n_reads, const_ll):
    """S Metropolis-Hastings steps on the device of `current`, one per
    row of z [S, T] / u [S]. Returns ((state, ll), proposals [S, T]).

    Every step records its PROPOSAL (reference quirk). A NaN acceptance
    ratio rejects, since u <= NaN is false. No value leaves the device
    inside the loop."""
    out = torch.empty_like(z)
    one = torch.ones((), dtype=z.dtype, device=z.device)
    for s in range(z.shape[0]):
        prop = torch.softmax(torch.log(current) + alpha * z[s], dim=-1)
        # sum_t n_t * log(frac_t) + const   (const = sum log clade_like)
        prop_ll = torch.sum(n_reads * torch.log(prop)) + const_ll
        accept = u[s] <= torch.minimum(one, torch.exp(prop_ll - cur_ll))
        current = torch.where(accept, prop, current)
        cur_ll = torch.where(accept, prop_ll, cur_ll)
        out[s] = prop
    return (current, cur_ll), out


def _summarize(samples: np.ndarray) -> AbundanceResult:
    # simplex-sum assertion, `src/MCMC.cpp:1164-1169`
    from ..utils.guards import check_simplex

    check_simplex(
        samples, "abundance proposal",
        atol=1e-6 if samples.dtype == np.float64 else 1e-4,
    )
    T = samples.shape[1]
    est = np.empty(T)
    ci85 = np.empty((T, 2))
    ci95 = np.empty((T, 2))
    for t in range(T):
        s = np.sort(samples[:, t])
        est[t] = s[len(s) // 2]
        ci85[t] = [_quant(s, 0.15), _quant(s, 0.85)]
        ci95[t] = [_quant(s, 0.05), _quant(s, 0.95)]
    return AbundanceResult(est, ci85, ci95, samples)


def _chain_inputs(n_reads_per_taxon, sum_log_like_per_taxon, n_iter, seed,
                  device):
    dev = resolve_device(device)
    T = len(n_reads_per_taxon)
    z, u = draw_noise(n_iter, T, seed)
    n_reads_f = torch.as_tensor(np.asarray(n_reads_per_taxon), dtype=F64,
                                device=dev)
    const_ll = torch.as_tensor(np.sum(sum_log_like_per_taxon), dtype=F64,
                               device=dev)
    return dev, z.to(dev), u.to(dev), n_reads_f, const_ll


def run_mcmc(
    n_reads_per_taxon: np.ndarray,
    sum_log_like_per_taxon: np.ndarray,
    init_vec: np.ndarray,
    n_iter: int = 10000,
    burnin: int = 100,
    alpha: float = 0.1,
    seed: int = 0,
    *,
    device,
) -> AbundanceResult:
    """n_reads_per_taxon: number of mapped reads per detected taxon
    (size of clade_like minus the dummy element); sum_log_like_per_taxon:
    sum of log(clade_like[k]) (-inf if any like is 0, reproducing the
    reference's log(0) behavior — proposals are then never accepted but
    still recorded). The whole chain as one segment, with no snapshot."""
    return run_mcmc_checkpointed(
        n_reads_per_taxon, sum_log_like_per_taxon, init_vec, n_iter=n_iter,
        burnin=burnin, alpha=alpha, seed=seed, checkpoint_path=None,
        checkpoint_every=max(n_iter, 1), device=device,
    )


def run_mcmc_checkpointed(
    n_reads_per_taxon: np.ndarray,
    sum_log_like_per_taxon: np.ndarray,
    init_vec: np.ndarray,
    n_iter: int = 10000,
    burnin: int = 100,
    alpha: float = 0.1,
    seed: int = 0,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 100000,
    *,
    device,
) -> AbundanceResult:
    """Segmented abundance sampler with exact resume (the reference
    restarts from zero): chain state + recorded proposals snapshot to
    `checkpoint_path` every `checkpoint_every` iterations; rerunning
    with the same path continues from the last snapshot and produces
    the identical trace (the noise rows are indexed by iteration, so
    segment slicing does not change the stream)."""
    # np.savez appends .npz to suffix-less paths; normalize so the
    # resume check looks at the file that was actually written
    if checkpoint_path and not checkpoint_path.endswith(".npz"):
        checkpoint_path += ".npz"

    dev, z, u, n_reads_f, const_ll = _chain_inputs(
        n_reads_per_taxon, sum_log_like_per_taxon, n_iter, seed, device)
    total = max(n_iter - (burnin + 1), 0)

    def on_dev(x):
        return torch.as_tensor(np.asarray(x), dtype=F64, device=dev)

    start = 0
    segments: list = []
    # burn-in: proposals generated but never accepted (reference quirk);
    # the state stays at init, so the chain starts at init with a
    # -inf-ish likelihood from iteration burnin+1 onward
    carry = (on_dev(init_vec), on_dev(START_LL))
    if checkpoint_path and os.path.exists(checkpoint_path):
        snap = np.load(checkpoint_path, allow_pickle=False)
        start = int(snap["next_iter"])
        carry = (on_dev(snap["current"]), on_dev(snap["ll"]))
        segments = [snap["samples"]]
    while start < total:
        end = min(start + checkpoint_every, total)
        lo, hi = burnin + 1 + start, burnin + 1 + end
        carry, samples = run_segment(
            *carry, z[lo:hi], u[lo:hi], alpha, n_reads_f, const_ll,
        )
        segments.append(samples.cpu().numpy())
        start = end
        if checkpoint_path:
            acc = np.concatenate(segments)
            np.savez(
                checkpoint_path, next_iter=start,
                current=carry[0].cpu().numpy(), ll=carry[1].cpu().numpy(),
                samples=acc,
            )
            segments = [acc]
    return _summarize(
        np.concatenate(segments) if segments
        else np.zeros((0, len(init_vec)))
    )


def _quant(sorted_x: np.ndarray, q: float) -> float:
    """`quant` from `src/miscfunc.h:239-251` (linear interpolation)."""
    n = len(sorted_x)
    idx = (n - 1) * q
    lo = int(np.floor(idx))
    hi = int(np.ceil(idx))
    h = idx - lo
    return float((1.0 - h) * sorted_x[lo] + h * sorted_x[hi])
