# Copied unchanged from vgan_tpu/infer/diagnostics.py.
"""Chain statistics: ESS, autocorrelation, quantiles, Gelman-Rubin.

Mirrors `src/miscfunc.h:12-66` (mean/variance/autocorrelation/ESS with
the reference's paired-lag loop), `getQuantile2` (`src/MCMC.h:447-465`)
and `soibean::calculateRhat` (`src/soibean.cpp:175-202`).
"""
from __future__ import annotations

import numpy as np


def mean(v: np.ndarray) -> float:
    return float(np.mean(v))


def variance(v: np.ndarray, m: float) -> float:
    # sample variance with n-1 (`src/miscfunc.h:17-24`)
    d = np.asarray(v, dtype=np.float64) - m
    return float((d * d).sum() / (len(v) - 1))


def autocorrelation(v: np.ndarray, k: int) -> float:
    v = np.asarray(v, dtype=np.float64)
    m = v.mean()
    denom = variance(v, m)
    numer = float(((v[: len(v) - k] - m) * (v[k:] - m)).sum())
    if denom == 0.0:
        # constant chain: C++ produces 0/0 = nan and carries on
        return float("nan")
    return numer / ((len(v) - k) * denom)


def effective_sample_size(v: np.ndarray) -> float:
    """Paired-lag initial-positive-sequence ESS (`src/miscfunc.h:40-66`).

    The reference's loop evaluates one O(n) autocorrelation per lag and
    can visit thousands of lags on a slowly-mixing chain (the annealed
    sampler's late chain barely moves) — O(n^2) host time at 425k
    recorded samples. All lags compute here in ONE FFT autocovariance
    pass; the pairing/termination semantics are replayed exactly on the
    precomputed sequence (r5; per-value fp differences vs the direct
    sums are ~1e-12 relative and the estimate is statistical)."""
    v = np.asarray(v, dtype=np.float64)
    n = len(v)
    if np.var(v) == 0.0:
        return float("nan")  # constant chain (C++ nan propagation)
    max_lag = n // 2
    # t walks 1, 3, 5, ... while t < max_lag - 2; lags used reach t+2
    t_count = len(range(1, max_lag - 2, 2))
    nlags = min(2 * t_count + 2, n - 1)
    m = v.mean()
    d = v - m
    ss = float((d * d).sum())
    # autocovariance c[k] = sum (v[i]-m)(v[i+k]-m) via FFT
    nfft = 1 << int(np.ceil(np.log2(max(2 * n, 2))))
    f = np.fft.rfft(d, nfft)
    c = np.fft.irfft(f * np.conj(f), nfft)[: nlags + 1]
    denom = ss / (n - 1)  # variance(v, m)
    with np.errstate(invalid="ignore"):
        rho = c / ((n - np.arange(nlags + 1)) * denom)
    rho_1 = rho[1] if nlags >= 1 else autocorrelation(v, 1)
    # pair sums for iteration j = 1..t_count: (rho[2j], rho[2j+1])
    P = rho[2 : 2 * t_count + 2 : 2] + rho[3 : 2 * t_count + 3 : 2]
    rho_even, rho_odd = 1.0, rho_1
    rho_tot = rho_even + rho_odd
    if rho_tot > 0 and len(P):
        neg = np.nonzero(P <= 0)[0]
        # iteration j executes when the PREVIOUS pair was > 0, so the
        # first non-positive pair itself still executes
        E = int(neg[0]) + 1 if len(neg) else len(P)
        rho_tot += 2.0 * float(P[:E].sum())
        last = float(P[E - 1])
    else:
        last = rho_tot
    if last < 0:
        rho_tot -= last
    return n / (1.0 + rho_tot)


def quantile(sorted_x: np.ndarray, q: float) -> float:
    n = len(sorted_x)
    idx = (n - 1) * q
    lo = int(np.floor(idx))
    hi = int(np.ceil(idx))
    if lo == hi:
        return float(sorted_x[lo])
    frac = idx - lo
    return float((1.0 - frac) * sorted_x[lo] + frac * sorted_x[hi])


def rhat(means: np.ndarray, variances: np.ndarray, chain_length: int) -> float:
    """Gelman-Rubin across chains; -1 for a single chain."""
    m = len(means)
    if m < 2:
        return -1.0
    W = float(np.mean(variances))
    grand = float(np.mean(means))
    B = float(((np.asarray(means) - grand) ** 2).sum()) * chain_length / (m - 1)
    var_est = ((chain_length - 1.0) * W + B) / chain_length
    if W == 0.0:
        return float("nan")  # identical-in-every-iteration parameter
    return float(np.sqrt(var_est / W))


def patristic_distance_series(tree, nodes: np.ndarray, pos: np.ndarray):
    """Euclidean patristic-distance series for a chain's recorded
    (node, branch position) states, vs an all-ones initial vector
    (`src/MCMC.h:576-621`, used at `src/MCMC.cpp:23-147` for the
    branch-level ESS). posonbranch = dist[node] - pos*dist[node]."""
    tree_n = len(tree.names)
    leaves = np.nonzero(tree.n_children == 0)[0]
    n_leaves = len(leaves)

    # depth (distance to root) per node
    depth = np.zeros(tree_n)
    order = []
    stack = [tree.root]
    while stack:
        x = stack.pop()
        order.append(x)
        for c in tree.children[x]:
            if c >= 0:
                depth[c] = depth[x] + tree.dist[c]
                stack.append(int(c))

    # ancestor matrix for LCA via sets (trees are small)
    anc = [set() for _ in range(tree_n)]
    for x in order:
        p = tree.parent[x]
        anc[x] = {x} | (anc[p] if p >= 0 else set())

    # per (node, leaf): node-side and leaf-side distances to the LCA
    dn = np.zeros((tree_n, n_leaves))
    dl = np.zeros((tree_n, n_leaves))
    for x in range(tree_n):
        for j, lf in enumerate(leaves):
            common = anc[x] & anc[lf]
            lca = max(common, key=lambda a: depth[a])
            dn[x, j] = depth[x] - depth[lca]
            dl[x, j] = depth[lf] - depth[lca]

    pob = tree.dist[nodes] * (1.0 - pos)  # posonbranch per sample
    node_side = dn[nodes] - pob[:, None]  # [S, n_leaves]
    total = node_side + dl[nodes]
    valid = node_side >= 0.0
    diff = np.where(valid, total - 1.0, 0.0)
    return np.sqrt((diff * diff).sum(axis=1))
