"""Plain reference of a soibean sample, in numpy, for the benchmark's check.

It imports nothing of the program and takes nothing the program made
except the outputs it judges: the mapper's alignments, the read
statistics, the chains' recorded states and the per-chain estimates.
Everything those are judged against is worked out again here from the
world and the reads the harness made:

* an alignment is valid when its edits spell the read, its mappings
  follow the world's edges, and it lies where the read was drawn from;
* the read statistics are soibean's analyse_GAM (`src/getLCAfromGAM.h`
  lines 123-539, with the quirks the program documents) recomputed from
  the alignments;
* a recorded chain state's log-likelihood is the HKY85 mixture of
  `MCMC::computeBaseLogLike` (`src/MCMC.h` lines 111-296) over those
  statistics;
* the start of each k is the signature nodes and the mean-field
  likelihood of `src/soibean.cpp` lines 660-776;
* a chain's estimates are the mean and the n-1 variance of its recorded
  post-burn-in proportions and branch positions, and the summaries of
  `src/MCMC.cpp` lines 23-147: the 5 / 50 / 95 % quantiles, the lag-1
  autocorrelation, the effective sample size of `src/miscfunc.h` lines
  40-66, and that of the patristic-distance series of `src/MCMC.h`
  lines 576-621;
* a recorded step is the Metropolis-Hastings move of
  `MCMC::run_tree_proportion` (`src/MCMC.cpp` lines 522-1088) from the
  state before it: the branch-position walk of `MCMC::updatePosition`
  (lines 169-469) as the program bounds it, the truncated-normal
  proportions, and the accept test, on the chain's noise as
  `noise.py` draws it again from the row's seed.

`dtype` is float64 for the reference and float32 for the control, the
same arithmetic one precision below the configuration's.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import math
from statistics import NormalDist

import numpy as np

from .align import GAP, N, SOFTCLIP, Aln, RefGraph, _reconstruct, qscore

LOG_SUPPORTED_CONST = float(np.log(0.9999999))
LOG_N = float(np.log(0.25))
LOG_GAP = float(np.log(0.02))


# ------------------------------------------------------------ read statistics
def read_stats(g: RefGraph, alns: Sequence[Aln], quals: Sequence[bytes],
               read_lens: Sequence[int], penalty: int, dtype=np.float64):
    """path_map [R, P] and counts25 [R, P, 25] over the mapped reads
    (in read order), and the indices of those reads."""
    qs = qscore().astype(dtype)
    P = g.n_paths
    keep = [i for i, a in enumerate(alns) if a.maps]
    pm = np.zeros((len(keep), P), dtype=dtype)
    c25 = np.zeros((len(keep), P, 25), dtype=dtype)
    for row, i in enumerate(keep):
        aln = alns[i]
        gall, rall, sizes = _reconstruct(g, aln)
        isrev = aln.maps[0][2]
        qual = np.frombuffer(quals[i], dtype=np.uint8)
        base_ix = read_lens[i] - 1 if isrev else 0
        n_map = len(aln.maps)
        M = len(sizes)
        sup = np.zeros((M, P), dtype=dtype)
        stored = np.zeros(M, dtype=dtype)
        unsup = np.zeros(M, dtype=dtype)
        pc = np.zeros((M, 25), dtype=dtype)
        specials = dtype(0.0)
        for m, size in enumerate(sizes):
            if m < n_map:
                sup[m] = g.support[aln.maps[m][0] - g.min_id]
            st = max(base_ix - size - 1, 0) if isrev else base_ix
            gs = gall[st:st + size]
            rs = rall[st:st + size]
            L = len(gs)
            qi = np.zeros(L, dtype=np.int64)
            av = min(L, len(qual))
            qi[:av] = qual[:av]
            q = qs[np.clip(qi, 0, 99)]
            is_n = (gs == N) | (rs == N)
            is_s = ~is_n & ((gs == SOFTCLIP) | (rs == SOFTCLIP))
            is_gap = ~is_n & ~is_s & ((gs == GAP) | (rs == GAP))
            is_base = ~is_n & ~is_s & ~is_gap
            specials = specials + dtype(is_n.sum() * LOG_N) + np.log(
                q[is_s] / dtype(3.0)).sum(dtype=dtype) + dtype(
                is_gap.sum() * LOG_GAP)
            rare = is_base & (gs >= 4)
            plain = is_base & (gs < 4)
            stored[m] = dtype(plain.sum() * LOG_SUPPORTED_CONST) + np.log(
                dtype(4.0) * q[rare] / dtype(3.0)).sum(dtype=dtype)
            nongap = (rs != GAP).astype(np.int64)
            before = np.concatenate([[0], np.cumsum(nongap)[:-1]])
            on_read = (base_ix - before) if isrev else (base_ix + before)
            periodic = (np.abs(on_read) % penalty) == 0
            pen = np.where(periodic, np.log1p(-q), np.log(q / dtype(3.0)))
            unsup[m] = pen[is_base].sum(dtype=dtype)
            if is_base.any():
                cls = np.minimum(gs[is_base], 4) * 5 + np.minimum(rs[is_base], 4)
                np.add.at(pc[m], cls, 1)
            base_ix = st if isrev else base_ix + size
        pm[row] = specials + stored @ sup + unsup @ (dtype(1.0) - sup)
        c25[row] = np.einsum("mp,mc->pc", sup, pc)
    return pm, c25, keep


def stats_gap(pm_prog, c25_prog, pm_ref, c25_ref) -> float:
    """Largest gap of the program's statistics from the reference's: on
    path_map relative to each read's largest magnitude, on the counts
    (small integers) absolute."""
    if pm_prog.shape != pm_ref.shape or c25_prog.shape != c25_ref.shape:
        return float("inf")
    scale = np.maximum(np.abs(pm_ref).max(axis=1, keepdims=True), 1e-300)
    g1 = float((np.abs(pm_prog - pm_ref) / scale).max(initial=0.0))
    g2 = float(np.abs(c25_prog.astype(np.float64) - c25_ref).max(initial=0.0))
    return max(g1, g2)


# ------------------------------------------------------------------ the chain
def make_freqs(a, c, g, t) -> np.ndarray:
    """[A, C, G, T, R, Y, mu] of `src/soibean.cpp`'s base frequencies."""
    mu = 1.0 / (2.0 * (22.0 * a * g + 22.0 * c * t
                       + (a * c + a * t + g * c + g * t)))
    return np.array([a, c, g, t, a + g, c + t, mu], dtype=np.float64)


def hky25(t, con, freq, dtype=np.float64) -> np.ndarray:
    """[..., 25] log-likelihoods of (graph class, read class) pairs for
    branch lengths t: HKY85 with kappa = 0 (the reference's integer
    division), the absolute transition term, 1e-8 floors, a read error
    of `con`, and values above 1e-8 clamped to log(0.999999999)."""
    t = np.asarray(t, dtype=dtype)[..., None]
    fr = freq.astype(dtype)
    f = fr[:4]
    R, Y, mu = fr[4], fr[5], fr[6]
    grp_f = np.array([R, Y, R, Y], dtype=dtype)
    grp_A = np.array([1 - R, 1 - Y, 1 - R, 1 - Y], dtype=dtype)
    emt = np.exp(-(mu * t))
    e_grp = np.exp(-(mu * t * grp_A))
    jut1 = f + f * (dtype(1.0) / grp_f - dtype(1.0)) * emt
    floor = dtype(1e-8)
    p_match = np.maximum(jut1 + ((grp_f - f) / grp_f) * e_grp, floor)
    p_trans = np.maximum(np.abs(jut1 - (f / grp_f) * e_grp), floor)
    p_other = np.maximum(f * (dtype(1.0) - emt), floor)
    partner = (2, 3, 0, 1)
    rows = []
    for gcl in range(4):
        row = p_other.copy()
        row[..., partner[gcl]] = p_trans[..., partner[gcl]]
        row[..., gcl] = p_match[..., gcl]
        rows.append(row)
    logP = np.log(np.stack(rows + [p_other], axis=-2))  # [..., 5, 4]
    lcm = np.log1p(-dtype(con))
    lcx = np.log(dtype(con) / dtype(3.0))
    w = np.full((5, 4), lcx, dtype=dtype)
    for rc in range(4):
        w[rc, rc] = lcm
    x = logP[..., :, None, :] + w  # [..., 5 graph, 5 read, 4]
    mx = x.max(axis=-1, keepdims=True)
    m = (mx + np.log(np.exp(x - mx).sum(axis=-1, keepdims=True)))[..., 0]
    m = np.where(m > dtype(1e-8), np.log(dtype(0.999999999)), m)
    return m.reshape(m.shape[:-2] + (25,)).astype(dtype)


class RefTree:
    """The tree in the program's node numbering (its names give the
    key), with parent, children (in the newick's order), branch length
    and path column a node, from the world's own tree."""

    def __init__(self, tree_world, node_names: Sequence[str],
                 path_names: Sequence[str]):
        _nwk, children, length, _root = tree_world
        parent_of = {c: p for p, kids in children.items() for c in kids}
        idx = {n: i for i, n in enumerate(node_names)}
        col = {n: j for j, n in enumerate(path_names)}
        self.names = list(node_names)
        self.parent = np.array([idx[parent_of[n]] if n in parent_of else -1
                                for n in node_names], dtype=np.int64)
        self.children = [[idx[c] for c in children.get(n, [])]
                         for n in node_names]
        # the lengths as the newick the program reads states them
        self.dist = np.array([float(f"{length[n]:.6f}") if n in length
                              else 0.0 for n in node_names])
        self.col = np.array([col[n] for n in node_names], dtype=np.int64)
        nz = self.dist[(self.dist != 0.0) & (self.dist < 1.0)]
        self.con = float(nz.min()) if len(nz) else 0.01


def log_like(tree: RefTree, pm, c25, freq, nodes, pos, theta, mask,
             dtype=np.float64) -> np.ndarray:
    """[n] log-likelihood of n states (nodes, pos, theta, mask [n, K])."""
    nodes = np.asarray(nodes, dtype=np.int64)
    pos = np.asarray(pos, dtype=dtype)
    theta = np.asarray(theta, dtype=dtype)
    par = tree.parent[nodes]
    par = np.where(par < 0, nodes, par)
    t = tree.dist[nodes].astype(dtype)
    t = np.where(t == 0.0, dtype(1e-5), t)
    t1 = pos * t
    t2 = t - t1
    h_c = hky25(t2, tree.con, freq, dtype)  # [n, K, 25]
    h_p = hky25(t1, tree.con, freq, dtype)

    def side(cols, h):
        """[n, K, R]: path_map + counts25 . h of each source's column."""
        m = cols.reshape(-1)
        sub = np.einsum("rmc,mc->mr", c25[:, m, :].astype(dtype),
                        h.reshape(-1, 25))
        return (pm[:, m].astype(dtype).T + sub).reshape(cols.shape + (-1,))

    llc = side(tree.col[nodes], h_c)
    llp = side(tree.col[par], h_p)
    with np.errstate(divide="ignore"):
        a = np.log(pos)[..., None] + llc
        b = np.log1p(-pos)[..., None] + llp
        per_src = np.logaddexp(a, b)
        tl = np.where(mask, np.log(theta), -np.inf)
    x = per_src + tl[..., None]  # [n, K, R]
    mx = x.max(axis=1, keepdims=True)
    inter = mx[:, 0] + np.log(np.exp(x - mx).sum(axis=1))
    return inter.sum(axis=-1, dtype=dtype)


def signature_paths(pm, path_names: Sequence[str], n_reads: int) -> List[str]:
    """Paths that are the single best (exact ties excluded) of at least
    1 % of the reads, most frequent first; all such paths when none
    reaches 1 %."""
    freq: Dict[str, int] = {}
    mx = pm.max(axis=1, keepdims=True)
    unique = (pm == mx).sum(axis=1) == 1
    for u, j in zip(unique, pm.argmax(axis=1)):
        if u:
            freq[path_names[j]] = freq.get(path_names[j], 0) + 1
    order = sorted(freq.items(), key=lambda kv: -kv[1])
    sig = [n for n, c in order if c >= n_reads * 0.01]
    return sig or [n for n, _c in order]


def initial_log_like(pm, cols: Sequence[int]) -> float:
    if len(cols) == 1:
        return float(pm[:, cols[0]].sum())
    sub = pm[:, cols] + np.log(1.0 / len(cols))
    mx = sub.max(axis=1, keepdims=True)
    return float((mx[:, 0] + np.log(np.exp(sub - mx).sum(axis=1))).sum())


def estimates(theta, pos, loglike, dtype=np.float64):
    """(theta means, theta variances, position means, position
    variances, highest log-likelihood) of one chain's recorded states."""
    th = np.asarray(theta, dtype=dtype)
    ps = np.asarray(pos, dtype=dtype)
    n = th.shape[0]
    mt, mp = th.mean(axis=0, dtype=dtype), ps.mean(axis=0, dtype=dtype)
    vt = ((th - mt) ** 2).sum(axis=0, dtype=dtype) / dtype(n - 1)
    vp = ((ps - mp) ** 2).sum(axis=0, dtype=dtype) / dtype(n - 1)
    return mt, vt, mp, vp, float(np.max(loglike))


def rel_gap(got, want, floor=1e-300) -> float:
    """max |got - want| / max(|want|, floor), elementwise."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    if got.shape != want.shape:
        return float("inf")
    if got.size == 0:
        return 0.0
    d = np.abs(got - want) / np.maximum(np.abs(want), floor)
    d = np.where(np.isnan(d), np.inf, d)
    return float(d.max())


# ------------------------------------------------------------ chain summaries
def quantile(sorted_x, q: float, dtype=np.float64):
    """`getQuantile2`: linear between the two order statistics around
    (n - 1) q."""
    idx = (len(sorted_x) - 1) * q
    lo, hi = math.floor(idx), math.ceil(idx)
    if lo == hi:
        return sorted_x[lo]
    f = dtype(idx - lo)
    return (dtype(1.0) - f) * sorted_x[lo] + f * sorted_x[hi]


def lag1(v, dtype=np.float64):
    """Lag-1 autocorrelation: sum (v_i - m)(v_i+1 - m) over (n - 1) times
    the n-1 variance; nan for a constant series."""
    v = np.asarray(v, dtype=dtype)
    n = len(v)
    d = v - v.mean(dtype=dtype)
    var = (d * d).sum(dtype=dtype) / dtype(n - 1)
    if var == 0:
        return dtype(np.nan)
    return (d[:-1] * d[1:]).sum(dtype=dtype) / (dtype(n - 1) * var)


def ess(v, dtype=np.float64):
    """Effective sample size n / (1 + 2 sum rho) with the initial positive
    sequence of paired lags: rho_0 + rho_1, then pairs (rho_2t, rho_2t+1)
    for t = 1, 2, ... while 2t + 1 < n / 2 - 1, up to and including the
    first pair that is not positive; a last pair below 0 is taken back
    out. The autocovariances come from one FFT. nan for a constant
    series."""
    v = np.asarray(v, dtype=dtype)
    n = len(v)
    d = v - v.mean(dtype=dtype)
    ss = (d * d).sum(dtype=dtype)
    if ss == 0:
        return dtype(np.nan)
    pairs = len(range(1, n // 2 - 2, 2))
    lags = min(2 * pairs + 2, n - 1)
    size = 2
    while size < 2 * n:
        size *= 2
    spec = np.fft.rfft(d, size)
    acov = np.fft.irfft((spec * np.conj(spec)), size)[:lags + 1].astype(dtype)
    rho = acov / ((dtype(n) - np.arange(lags + 1, dtype=dtype))
                  * (ss / dtype(n - 1)))
    total = dtype(1.0) + rho[1]
    last = total
    if total > 0 and pairs:
        p = rho[2:2 * pairs + 2:2] + rho[3:2 * pairs + 3:2]
        stop = np.flatnonzero(p <= 0)
        end = int(stop[0]) + 1 if len(stop) else pairs
        total = total + dtype(2.0) * p[:end].sum(dtype=dtype)
        last = p[end - 1]
    if last < 0:
        total = total - last
    return dtype(n) / (dtype(1.0) + total)


def patristic_series(tree: RefTree, nodes, pos, dtype=np.float64):
    """[n] for recorded states (node, branch position): the Euclidean
    distance of (d(point, leaf) - 1 over the leaves the point reaches
    through its node's side of their common ancestor, 0 for the others),
    the point lying dist[node] (1 - pos) above the node. Summed a node at
    a time from the leaves ordered by that side's length."""
    N = len(tree.names)
    depth = np.zeros(N)
    anc = [None] * N
    for x in range(N):
        chain, y = [], x
        while y >= 0:
            chain.append(y)
            y = tree.parent[y]
        anc[x] = chain  # x, its parent, ..., the root
        for a, b in zip(chain[::-1][:-1], chain[::-1][1:]):
            depth[b] = depth[a] + tree.dist[b]
    leaves = [x for x in range(N) if not tree.children[x]]
    nodes = np.asarray(nodes)
    pos = np.asarray(pos, dtype=dtype)
    out = np.empty(len(nodes), dtype=dtype)
    order = np.argsort(nodes, kind="stable")
    cuts = np.flatnonzero(np.diff(nodes[order])) + 1
    for sel in np.split(order, cuts):
        if not len(sel):
            continue
        x = int(nodes[sel[0]])
        on_x = set(anc[x])
        up, down = [], []
        for lf in leaves:
            lca = next(a for a in anc[lf] if a in on_x)
            up.append(depth[x] - depth[lca])
            down.append(depth[lf] - depth[lca])
        up = np.asarray(up)
        rank = np.argsort(up, kind="stable")
        up_sorted = up[rank]
        a = (up + np.asarray(down) - 1.0)[rank].astype(dtype)
        # sums over the leaves from rank i on
        s0 = np.arange(len(a), -1, -1).astype(dtype)
        s1 = np.concatenate([np.cumsum(a[::-1], dtype=dtype)[::-1],
                             np.zeros(1, dtype)])
        s2 = np.concatenate([np.cumsum((a * a)[::-1], dtype=dtype)[::-1],
                             np.zeros(1, dtype)])
        b = dtype(tree.dist[x]) * (dtype(1.0) - pos[sel])
        i = np.searchsorted(up_sorted, b.astype(np.float64), side="left")
        sq = s2[i] - dtype(2.0) * b * s1[i] + b * b * s0[i]
        out[sel] = np.sqrt(np.maximum(sq, dtype(0.0)))
    return out


def chain_summaries(tree: RefTree, node, pos, theta, dtype=np.float64):
    """Per source of one chain's recorded states: the proportion's
    [mean, 5 %, 50 %, 95 %, ESS, lag-1 autocorrelation, variance] and the
    branch position's [the same, and the ESS of the patristic-distance
    series], in the order the program prints them."""
    out = []
    for s in range(node.shape[1]):
        rows = []
        for v in (theta[:, s], pos[:, s]):
            v = np.asarray(v, dtype=dtype)
            m = v.mean(dtype=dtype)
            var = ((v - m) ** 2).sum(dtype=dtype) / dtype(len(v) - 1)
            srt = np.sort(v)
            rows.append([m, quantile(srt, 0.05, dtype),
                         quantile(srt, 0.5, dtype),
                         quantile(srt, 0.95, dtype), ess(v, dtype),
                         lag1(v, dtype), var])
        rows[1].append(ess(patristic_series(tree, node[:, s], pos[:, s],
                                            dtype), dtype))
        out.append(rows)
    return out


def printed_excess(printed: str, want) -> float:
    """How far a value the program printed with six significant digits
    lies from the reference's beyond the half unit of its sixth digit
    that rounding allows, relative to the reference's value: 0 when the
    printed value is the reference's rounded. Both nan: 0."""
    p, w = float(printed), float(want)
    if math.isnan(p) or math.isnan(w):
        return 0.0 if math.isnan(p) and math.isnan(w) else math.inf
    if p == w:
        return 0.0
    if math.isinf(p) or math.isinf(w):
        return math.inf
    half = 0.5 * 10.0 ** (math.floor(math.log10(abs(p if p != 0 else w))) - 5)
    return max(0.0, abs(p - w) - half) / max(abs(w), 1e-300)


# -------------------------------------------------------------- the MH step
def sd_at(it: int, max_iter: int, burn: int, num_paths: int) -> float:
    """The annealed proposal sd of iteration `it` (`src/MCMC.cpp` lines
    544-596)."""
    init_sd = 3.0 if num_paths <= 30 else num_paths * (3.0 / 30.0)
    if it >= burn and it % 100000 == 0:
        return 1.0
    if it < burn:
        return max(1e-5, init_sd - it * ((init_sd - 0.1) / max(1, burn - 1)))
    return max(1e-5, 0.1 - (it - burn) * ((0.1 - 1e-5)
                                          / max(1, (max_iter - burn) - 1)))


def _pick(kids: List[int], u: float) -> int:
    n = max(len(kids), 1)
    return kids[min(math.floor(u * n), n - 1)] if kids else -1


def walk(tree: RefTree, node: int, pos: float, move: float, forward: bool,
         u) -> Tuple[int, float]:
    """`updatePosition`: a point on the branch above `node` (pos 1 at the
    node, 0 at its parent) moved by `move` toward the leaves (`forward`)
    or the root, over at most len(u) hops, each with its four uniforms
    (child, parent-or-sibling, child at the root, sibling's child). A
    leaf turns the move back; the root sends it down into a child; going
    up, a point that is not on a leaf's branch passes to the parent or to
    one of its siblings, picked alike."""
    d = move
    for h in range(len(u)):
        if not d > 0.0:
            break
        kids = tree.children[node]
        par = int(tree.parent[node])
        if forward:
            if pos + d < 1.0:
                pos, d = pos + d, 0.0
            elif not kids:
                forward = False
            else:
                rem = max(d - (1.0 - pos), 0.0)
                node = _pick(kids, u[h][0])
                pos, d = (1.0, rem - 1.0) if rem > 1.0 else (rem, 0.0)
        elif pos - d > 0.0:
            pos, d = pos - d, 0.0
        elif par < 0:
            node, forward = _pick(kids, u[h][2]), True
        else:
            sibs = [c for c in tree.children[par] if c != node]
            n_opt = 1 + (len(sibs) if kids else 0)
            pick = min(math.floor(u[h][1] * n_opt), n_opt - 1)
            if pick == 0:
                rem = max(d - pos, 0.0)
                node = par
                pos, d = (0.0, rem - 1.0) if rem > 1.0 else (
                    min(max(1.0 - rem, 1e-12), 1.0), 0.0)
            else:
                sib = sibs[pick - 1]
                if d - pos < 1.0:
                    node, pos, d, forward = sib, max(d - pos, 0.0), 0.0, True
                elif not tree.children[sib]:
                    node, pos, forward = sib, 0.0, False
                else:
                    rem = max(d - 1.0, 0.0)
                    node = _pick(tree.children[sib], u[h][3])
                    pos, d = (1.0, rem - 1.0) if rem > 1.0 else (rem, 0.0)
                    forward = True
    return node, pos


_STD = NormalDist()


def proportions(theta, trunc_u, dtype=np.float64):
    """Each proportion moved by a N(0, 0.1) step truncated to [0, 1] (its
    inverse CDF at the uniform, kept inside [1e-7, 1 - 1e-7]), then all
    renormalised."""
    nt = []
    for t, u in zip(theta, trunc_u):
        t = dtype(t)
        lo, hi = (dtype(0.0) - t) / dtype(0.1), (dtype(1.0) - t) / dtype(0.1)
        plo = dtype(0.5 * math.erfc(-float(lo) / math.sqrt(2.0)))
        phi = dtype(0.5 * math.erfc(-float(hi) / math.sqrt(2.0)))
        uu = dtype(min(max(float(u), 1e-7), 1.0 - 1e-7))
        z = dtype(_STD.inv_cdf(float(plo + uu * (phi - plo))))
        nt.append(t + dtype(0.1) * min(max(z, lo), hi))
    nt = np.asarray(nt, dtype=dtype)
    return nt / nt.sum(dtype=dtype)


def step(tree: RefTree, pm, c25, freq, node, pos, theta, ll, noise, sd,
         dtype=np.float64):
    """One Metropolis-Hastings step of one chain row from its state
    (node, pos, theta [k], ll) on that step's noise (delta [k], walk [k,
    hops, 4], trunc [k], acc): returns (the proposal (node, pos, theta,
    ll), accepted)."""
    delta, walk_u, trunc_u, acc_u = noise
    k = len(node)
    nn, npos = [], []
    for s in range(k):
        dd = float(delta[s]) * sd
        x, p = walk(tree, int(node[s]), float(pos[s]), abs(dd), dd >= 0.0,
                    np.asarray(walk_u[s], dtype=np.float64))
        nn.append(x)
        npos.append(min(max(p, 1e-12), 1.0 - 1e-10))
    nn = np.asarray(nn, dtype=np.int64)
    npos = np.asarray(npos, dtype=dtype)
    nt = proportions(theta, trunc_u, dtype)
    prop = log_like(tree, pm, c25, freq, nn[None], npos[None], nt[None],
                    np.ones((1, k), bool), dtype)[0]
    with np.errstate(over="ignore"):
        ok = dtype(acc_u) <= min(dtype(1.0), np.exp(prop - dtype(ll)))
    return (nn, npos, nt, prop), bool(ok)
