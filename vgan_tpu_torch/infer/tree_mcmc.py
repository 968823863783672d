# Port of vgan_tpu/infer/tree_mcmc.py to torch (f64; the MH chain in one CUDA kernel a segment; PROFILER's spans).
"""soibean's tree MCMC: S Metropolis-Hastings steps of B chain rows.

Reimplements `MCMC::run_tree_proportion` (`src/MCMC.cpp:522-1088`),
`MCMC::updatePosition` (`src/MCMC.cpp:169-469`) and
`MCMC::computeBaseLogLike` (`src/MCMC.h:111-296`) with the semantics of
the JAX package's sampler (vgan_tpu/infer/tree_mcmc.py):

* state per source: tree node, branch position in (0,1), proportion.
* proposals: branch-position random walk N(0, sd) over the tree (cross
  into children / parent / siblings, leaf and root bounces), annealed sd
  schedule (`sd_schedule`); proportions by a truncated N(theta, 0.1) on
  [0,1], renormalised.
* likelihood: per source y with child path c and parent path p,
  t = dist[c] (1e-5 at the root), t1 = pos*t, t2 = t - t1:
    LL_c[r] = path_map[r,c] + counts25[r,c] . hky25(t2)
    LL_p[r] = path_map[r,p] + counts25[r,p] . hky25(t1)
    read LL = logsumexp_y(log theta_y
                + logaddexp(log pos_y + LL_c, log(1-pos_y) + LL_p))
* HKY85 closed form with the reference's quirks (kappa = 0, the
  absolute transition difference, 1e-8 floors, log(0.999999999) clamp).
* recording: every step records its PRE-update state; iteration 0 is a
  forced accept; the loop runs max_iter + 1 times; runners keep
  iterations > burn.

Where it runs. `run_segment` runs S steps of B rows. For CUDA tensors it
launches `tree_mcmc_segment_kernel` (csrc/tree_mcmc.cu: one thread-block
cluster of G CTAs a row, each CTA a share of the reads, the whole serial
chain inside the kernel; G from `cluster_size`) or raises; for CPU
tensors it runs `run_segment_plain`, the straightforward translation (a
Python loop over steps and hops, vectorised over rows and sources), which
the tests hold against the JAX package. Each kernel launch adds one to
`LAUNCHES["tree_mcmc_segment"]`.

Noise. All randomness is an input of the segment, f32 as the JAX package
draws it and cast to f64 on use. `draw_noise` makes it on the chain's
device from explicit generators: iterations are cut into blocks of
NOISE_BLOCK, and a row's block is drawn by a generator seeded from (the
row's seed, the block, the walk's hop count). So a row's stream does not
depend on the other rows of its batch (a k == Kmax row of the k-sweep
equals the standalone chains runner) nor on how the run is cut into
segments, and a checkpoint needs only the row's seed to resume the same
stream. The initial proportions are a Dirichlet(1) draw, normalised
-log(1 - U) from a generator of their own (`init_theta`). CPU and card
chains with the same seed differ, because their generators differ;
parity with the JAX package is held by feeding it the JAX noise through
`draw_noise` / `init_theta`.

Everything is f64 (the JAX package's f32-on-TPU rule was a TPU compiler
workaround and is not carried over). The path-major layout of path_map
and counts25 is made once a run and stays on the device (`prepare`);
counts25, small exact integers, is held as uint8 or int16 on the card
when it fits.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.profiling import PROFILER

F64 = torch.float64
FREQ_KEYS = ("A", "C", "G", "T", "R", "Y", "M")
WALK_HOPS = 32  # bound of the walk (the C++ loop is unbounded)
POST_BURN_HOPS = 8  # post-burn-in proposal sd <= 1 -> short walks
NOISE_BLOCK = 1024  # iterations one noise generator draws
SEGMENT_BYTES = 64 << 20  # noise + trace bytes of one segment, all rows
CHECKPOINT_FORMAT = "vgan_tpu_torch.tree_mcmc/1"
_THETA_STREAM = -1  # init_theta's block id (blocks are >= 0)

LAUNCHES: Dict[str, int] = {"tree_mcmc_segment": 0}
"""Kernel launches since the last reset_launches()."""


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class MCMCTrace(NamedTuple):
    node: np.ndarray  # [iters, k]
    pos: np.ndarray  # [iters, k]
    theta: np.ndarray  # [iters, k]
    loglike: np.ndarray  # [iters]


class TreeTensors(NamedTuple):
    parent: torch.Tensor  # [N] int32, -1 at root
    dist: torch.Tensor  # [N] f64
    children: torch.Tensor  # [N, Cc] int32, -1 padded
    n_children: torch.Tensor  # [N] int32


class Noise(NamedTuple):
    deltas: torch.Tensor  # [B, S, K] f32 standard normals
    walk_u: torch.Tensor  # [B, S, K, hops, 4] f32 uniforms
    trunc_u: torch.Tensor  # [B, S, K] f32 uniforms
    acc_u: torch.Tensor  # [B, S] f32 uniforms


class ChainData(NamedTuple):
    """A run's device-resident inputs (see `prepare`)."""
    tree: TreeTensors
    path_map_t: torch.Tensor  # [P, R] f64, path-major
    counts25_t: torch.Tensor  # [P, R, 25] uint8 / int16 / f64, path-major
    con: float
    freq: torch.Tensor  # [7] f64, FREQ_KEYS order
    device: torch.device


def tree_tensors(tree, device) -> TreeTensors:
    dev = resolve_device(device)
    return TreeTensors(
        torch.as_tensor(np.asarray(tree.parent), dtype=torch.int32).to(dev),
        torch.as_tensor(np.asarray(tree.dist), dtype=F64).to(dev),
        torch.as_tensor(np.asarray(tree.children),
                        dtype=torch.int32).to(dev).contiguous(),
        torch.as_tensor(np.asarray(tree.n_children),
                        dtype=torch.int32).to(dev),
    )


def freq_tensor(freqs: Dict[str, float], device) -> torch.Tensor:
    return torch.tensor([freqs[n] for n in FREQ_KEYS], dtype=F64,
                        device=resolve_device(device))


def counts_dtype(counts25: np.ndarray, device) -> torch.dtype:
    """The smallest type that holds counts25 exactly on `device`: uint8
    or int16 on the card when every count is a small non-negative
    integer, else f64 (always f64 on the CPU)."""
    if torch.device(device).type != "cuda" or counts25.size == 0:
        return F64
    c = np.asarray(counts25)
    if c.min() < 0 or not np.array_equal(c, np.floor(c)):
        return F64
    mx = c.max()
    if mx <= 255:
        return torch.uint8
    if mx <= 32767:
        return torch.int16
    return F64


def prepare(tree, path_map: np.ndarray, counts25: np.ndarray,
            freqs: Dict[str, float], con: float, device) -> ChainData:
    """Upload a run's inputs once: path_map [R, P] and counts25 [R, P, 25]
    (tree-node column order) transposed to path-major [P, R] / [P, R, 25]
    on the device (the JAX package transposed them on every segment
    call), counts25 in `counts_dtype`."""
    dev = resolve_device(device)
    cdt = counts_dtype(counts25, dev)
    c = np.asarray(counts25)
    host = c.astype(np.uint8 if cdt == torch.uint8 else
                    np.int16 if cdt == torch.int16 else np.float64)
    pm = torch.as_tensor(np.asarray(path_map, dtype=np.float64)).to(dev)
    c25 = torch.from_numpy(np.ascontiguousarray(host)).to(dev)
    return ChainData(
        tree=tree_tensors(tree, dev),
        path_map_t=pm.T.contiguous(),
        counts25_t=c25.permute(1, 0, 2).contiguous(),
        con=float(con),
        freq=freq_tensor(freqs, dev),
        device=dev,
    )


# ---------------------------------------------------------------------------
# HKY25 and the walk (plain versions)
# ---------------------------------------------------------------------------
def hky25(t, con, freq: torch.Tensor) -> torch.Tensor:
    """[..., 25] log-likelihoods over (graph class, read class) pairs,
    classes {A,C,G,T,other}, for branch lengths t [...] (f64). Mirrors
    computeBaseLogLike (and the JAX package's hky25) op for op."""
    t = torch.as_tensor(t, dtype=F64, device=freq.device)[..., None]
    con = torch.as_tensor(con, dtype=F64, device=freq.device)
    f = freq[:4]
    R, Y, mu = freq[4], freq[5], freq[6]
    kappa = 0.0  # QUIRK: double kappa = 1/22 (int division) `src/MCMC.h:66`
    AR = 1.0 + R * (kappa - 1.0)
    AY = 1.0 + Y * (kappa - 1.0)
    emt = torch.exp(-(mu * t))
    grp_f = torch.stack([R, Y, R, Y])
    grp_A = torch.stack([AR, AY, AR, AY])
    e_grp = torch.exp(-(mu * t * grp_A))
    jut1 = f + f * (1.0 / grp_f - 1.0) * emt
    p_match = torch.clamp_min(jut1 + ((grp_f - f) / grp_f) * e_grp, 1e-8)
    p_trans = torch.clamp_min(torch.abs(jut1 - (f / grp_f) * e_grp), 1e-8)
    p_other = torch.clamp_min(f * (1.0 - emt), 1e-8)
    bpo = torch.arange(4, device=freq.device)
    partner = (2, 3, 0, 1)  # A<->G, C<->T
    rows = [torch.where(bpo == g, p_match,
                        torch.where(bpo == partner[g], p_trans, p_other))
            for g in range(4)]
    logP = torch.log(torch.stack(rows + [p_other], dim=-2))  # [..., 5, 4]
    lcm = torch.log1p(-con)
    lcx = torch.log(con / 3.0)
    w = torch.stack([torch.where(bpo == rc, lcm, lcx) for rc in range(4)]
                    + [lcx.expand(4)])  # [read class 5, bpo 4]
    m = torch.logsumexp(logP[..., :, None, :] + w, dim=-1)  # [..., 5, 5]
    m = torch.where(m > 1e-8, torch.log(torch.tensor(
        0.999999999, dtype=F64, device=freq.device)), m)
    return m.reshape(m.shape[:-2] + (25,))


def burn_walk_hops(num_paths: int) -> int:
    """Burn-in walk bound from the annealing start sd (4*init_sd + 8,
    between POST_BURN_HOPS and WALK_HOPS)."""
    init_sd = 3.0 if num_paths <= 30 else num_paths * (3.0 / 30.0)
    return int(min(WALK_HOPS, max(POST_BURN_HOPS, 4 * init_sd + 8)))


def sd_schedule(max_iter: int, burn: int, num_paths: int) -> np.ndarray:
    """Annealed proposal sd per iteration (`src/MCMC.cpp:544-596`)."""
    init_sd = 3.0 if num_paths <= 30 else num_paths * (3.0 / 30.0)
    step = (init_sd - 0.1) / max(1, burn - 1)
    step2 = (0.1 - 1e-5) / max(1, (max_iter - burn) - 1)
    it = np.arange(max_iter + 1, dtype=np.float64)
    sd = np.where(
        it < burn,
        np.maximum(1e-5, init_sd - it * step),
        np.maximum(1e-5, 0.1 - (it - burn) * step2),
    )
    sd[(it % 100000 == 0) & (it >= burn)] = 1.0
    return sd


def _lookup(table: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """table[n] with a row of zeros where n lies outside [0, N): the JAX
    package's one-hot select-reduce lookup, which never indexes out of
    range (a leaf's `kids[0]` is -1 in branches that are then masked
    away)."""
    N = table.shape[0]
    ok = (n >= 0) & (n < N)
    v = table[n.clamp(0, N - 1)]
    ok = ok.view(ok.shape + (1,) * (v.dim() - ok.dim()))
    return torch.where(ok, v, torch.zeros((), dtype=v.dtype, device=v.device))


def _pick(kids, nc, u):
    """kids[j], j = min(floor(u * max(nc, 1)), max(nc, 1) - 1)."""
    ncm = torch.clamp_min(nc, 1).to(F64)
    j = torch.minimum(torch.floor(u * ncm), ncm - 1.0).long()
    return kids.gather(1, j[:, None])[:, 0]


def update_position(tree: TreeTensors, node, pos, move, forward, walk_u):
    """One proposal move of `move` (>= 0) in direction `forward`, for M
    sources at once: node [M] int, pos/move [M] f64, forward [M] bool,
    walk_u [M, hops, 4] uniforms (child pick, parent-vs-sibling pick,
    root-bounce child pick, sibling-child pick per hop). A Python loop
    over hops with every branch evaluated and selected, as the JAX
    package's update_position; a hop after the move is used up changes
    nothing. Returns (node [M] int32, pos [M] f64)."""
    node = node.long()
    pos = pos.to(F64)
    d = move.to(F64)
    fwd = forward.bool()
    u_all = walk_u.to(F64)
    Cc = tree.children.shape[1]
    zero = torch.zeros((), dtype=F64, device=pos.device)
    one = torch.ones((), dtype=F64, device=pos.device)
    for h in range(u_all.shape[1]):
        u = u_all[:, h]
        active = d > 0.0
        par = _lookup(tree.parent, node).long()
        nc = _lookup(tree.n_children, node).long()
        kids = _lookup(tree.children, node).long()
        is_leaf = nc == 0
        is_root = par < 0

        # forward: stay / leaf bounce / cross into a random child
        f_stay = pos + d < 1.0
        rem = torch.clamp_min(d - (1.0 - pos), 0.0)
        child = _pick(kids, nc, u[:, 0])
        f3_pos = torch.where(rem > 1.0, one, rem)
        f3_d = torch.where(rem > 1.0, rem - 1.0, zero)
        fw_pos = torch.where(f_stay, pos + d, torch.where(is_leaf, pos, f3_pos))
        fw_d = torch.where(f_stay, zero, torch.where(is_leaf, d, f3_d))
        fw_node = torch.where(f_stay | is_leaf, node, child)
        fw_fwd = torch.where(f_stay, fwd, torch.where(is_leaf, False, fwd))

        # backward: stay / root bounce / parent or sibling
        b_stay = pos - d > 0.0
        root_child = _pick(kids, nc, u[:, 2])
        parc = torch.clamp_min(par, 0)
        nc_par = _lookup(tree.n_children, parc).long()
        kids_par = _lookup(tree.children, parc).long()
        nsib = torch.where(is_leaf, zero,
                           torch.clamp_min(nc_par, 1).to(F64) - 1.0)
        n_possible = 1.0 + nsib
        pickv = torch.minimum(torch.floor(u[:, 1] * n_possible),
                              torch.clamp_min(n_possible, 1.0) - 1.0)
        chose_parent = pickv == 0
        remb = torch.clamp_min(d - pos, 0.0)
        bp_pos = torch.where(remb > 1.0, zero,
                             torch.clamp(1.0 - remb, 1e-12, 1.0))
        bp_d = torch.where(remb > 1.0, remb - 1.0, zero)
        sib_j = pickv - 1.0
        self_pos = (kids_par == node[:, None]).to(torch.int8).argmax(dim=1)
        sib_idx = sib_j + (sib_j >= self_pos).to(F64)
        sib_idx = torch.clamp(sib_idx, 0.0, Cc - 1.0).long()
        sibling = kids_par.gather(1, sib_idx[:, None])[:, 0]
        rems = d - pos
        s_stay = rems < 1.0
        nc_sib = _lookup(tree.n_children, sibling).long()
        sib_leaf = nc_sib == 0
        rems2 = torch.clamp_min(d - 1.0, 0.0)
        sib_child = _pick(_lookup(tree.children, sibling).long(), nc_sib,
                          u[:, 3])
        bs_pos = torch.where(
            s_stay, torch.clamp_min(rems, 0.0),
            torch.where(sib_leaf, zero, torch.where(rems2 > 1.0, one, rems2)))
        bs_d = torch.where(
            s_stay, zero,
            torch.where(sib_leaf, d,
                        torch.where(rems2 > 1.0, rems2 - 1.0, zero)))
        bs_node = torch.where(s_stay | sib_leaf, sibling, sib_child)
        bs_fwd = s_stay | ~sib_leaf

        def back(stay, root, parent_v, sib_v):
            return torch.where(b_stay, stay, torch.where(
                is_root, root, torch.where(chose_parent, parent_v, sib_v)))

        bw_pos = back(pos - d, pos, bp_pos, bs_pos)
        bw_d = back(zero, d, bp_d, bs_d)
        bw_node = back(node, root_child, par, bs_node)
        bw_fwd = back(fwd, torch.ones_like(fwd), fwd, bs_fwd)

        pos = torch.where(active, torch.where(fwd, fw_pos, bw_pos), pos)
        d2 = torch.where(fwd, fw_d, bw_d)
        node = torch.where(active, torch.where(fwd, fw_node, bw_node), node)
        fwd = torch.where(active, torch.where(fwd, fw_fwd, bw_fwd), fwd)
        d = torch.where(active, d2, d)
    return node.to(torch.int32), pos


# ---------------------------------------------------------------------------
# one segment of S steps: plain version and kernel wrapper
# ---------------------------------------------------------------------------
def _log_like(nodes, pos, theta, mask, path_map_t, counts25_t, tree,
              con, freq):
    """[B] log-likelihood of proposals nodes/pos/theta [B, K]."""
    P = path_map_t.shape[0]
    n = nodes.long()
    par = _lookup(tree.parent, n).long()
    par = torch.where(par < 0, n, par)
    t = _lookup(tree.dist, n)
    t = torch.where(t == 0.0, torch.full_like(t, 1e-5), t)
    t1 = pos * t
    t2 = t - t1
    h_c = hky25(t2, con, freq)  # [B, K, 25]
    h_p = hky25(t1, con, freq)
    c = n.clamp(0, P - 1)  # an index past the table clamps, as in JAX
    p = par.clamp(0, P - 1)
    llc = path_map_t[c] + torch.einsum(
        "bkrc,bkc->bkr", counts25_t[c].to(F64), h_c)
    llp = path_map_t[p] + torch.einsum(
        "bkrc,bkc->bkr", counts25_t[p].to(F64), h_p)
    per_src = torch.logaddexp(torch.log(pos)[..., None] + llc,
                              torch.log1p(-pos)[..., None] + llp)
    neg_inf = torch.full_like(theta, -float("inf"))
    theta_log = torch.where(mask, torch.log(theta), neg_inf)
    inter = torch.logsumexp(per_src + theta_log[..., None], dim=1)
    return inter.sum(dim=-1)


def run_segment_plain(nodes, pos, theta, ll, mask, iters, sd, noise: Noise,
                      path_map_t, counts25_t, tree: TreeTensors, con, freq):
    """S steps of B rows as torch ops (the JAX package's _run_segment,
    vmapped over rows): nodes [B, K] int32, pos/theta [B, K] f64, ll [B]
    f64, mask [B, K] bool, iters [S] int64, sd [S] f64. Returns
    ((nodes, pos, theta, ll), (rec_nodes [B, S, K] int32, rec_pos,
    rec_theta [B, S, K] f64, rec_ll [B, S] f64)), the records holding
    each step's pre-update state."""
    B, K = nodes.shape
    S = int(iters.shape[0])
    dev = pos.device
    nodes = nodes.to(torch.int32)
    rec_n = torch.empty((B, S, K), dtype=torch.int32, device=dev)
    rec_p = torch.empty((B, S, K), dtype=F64, device=dev)
    rec_t = torch.empty((B, S, K), dtype=F64, device=dev)
    rec_l = torch.empty((B, S), dtype=F64, device=dev)
    one = torch.ones((), dtype=F64, device=dev)
    zero = torch.zeros((), dtype=F64, device=dev)
    hops = noise.walk_u.shape[3]
    its = iters.tolist()
    for s in range(S):
        first = its[s] == 0
        rec_n[:, s], rec_p[:, s], rec_t[:, s], rec_l[:, s] = (
            nodes, pos, theta, ll)
        deltas = noise.deltas[:, s].to(F64) * sd[s]
        nn, npos = update_position(
            tree, nodes.reshape(-1), pos.reshape(-1),
            deltas.abs().reshape(-1), (deltas >= 0).reshape(-1),
            noise.walk_u[:, s].reshape(B * K, hops, 4))
        nn, npos = nn.view(B, K), npos.view(B, K)
        if first:
            nn, npos = nodes, pos
        npos = torch.clamp(npos, 1e-12, 1.0 - 1e-10)
        # truncated N(theta, 0.1) on [0, 1] by inverse CDF
        lo = (0.0 - theta) / 0.1
        hi = (1.0 - theta) / 0.1
        plo = torch.special.ndtr(lo)
        phi = torch.special.ndtr(hi)
        u = torch.clamp(noise.trunc_u[:, s].to(F64), 1e-7, 1.0 - 1e-7)
        z = torch.special.ndtri(plo + u * (phi - plo))
        z = torch.minimum(torch.maximum(z, lo), hi)
        nt = theta + 0.1 * torch.where(mask, z, zero)
        nt = nt / nt.sum(dim=1, keepdim=True)
        prop = _log_like(nn, npos, nt, mask, path_map_t, counts25_t, tree,
                         con, freq)
        acc = noise.acc_u[:, s].to(F64) <= torch.minimum(
            one, torch.exp(prop - ll))
        if first:
            acc = torch.ones_like(acc)
        nodes = torch.where(acc[:, None], nn, nodes)
        pos = torch.where(acc[:, None], npos, pos)
        theta = torch.where(acc[:, None], nt, theta)
        ll = torch.where(acc, prop, ll)
    return (nodes, pos, theta, ll), (rec_n, rec_p, rec_t, rec_l)


_COUNT_CODES = {torch.uint8: 0, torch.int16: 1, F64: 2}
CLUSTER_SIZES = (16, 8, 4, 2, 1)  # CTAs a row, largest first


def cluster_sizes(B: int, n_sm: int,
                  resident: Callable[[int], int]) -> List[int]:
    """The sizes in CLUSTER_SIZES (largest first) at which B clusters
    all run at once, one CTA an SM (B * G <= n_sm) and no more than
    `resident(G)` clusters, the card's cudaOccupancyMaxActiveClusters
    (injected, so that this runs without a card); always ending with 1,
    at which rows are plain blocks that may queue."""
    return [G for G in CLUSTER_SIZES
            if G == 1 or (B * G <= n_sm and resident(G) >= B)]


def cluster_size(B: int, n_sm: int, resident: Callable[[int], int]) -> int:
    """CTAs a chain row: the largest of `cluster_sizes`."""
    return cluster_sizes(B, n_sm, resident)[0]


@functools.lru_cache(maxsize=None)
def _resident(index: int, G: int, K: int, N: int, Cc: int,
              count_code: int) -> int:
    """Clusters of G CTAs of the kernel that card `index` holds at once."""
    from .._native import tree_mcmc_lib

    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = tree_mcmc_lib().tree_mcmc_max_active_clusters(
            G, K, N, Cc, count_code, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"tree_mcmc: residency query for clusters of "
                           f"{G} failed: CUDA error {rc}")
    return out.value


def card_cluster_sizes(dev: torch.device, B: int, K: int, N: int, Cc: int,
                       counts_dtype: torch.dtype) -> List[int]:
    """cluster_sizes for B rows of the kernel on card `dev`."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    n_sm = torch.cuda.get_device_properties(index).multi_processor_count
    code = _COUNT_CODES[counts_dtype]
    return cluster_sizes(B, n_sm,
                         lambda G: _resident(index, G, K, N, Cc, code))


def card_cluster_size(dev: torch.device, B: int, K: int, N: int, Cc: int,
                      counts_dtype: torch.dtype) -> int:
    """cluster_size for B rows of the kernel on card `dev`."""
    return card_cluster_sizes(dev, B, K, N, Cc, counts_dtype)[0]


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it whose data starts on a 16-byte boundary (the
    kernel reads the walk's uniforms and the counts as wide words)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def run_segment(nodes, pos, theta, ll, mask, iters, sd, noise: Noise,
                path_map_t, counts25_t, tree: TreeTensors, con, freq,
                cluster: Optional[int] = None):
    """S Metropolis-Hastings steps of B chain rows (see
    run_segment_plain for the shapes). CPU tensors run the plain
    version. CUDA tensors launch tree_mcmc_segment_kernel
    (csrc/tree_mcmc.cu) once, with `cluster` CTAs a row (default:
    card_cluster_size's choice), which updates the carry tensors in place
    (when they are contiguous with the kernel's types) and returns them,
    or raises."""
    dev = pos.device
    if dev.type == "cpu":
        return run_segment_plain(nodes, pos, theta, ll, mask, iters, sd,
                                 noise, path_map_t, counts25_t, tree, con,
                                 freq)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from .._native import tree_mcmc_lib

    B, K = nodes.shape
    S = int(iters.shape[0])
    P, R = path_map_t.shape
    N, Cc = tree.children.shape
    hops = noise.walk_u.shape[3]
    if counts25_t.dtype not in _COUNT_CODES:
        raise ValueError(f"tree_mcmc: counts25 dtype {counts25_t.dtype} "
                         "(uint8, int16 or float64)")
    if counts25_t.shape != (P, R, 25) or P < N:
        raise ValueError(f"tree_mcmc: counts25 {tuple(counts25_t.shape)}, "
                         f"path_map {(P, R)}, {N} tree nodes")
    if noise.deltas.shape != (B, S, K) or noise.walk_u.shape != (
            B, S, K, hops, 4) or noise.acc_u.shape != (B, S):
        raise ValueError("tree_mcmc: noise shapes do not match the batch")
    ins = [nodes, pos, theta, ll, mask, iters, sd, *noise, path_map_t,
           counts25_t, *tree, freq]
    if any(t.device != dev for t in ins):
        raise ValueError("tree_mcmc: inputs on different devices")
    nodes_c = nodes.to(torch.int32).contiguous()
    pos_c = pos.to(F64).contiguous()
    theta_c = theta.to(F64).contiguous()
    ll_c = ll.to(F64).contiguous()
    c = [_aligned(x.contiguous()) for x in (
        mask.to(torch.bool), iters.to(torch.int64), sd.to(F64),
        noise.deltas.float(), noise.walk_u.float(), noise.trunc_u.float(),
        noise.acc_u.float(), path_map_t.to(F64), counts25_t,
        tree.parent.to(torch.int32), tree.dist.to(F64),
        tree.children.to(torch.int32), tree.n_children.to(torch.int32),
        freq.to(F64))]
    rec_n = torch.empty((B, S, K), dtype=torch.int32, device=dev)
    rec_p = torch.empty((B, S, K), dtype=F64, device=dev)
    rec_t = torch.empty((B, S, K), dtype=F64, device=dev)
    rec_l = torch.empty((B, S), dtype=F64, device=dev)
    if B and S:
        lib = tree_mcmc_lib()
        G = cluster or card_cluster_size(dev, B, K, N, Cc, counts25_t.dtype)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.tree_mcmc_segment_launch(
                _ptr(nodes_c), _ptr(pos_c), _ptr(theta_c), _ptr(ll_c),
                *[_ptr(x) for x in c[:9]], _COUNT_CODES[counts25_t.dtype],
                *[_ptr(x) for x in c[9:]], float(con),
                _ptr(rec_n), _ptr(rec_p), _ptr(rec_t), _ptr(rec_l),
                B, S, K, hops, R, P, N, Cc, G, ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(
                f"tree_mcmc_segment kernel launch failed: CUDA error {rc}")
        LAUNCHES["tree_mcmc_segment"] += 1
    return (nodes_c, pos_c, theta_c, ll_c), (rec_n, rec_p, rec_t, rec_l)


# ---------------------------------------------------------------------------
# noise and initial proportions
# ---------------------------------------------------------------------------
_MASK64 = (1 << 64) - 1


def _mix(*xs) -> int:
    """A 63-bit generator seed from integers (splitmix64 rounds)."""
    h = 0x9E3779B97F4A7C15
    for x in xs:
        h = (h ^ (int(x) & _MASK64)) & _MASK64
        h = (h + 0x9E3779B97F4A7C15) & _MASK64
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 31
    return h & ((1 << 63) - 1)


@PROFILER.traced("tree_mcmc.noise")
def draw_noise(seeds: Sequence[int], i0: int, i1: int, k: int, hops: int,
               device) -> Noise:
    """Noise of iterations [i0, i1) for rows with these seeds, f32 on
    `device`: a normal delta, hops x 4 walk uniforms and a truncated-
    normal uniform per source, and an accept uniform per row. Each
    NOISE_BLOCK-iteration block of a row comes from its own generator
    (seeded from the row's seed, the block and `hops`), so the stream is
    the same however the iterations are cut into calls. A
    `tree_mcmc.noise` span; `tree_mcmc.noise_generators` counts the
    generators it makes."""
    dev = resolve_device(device)
    S = i1 - i0
    out = Noise(
        torch.empty((len(seeds), S, k), dtype=torch.float32, device=dev),
        torch.empty((len(seeds), S, k, hops, 4), dtype=torch.float32,
                    device=dev),
        torch.empty((len(seeds), S, k), dtype=torch.float32, device=dev),
        torch.empty((len(seeds), S), dtype=torch.float32, device=dev),
    )
    nb = NOISE_BLOCK
    blocks = range(i0 // nb, (i1 - 1) // nb + 1 if S > 0 else i0 // nb)
    PROFILER.count("tree_mcmc.noise_generators", len(blocks) * len(seeds))
    for b in blocks:
        lo, hi = max(i0, b * nb), min(i1, (b + 1) * nb)
        for r, seed in enumerate(seeds):
            g = torch.Generator(device=dev).manual_seed(_mix(seed, b, hops))
            kw = dict(generator=g, dtype=torch.float32, device=dev)
            block = (torch.randn((nb, k), **kw),
                     torch.rand((nb, k, hops, 4), **kw),
                     torch.rand((nb, k), **kw),
                     torch.rand((nb,), **kw))
            for dst, src in zip(out, block):
                dst[r, lo - i0 : hi - i0] = src[lo - b * nb : hi - b * nb]
    return out


def init_theta(seeds: Sequence[int], k: int, device) -> torch.Tensor:
    """[len(seeds), k] f64 uniform random starting proportions (a
    Dirichlet(1) draw, `MCMC.h generateRandomNumbers`): -log(1 - U) from
    each row's own generator, normalised."""
    dev = resolve_device(device)
    rows = []
    for seed in seeds:
        g = torch.Generator(device=dev).manual_seed(_mix(seed, _THETA_STREAM))
        e = -torch.log1p(-torch.rand(k, generator=g, dtype=F64, device=dev))
        rows.append(e / e.sum())
    if not rows:
        return torch.zeros((0, k), dtype=F64, device=dev)
    return torch.stack(rows)


# ---------------------------------------------------------------------------
# runners
# ---------------------------------------------------------------------------
def _bytes_per_iter(B: int, K: int, hops: int) -> int:
    """Noise (f32) and trace bytes of one iteration of B rows."""
    return B * (4 * K * (2 + 4 * hops) + 4 + K * (4 + 8 + 8) + 8)


def segment_plan(total: int, burn: int, num_paths: int, B: int, K: int,
                 start: int = 0, max_len: Optional[int] = None):
    """[(i0, i1, hops)] covering iterations [start, total): cut at the
    burn-in boundary (the burn-in walk takes burn_walk_hops hops, the
    rest POST_BURN_HOPS) and into segments of at most SEGMENT_BYTES of
    noise and trace and `max_len` iterations,
    ends aligned to noise blocks where that keeps a segment non-empty.
    The trace does not depend on the cut."""
    split = min(burn + 1, total)
    plan = []
    for p0, p1, hops in ((0, split, burn_walk_hops(num_paths)),
                         (split, total, POST_BURN_HOPS)):
        S = max(1, SEGMENT_BYTES // _bytes_per_iter(B, K, hops))
        if max_len is not None:
            S = min(S, max_len)
        i0 = max(p0, start)
        while i0 < p1:
            i1 = min(i0 + S, p1)
            if i1 < p1 and i1 - i1 % NOISE_BLOCK > i0:
                i1 -= i1 % NOISE_BLOCK
            plan.append((i0, i1, hops))
            i0 = i1
    return plan


def on_device(data: ChainData, device) -> ChainData:
    """`data` with its tensors copied onto `device` (itself when they
    already sit there)."""
    dev = resolve_device(device)
    if dev == data.device:
        return data
    return ChainData(
        tree=TreeTensors(*(t.to(dev) for t in data.tree)),
        path_map_t=data.path_map_t.to(dev),
        counts25_t=data.counts25_t.to(dev),
        con=data.con,
        freq=data.freq.to(dev),
        device=dev,
    )


def _as_data(tree, stats_path_map, stats_counts25, freqs, con,
             device) -> ChainData:
    if isinstance(stats_path_map, ChainData):
        return stats_path_map
    return prepare(tree, stats_path_map, stats_counts25, freqs, con, device)


@PROFILER.traced("tree_mcmc.sweep")
def _run_rows(data: ChainData, srcs: np.ndarray, mask: np.ndarray,
              theta0: torch.Tensor, ll0: np.ndarray, seeds: np.ndarray,
              max_iter: int, burn: int, num_paths: int, devices=None):
    """The whole chain of B rows, segment by segment. Returns the
    records of every iteration as numpy ([B, max_iter + 1, ...]).

    devices, a list of n devices with B % n == 0: the rows split into n
    contiguous groups, group j on devices[j] with its own copy of the
    data, every group's segment launched before the next segment (the
    JAX package's chain axis sharded over its mesh). A row's noise is
    its own, so the split changes no row's stream.

    A `tree_mcmc.sweep` span holding each segment's `tree_mcmc.noise` and
    `tree_mcmc.launch` and the records' `tree_mcmc.records` (where the
    host waits for the card); counters `tree_mcmc.row_steps` and
    `tree_mcmc.record_bytes`."""
    B, K = srcs.shape
    datas = [data]
    if devices is not None and len(devices) > 1 and B % len(devices) == 0:
        datas = [on_device(data, d) for d in devices]
    per = B // len(datas)
    groups = [slice(j * per, (j + 1) * per) for j in range(len(datas))]
    sd_np = sd_schedule(max_iter, burn, num_paths)
    runs = []
    for rows, d in zip(groups, datas):
        dev = d.device
        carry = (torch.as_tensor(srcs[rows], dtype=torch.int32).to(dev),
                 torch.full((per, K), 0.5, dtype=F64, device=dev),
                 theta0[rows].to(dev, F64),
                 torch.as_tensor(np.asarray(ll0[rows], np.float64)).to(dev))
        runs.append(dict(
            data=d, seeds=seeds[rows], carry=carry, recs=[],
            sd=torch.as_tensor(sd_np, dtype=F64).to(dev),
            mask=torch.as_tensor(mask[rows], dtype=torch.bool).to(dev)))
    plan = segment_plan(max_iter + 1, burn, num_paths, per, K)
    PROFILER.count("tree_mcmc.row_steps", B * (max_iter + 1))
    for i0, i1, hops in plan:
        for run in runs:
            d = run["data"]
            noise = draw_noise(run["seeds"], i0, i1, K, hops, d.device)
            with PROFILER.span("tree_mcmc.launch"):
                iters = torch.arange(i0, i1, dtype=torch.int64,
                                     device=d.device)
                run["carry"], rec = run_segment(
                    *run["carry"], run["mask"], iters, run["sd"][i0:i1],
                    noise, d.path_map_t, d.counts25_t, d.tree, d.con,
                    d.freq)
            run["recs"].append(rec)
    with PROFILER.span("tree_mcmc.records"):
        out = [np.concatenate([
            torch.cat([r[i] for r in run["recs"]], dim=1).cpu().numpy()
            for run in runs]) for i in range(4)]
    PROFILER.count("tree_mcmc.record_bytes", sum(x.nbytes for x in out))
    return out


def run_tree_mcmc(tree, stats_path_map, stats_counts25, sources, freqs,
                  con: float, max_iter: int, burn: int, num_paths: int,
                  init_loglike: float, seed: int = 0, *,
                  device) -> MCMCTrace:
    """Run one chain (the chains runner with one row)."""
    tr = run_tree_mcmc_chains(
        tree, stats_path_map, stats_counts25,
        np.asarray(sources, np.int32)[None, :], freqs, con, max_iter, burn,
        num_paths, init_loglike, seeds=np.asarray([seed]), device=device)
    return MCMCTrace(node=tr.node[0], pos=tr.pos[0], theta=tr.theta[0],
                     loglike=tr.loglike[0])


def run_tree_mcmc_chains(tree, stats_path_map, stats_counts25,
                         sources_per_chain: np.ndarray, freqs,
                         con: float, max_iter: int, burn: int,
                         num_paths: int, init_loglike: float,
                         seeds: np.ndarray, *, device,
                         devices=None) -> MCMCTrace:
    """C chains as one batch of C rows (split over `devices` as
    `_run_rows` says). stats_path_map may be a ChainData from `prepare`
    (then stats_counts25, freqs and con are taken from it). Traces come
    back stacked [C, ...]."""
    data = _as_data(tree, stats_path_map, stats_counts25, freqs, con, device)
    srcs = np.asarray(sources_per_chain, np.int32)
    C, k = srcs.shape
    seeds = [int(s) for s in np.asarray(seeds)]
    rn, rp, rt, rl = _run_rows(
        data, srcs, np.ones((C, k), bool), init_theta(seeds, k, data.device),
        np.full(C, init_loglike, np.float64), seeds, max_iter, burn,
        num_paths, devices)
    return MCMCTrace(node=rn[:, burn + 1:], pos=rp[:, burn + 1:],
                     theta=rt[:, burn + 1:], loglike=rl[:, burn + 1:])


def ksweep_rows(sources_per_k, init_logls, seeds_per_k, device):
    """The k-sweep's K*C rows padded to Kmax: (srcs [B, Kmax] int32,
    mask [B, Kmax] bool, initial theta [B, Kmax] f64 on `device` (padded
    slots 0), initial log-likelihoods [B] and seeds [B])."""
    K = len(sources_per_k)
    Kmax = max(s.shape[1] for s in sources_per_k)
    C = sources_per_k[0].shape[0]
    B = K * C
    srcs = np.zeros((B, Kmax), dtype=np.int32)
    mask = np.zeros((B, Kmax), dtype=bool)
    ll0 = np.zeros(B, dtype=np.float64)
    seeds: List[int] = []
    theta0 = torch.zeros((B, Kmax), dtype=F64, device=device)
    for i, s in enumerate(sources_per_k):
        ki = s.shape[1]
        rows = slice(i * C, (i + 1) * C)
        srcs[rows, :ki] = s
        mask[rows, :ki] = True
        ll0[rows] = init_logls[i]
        row_seeds = [int(x) for x in np.asarray(seeds_per_k[i])]
        seeds += row_seeds
        theta0[rows, :ki] = init_theta(row_seeds, ki, device)
    return srcs, mask, theta0, ll0, seeds


def run_tree_mcmc_ksweep(tree, stats_path_map, stats_counts25,
                         sources_per_k, freqs, con: float, max_iter: int,
                         burn: int, num_paths: int, init_logls,
                         seeds_per_k, *, device, devices=None):
    """The whole k-sweep (k = 1..K, C chains each) as ONE batch of K*C
    rows (the reference runs each k in turn, `src/soibean.cpp:745-840`).
    Rows pad their sources to Kmax with a mask: padded slots keep theta
    = 0 and weigh -inf in the mixture, and each row's noise is drawn at
    Kmax width, so a row with k_i == Kmax equals the standalone chains
    runner with the same seed. The rows split over `devices` as
    `_run_rows` says. Returns a list of MCMCTrace, entry i holding that
    k's [C, iters, k_i] trace."""
    data = _as_data(tree, stats_path_map, stats_counts25, freqs, con, device)
    C = sources_per_k[0].shape[0]
    srcs, mask, theta0, ll0, seeds = ksweep_rows(
        sources_per_k, init_logls, seeds_per_k, data.device)
    rn, rp, rt, rl = _run_rows(data, srcs, mask, theta0, ll0, seeds,
                               max_iter, burn, num_paths, devices)
    out = []
    for i, s in enumerate(sources_per_k):
        ki = s.shape[1]
        rows = slice(i * C, (i + 1) * C)
        out.append(MCMCTrace(
            node=rn[rows, burn + 1:, :ki], pos=rp[rows, burn + 1:, :ki],
            theta=rt[rows, burn + 1:, :ki], loglike=rl[rows, burn + 1:]))
    return out


def run_tree_mcmc_checkpointed(tree, stats_path_map, stats_counts25,
                               sources: np.ndarray, freqs, con: float,
                               max_iter: int, burn: int, num_paths: int,
                               init_loglike: float, seed: int = 0,
                               checkpoint_path: Optional[str] = None,
                               checkpoint_every: int = 100000, *,
                               device) -> MCMCTrace:
    """One chain in segments with exact resume: chain state and recorded
    samples snapshot to `checkpoint_path` (.npz) every
    `checkpoint_every` iterations; rerunning with the same path continues
    where the last snapshot left off and gives the uninterrupted trace.
    The snapshot names its format (CHECKPOINT_FORMAT) and the row's
    seed, which keys the rest of the noise stream; a snapshot of the JAX
    package (keyed by a threefry key) is refused."""
    if checkpoint_path and not checkpoint_path.endswith(".npz"):
        checkpoint_path += ".npz"
    data = _as_data(tree, stats_path_map, stats_counts25, freqs, con, device)
    dev = data.device
    k = len(sources)
    total = max_iter + 1
    sd = torch.as_tensor(sd_schedule(max_iter, burn, num_paths),
                         dtype=F64).to(dev)
    start = 0
    segments: list = []
    if checkpoint_path and os.path.exists(checkpoint_path):
        z = np.load(checkpoint_path, allow_pickle=False)
        fmt = str(z["format"]) if "format" in z.files else "vgan_tpu (JAX)"
        if fmt != CHECKPOINT_FORMAT or int(z["seed"]) != int(seed):
            raise ValueError(
                f"{checkpoint_path}: checkpoint format {fmt!r} seed "
                f"{z['seed'] if 'seed' in z.files else None}; this run "
                f"resumes only {CHECKPOINT_FORMAT!r} with seed {seed}")
        start = int(z["next_iter"])
        carry = tuple(torch.as_tensor(z[n]).to(dev)
                      for n in ("nodes", "pos", "theta", "ll"))
        segments = [tuple(z[n] for n in ("rec_nodes", "rec_pos", "rec_theta",
                                          "rec_ll"))]
    else:
        carry = (torch.as_tensor(np.asarray(sources, np.int32))[None].to(dev),
                 torch.full((1, k), 0.5, dtype=F64, device=dev),
                 init_theta([seed], k, dev),
                 torch.full((1,), init_loglike, dtype=F64, device=dev))
    mask = torch.ones((1, k), dtype=torch.bool, device=dev)
    last_saved = start
    with PROFILER.span("tree_mcmc.sweep"):
        plan = segment_plan(total, burn, num_paths, 1, k, start=start,
                            max_len=checkpoint_every)
        PROFILER.count("tree_mcmc.row_steps", total - start)
        for i0, i1, hops in plan:
            noise = draw_noise([seed], i0, i1, k, hops, dev)
            with PROFILER.span("tree_mcmc.launch"):
                iters = torch.arange(i0, i1, dtype=torch.int64, device=dev)
                carry, rec = run_segment(*carry, mask, iters, sd[i0:i1], noise,
                                         data.path_map_t, data.counts25_t,
                                         data.tree, data.con, data.freq)
            with PROFILER.span("tree_mcmc.records"):
                segments.append(tuple(x[0].cpu().numpy() for x in rec))
            PROFILER.count("tree_mcmc.record_bytes",
                           sum(x.nbytes for x in segments[-1]))
            if checkpoint_path and (i1 - last_saved >= checkpoint_every
                                    or i1 >= total):
                acc = [np.concatenate([sg[i] for sg in segments])
                       for i in range(4)]
                np.savez(
                    checkpoint_path, format=CHECKPOINT_FORMAT, seed=int(seed),
                    next_iter=i1,
                    **{n: x.cpu().numpy() for n, x in zip(
                        ("nodes", "pos", "theta", "ll"), carry)},
                    rec_nodes=acc[0], rec_pos=acc[1], rec_theta=acc[2],
                    rec_ll=acc[3])
                segments = [tuple(acc)]
                last_saved = i1
    rn, rp, rt, rl = (np.concatenate([sg[i] for sg in segments])
                      for i in range(4))
    return MCMCTrace(node=rn[burn + 1:], pos=rp[burn + 1:],
                     theta=rt[burn + 1:], loglike=rl[burn + 1:])
