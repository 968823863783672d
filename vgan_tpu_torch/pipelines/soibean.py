# Copied unchanged from vgan_tpu/pipelines/soibean.py; its relative imports resolve to this package.
"""soibean: species identification / k-source mixture via tree MCMC.

TPU-native reformulation of `src/soibean.cpp` + `src/getLCAfromGAM.h`
+ `src/MCMC.cpp:522-1088`.

Design: analyse_GAM's per-read x per-path x per-base triple loop
(`src/getLCAfromGAM.h:123-539`) collapses into per-(read, path)
sufficient statistics, because every per-base quantity is either
path-independent or enters only through node-path support:

  pathMap[r,p]   - the precomputed per-path log likelihood
  counts25[r,p,c]- counts of supported (graph-class, read-class) base
                   pairs, classes = {A,C,G,T,other} x {A,C,G,T,other}

Each MCMC iteration then evaluates, per source, the HKY85 recompute of
`MCMC::computeBaseLogLike` (`src/MCMC.h:111-296`) as a closed-form
25-vector dotted with counts25 — an O(R*25) contraction instead of the
reference's O(R * bases) scalar loop, executed inside a jax scan with
chains vmapped (see infer/tree_mcmc.py).

Reference quirks preserved:
* supported ACGT-vs-ACGT bases score the constant log(0.9999999):
  the damage marginal `src/getLCAfromGAM.h:340-353` adds
  log(post[bpd]) for matching AND mismatching read bases alike, so it
  telescopes to log(sum post) = log(1), clamped to log(0.9999999).
  Supported bases whose *graph* char is a rare IUPAC code instead
  yield log(4*q/3) (no pre-damage row matches).
* quality is indexed by the position WITHIN the node slice
  (`src/getLCAfromGAM.h:227`), i.e. every mapping re-reads the first
  |mapping| quality values of the read.
* `mppg_sizes` has one entry per edit; trailing entries beyond the
  mapping count are scored unsupported for every path
  (`src/getLCAfromGAM.h:156-166`).
* unsupported ACGT bases get the PENALTY-periodic score: every base
  whose |baseOnRead| % PENALTY == 0 scores log(1-q), others log(q/3)
  (`src/getLCAfromGAM.h:471-512`); baseOnRead starts at the mapping's
  aligned start coordinate and walks the read (down for reverse).
* reverse-strand slices use startIndex = max(baseIX - size - 1, 0)
  (`src/getLCAfromGAM.h:180`), reproducing its off-by-one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..graph.packed import PackedGraph
from ..graph.reconstruct import reconstruct_graph_sequence
from ..io.gam import Alignment
from ..models import phred
from ..utils import guards
from ..utils import dna

LOG_SUPPORTED_CONST = float(np.log(0.9999999))
LOG_N = float(np.log(0.25))
LOG_GAP = float(np.log(0.02))


@dataclass
class ReadStats:
    """Per-read sufficient statistics over all paths."""

    names: List[str]  # read names
    path_map: np.ndarray  # [R, P] precomputed path log-likelihoods
    counts25: np.ndarray  # [R, P, 25] supported pair-class counts
    most_prob_unique: np.ndarray  # [R] bool: single argmax path
    most_prob_idx: np.ndarray  # [R] argmax path index


def _class_of(code: int) -> int:
    return code if code < 4 else 4


def analyse_reads(
    graph: PackedGraph,
    alignments: Sequence[Alignment],
    penalty: int = 7,
    detail_path: str = "",
    path_thres: int = 0,
) -> ReadStats:
    """Host-side equivalent of analyse_GAM building the stats arrays.

    Production path is the columnar/vectorized `analyse_table` (native
    batch reconstruction + flat array passes, no per-read Python loop);
    the literal per-read loop below remains the oracle
    (`analyse_reads_loop`, parity-tested in tests/test_soibean.py) and
    handles the --alignment-detail TSV, whose per-matching-base rows
    are inherently row-at-a-time."""
    if not detail_path:
        try:
            from ..mapper.batch_map import load_native, table_from_alignments

            if load_native() is not None:
                return analyse_table(
                    graph, table_from_alignments(alignments),
                    penalty=penalty,
                )
        except OSError:  # pragma: no cover
            pass
    return analyse_reads_loop(
        graph, alignments, penalty=penalty, detail_path=detail_path,
        path_thres=path_thres,
    )


def analyse_reads_loop(
    graph: PackedGraph,
    alignments: Sequence[Alignment],
    penalty: int = 7,
    detail_path: str = "",
    path_thres: int = 0,
) -> ReadStats:
    """Literal per-read transcription of analyse_GAM (the oracle for
    `analyse_table`).

    detail_path/path_thres: the --alignment-detail / --pathThres
    feature (`src/getLCAfromGAM.h:73-77,199-214`): writes
    <out>_MatchInfo.tsv with one row per (supported path, matching
    base) for nodes whose path count is <= path_thres (0 = all paths,
    the reference default "all paths")."""
    qscore = phred.qscore_vec()
    P = graph.n_paths
    support = graph.path_support  # [n_nodes, P] bool
    reads = [a for a in alignments if a.identity != 0 and a.path.mappings]
    R = len(reads)
    path_map = np.zeros((R, P), dtype=np.float64)
    counts25 = np.zeros((R, P, 25), dtype=np.float32)
    names: List[str] = []
    detail = None
    if detail_path:
        detail = open(detail_path + "_MatchInfo.tsv", "w")
        detail.write(
            "Path name\tRead name\tNode sequence\tIndex on node\t"
            "Node Base\tRead Sequence\tIndex on read\n"
        )

    # batch reconstruction via the native lib when available (the
    # per-read python reconstruct is the precompute's hot spot)
    recon = None
    try:
        from ..mapper.batch_map import load_native, table_from_alignments

        if load_native() is not None and R:
            from .hc_columnar import reconstruct_table

            recon = reconstruct_table(graph, table_from_alignments(reads))
    except OSError:  # pragma: no cover
        recon = None

    for ridx, a in enumerate(reads):
        names.append(a.name)
        if recon is not None:
            g_cat, g_off, g_len, r_cat, r_off, r_len, szs, s_off, s_len = (
                recon
            )
            g_all = g_cat[g_off[ridx] : g_off[ridx] + g_len[ridx]]
            r_all = r_cat[r_off[ridx] : r_off[ridx] + r_len[ridx]]
            mppg_sizes = szs[s_off[ridx] : s_off[ridx] + s_len[ridx]]
            graph_seq = read_seq = None  # decoded lazily (detail only)
        else:
            graph_seq, read_seq, mppg_sizes = reconstruct_graph_sequence(
                graph, a.path, a.sequence
            )
            g_all = dna.encode(graph_seq)
            r_all = dna.encode(read_seq)
        isrev = a.path.mappings[0].position.is_reverse
        qual = np.frombuffer(a.quality, dtype=np.uint8)
        baseIX = len(a.sequence) - 1 if isrev else 0
        n_map = len(a.path.mappings)

        specials_sum = 0.0
        # per-mapping vectors
        M = len(mppg_sizes)
        sup_rows = np.zeros((M, P), dtype=bool)
        stored_sup = np.zeros(M, dtype=np.float64)
        unsup_pen = np.zeros(M, dtype=np.float64)
        pc25 = np.zeros((M, 25), dtype=np.float32)

        for i, size in enumerate(mppg_sizes):
            if i < n_map:
                nid = a.path.mappings[i].position.node_id
                sup_rows[i] = support[nid - graph.min_id]
            # else: all-unsupported ("No_support") — sup_rows[i] stays False

            if isrev:
                start = baseIX - size - 1 if baseIX - size - 1 >= 0 else 0
            else:
                start = baseIX
            g = g_all[start : start + size]
            r = r_all[start : start + size]
            L = len(g)

            if detail is not None and i < n_map:
                if graph_seq is None:
                    graph_seq = dna.decode(g_all)
                    read_seq = dna.decode(r_all)
                n_probpaths = int(sup_rows[i].sum())
                if path_thres <= 0 or n_probpaths <= path_thres:
                    gs = graph_seq[start : start + size]
                    rs = read_seq[start : start + size]
                    for p in np.flatnonzero(sup_rows[i]):
                        pname = graph.path_names[int(p)]
                        for s in range(len(gs)):
                            if gs[s] == rs[s]:
                                detail.write(
                                    f"{pname}\t{a.name}\t{gs}\t{s}\t"
                                    f"{gs[s]}\t{a.sequence}\t"
                                    f"{baseIX + s}\n"
                                )
            # slice-local quality (reference quirk)
            q_idx = np.zeros(L, dtype=np.int64)
            avail = min(L, len(qual))
            q_idx[:avail] = qual[:avail]
            q = qscore[np.clip(q_idx, 0, 99)]

            is_n = (g == dna.N) | (r == dna.N)
            is_s = ~is_n & ((g == dna.SOFTCLIP) | (r == dna.SOFTCLIP))
            is_gap = ~is_n & ~is_s & ((g == dna.GAP) | (r == dna.GAP))
            is_base = ~is_n & ~is_s & ~is_gap  # ACGT or rare

            specials_sum += (
                is_n.sum() * LOG_N
                + np.log(q[is_s] / 3.0).sum()
                + is_gap.sum() * LOG_GAP
            )

            # supported stored values over base-class positions
            g_rare = is_base & (g >= 4)  # graph char not plain ACGT
            g_acgt = is_base & (g < 4)
            stored_sup[i] = g_acgt.sum() * LOG_SUPPORTED_CONST + np.log(
                4.0 * q[g_rare] / 3.0
            ).sum()

            # unsupported penalty: baseOnRead walk over non-gap read chars
            nongap = (r != dna.GAP).astype(np.int64)
            before = np.concatenate([[0], np.cumsum(nongap)[:-1]])
            base_on_read = (baseIX - before) if isrev else (baseIX + before)
            periodic = (np.abs(base_on_read) % penalty) == 0
            pen = np.where(periodic, np.log1p(-q), np.log(q / 3.0))
            unsup_pen[i] = pen[is_base].sum()

            # pair-class counts for the HKY recompute
            if is_base.any():
                gc = np.minimum(g[is_base], 4)
                rc = np.minimum(r[is_base], 4)
                np.add.at(pc25[i], gc * 5 + rc, 1)

            if isrev:
                baseIX = start
            else:
                baseIX += size

        S = sup_rows.astype(np.float64)  # [M, P]
        path_map[ridx] = (
            specials_sum + stored_sup @ S + unsup_pen @ (1.0 - S)
        )
        counts25[ridx] = np.einsum("mp,mc->pc", S.astype(np.float32), pc25)

    if detail is not None:
        detail.close()
    # batch equivalent of `src/getLCAfromGAM.h:355-357` per-base gate
    guards.check_loglik(path_map, "soibean pathMap")
    # mostProbPath: exact-equality argmax ties (`src/getLCAfromGAM.h:564-579`)
    if R:
        mx = path_map.max(axis=1, keepdims=True)
        ties = (path_map == mx).sum(axis=1)
        unique = ties == 1
        idx = path_map.argmax(axis=1)
    else:
        unique = np.zeros(0, dtype=bool)
        idx = np.zeros(0, dtype=np.int64)
    return ReadStats(
        names=names,
        path_map=path_map,
        counts25=counts25,
        most_prob_unique=unique,
        most_prob_idx=idx,
    )


def _segment_firsts(counts: np.ndarray) -> np.ndarray:
    """Exclusive cumsum: flat index of each segment's first element."""
    off = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=off[1:])
    return off


def analyse_table(graph: PackedGraph, table, penalty: int = 7) -> ReadStats:
    """Columnar analyse_GAM (`src/getLCAfromGAM.h:123-539`): the whole
    per-read x per-slice x per-base computation as flat array passes
    over the native batch reconstruction — zero per-read Python loops
    (the CLAUDE.md hot-host-path rule; VERDICT r2 #5).

    Semantics are identical to `analyse_reads_loop` (parity test:
    tests/test_soibean.py::test_analyse_table_matches_loop), including
    every preserved reference quirk: slice-local quality indexing, the
    reverse-strand start off-by-one (closed form
    start_i = max(len-1 - sum_{j<=i}(size_j+1), 0), equivalent to the
    sequential clamp because sizes are positive), PENALTY-periodic
    unsupported scoring walked from the mapping's aligned start, and
    trailing mppg_sizes entries scored unsupported for every path."""
    from ..mapper.batch_map import AlignmentTable  # noqa: F401
    from .hc_columnar import reconstruct_table

    qscore = phred.qscore_vec()
    P = graph.n_paths
    support = graph.path_support  # [n_nodes, P] bool
    keep = (table.identity != 0) & (table.nmap > 0)
    t = table.select(keep)
    R = t.n
    names = list(t.names)
    if R == 0:
        return ReadStats(
            names=names,
            path_map=np.zeros((0, P), dtype=np.float64),
            counts25=np.zeros((0, P, 25), dtype=np.float32),
            most_prob_unique=np.zeros(0, dtype=bool),
            most_prob_idx=np.zeros(0, dtype=np.int64),
        )
    g_cat, g_off, g_len, r_cat, r_off, r_len, szs, s_off, s_len = (
        reconstruct_table(graph, t)
    )

    # per-read scalars
    isrev = t.m_rev[t.map_off[:-1]].astype(bool)  # first mapping strand
    n_map = t.nmap.astype(np.int64)
    seq_len = np.array([len(s) for s in t.seqs], dtype=np.int64)
    qual_cat = np.frombuffer(b"".join(t.quals), dtype=np.uint8)
    qual_len = np.array([len(q) for q in t.quals], dtype=np.int64)
    qual_off = _segment_firsts(qual_len)

    # flat slice table (one row per mppg_sizes entry, read-major order)
    s_len = s_len.astype(np.int64)
    n_sl = int(s_len.sum())
    sl_read = np.repeat(np.arange(R, dtype=np.int64), s_len)
    first_of_read = _segment_firsts(s_len)  # [R+1]
    i_within = np.arange(n_sl, dtype=np.int64) - first_of_read[sl_read]
    sizes = szs[
        AlignmentTable._ranges(s_off[:-1], s_len)
    ].astype(np.int64)

    # slice starts: forward = exclusive within-read cumsum of sizes;
    # reverse = max(len-1 - inclusive cumsum of (size+1), 0); the
    # pre-slice baseIX is len-1 - exclusive cumsum of (size+1)
    # (`src/getLCAfromGAM.h:180` off-by-one preserved)
    c = np.cumsum(sizes)
    excl = c - sizes - (c[first_of_read[sl_read]]
                        - sizes[first_of_read[sl_read]])
    L0 = seq_len[sl_read] - 1
    start = np.where(
        isrev[sl_read],
        np.maximum(L0 - (excl + sizes + i_within + 1), 0),
        excl,
    )
    baseIX = np.where(
        isrev[sl_read], np.maximum(L0 - (excl + i_within), 0), excl
    )
    sl_L = np.clip(g_len[sl_read] - start, 0, sizes)

    # flat position table (one row per reconstructed base in a slice)
    n_pos = int(sl_L.sum())
    pos_slice = np.repeat(np.arange(n_sl, dtype=np.int64), sl_L)
    pos_read = sl_read[pos_slice]
    s_pos = np.arange(n_pos, dtype=np.int64) - np.repeat(
        _segment_firsts(sl_L)[:-1], sl_L
    )
    gidx = g_off[pos_read] + start[pos_slice] + s_pos
    g = g_cat[gidx]
    r = r_cat[gidx]

    # slice-local quality (reference quirk: every slice re-reads the
    # first |slice| quality values of the read; positions past the
    # quality string score as phred 0)
    in_q = s_pos < qual_len[pos_read]
    idx_q = np.where(in_q, qual_off[pos_read] + s_pos, 0)
    qcode = (
        np.where(in_q, qual_cat[idx_q], 0)
        if len(qual_cat)
        else np.zeros(n_pos, dtype=np.uint8)
    )
    q = qscore[np.clip(qcode, 0, 99)]

    is_n = (g == dna.N) | (r == dna.N)
    is_s = ~is_n & ((g == dna.SOFTCLIP) | (r == dna.SOFTCLIP))
    is_gap = ~is_n & ~is_s & ((g == dna.GAP) | (r == dna.GAP))
    is_base = ~is_n & ~is_s & ~is_gap
    g_rare = is_base & (g >= 4)
    g_acgt = is_base & (g < 4)

    # per-read specials; per-slice stored/unsupported sums. Integer
    # counts x constant (not a float sum of n copies) to reproduce the
    # loop's exact `count * LOG_CONST` products — path_map entries for
    # perfect matches are ~1e-6 sums of ~1e-7 terms, so summation
    # structure is the difference between 1e-16 and 1e-9 relative.
    n_n = np.bincount(pos_slice[is_n], minlength=n_sl)
    n_gap = np.bincount(pos_slice[is_gap], minlength=n_sl)
    s_sum = np.bincount(
        pos_slice[is_s], weights=np.log(q[is_s] / 3.0), minlength=n_sl
    )
    spec_slice = n_n * LOG_N + s_sum + n_gap * LOG_GAP
    specials_r = np.bincount(sl_read, weights=spec_slice, minlength=R)

    n_acgt = np.bincount(pos_slice[g_acgt], minlength=n_sl)
    rare_sum = np.bincount(
        pos_slice[g_rare], weights=np.log(4.0 * q[g_rare] / 3.0),
        minlength=n_sl,
    )
    stored_sup = n_acgt * LOG_SUPPORTED_CONST + rare_sum

    # unsupported penalty: baseOnRead walk over non-gap read chars
    ng = (r != dna.GAP).astype(np.int64)
    excl_ng = np.cumsum(ng) - ng  # global exclusive nongap count
    sl_first = _segment_firsts(sl_L)[:-1]
    base_ng = np.zeros(n_sl, dtype=np.int64)
    nz_sl = sl_L > 0
    base_ng[nz_sl] = excl_ng[sl_first[nz_sl]]
    before = excl_ng - base_ng[pos_slice]
    base_on_read = np.where(
        isrev[pos_read], baseIX[pos_slice] - before, baseIX[pos_slice] + before
    )
    periodic = (np.abs(base_on_read) % penalty) == 0
    pen = np.where(periodic, np.log1p(-q), np.log(np.maximum(q, 1e-300) / 3.0))
    unsup_pen = np.bincount(
        pos_slice, weights=np.where(is_base, pen, 0.0), minlength=n_sl
    )

    # per-slice pair-class counts (classes {A,C,G,T,other}^2)
    gc = np.minimum(g, 4).astype(np.int64)
    rc = np.minimum(r, 4).astype(np.int64)
    pc25 = np.bincount(
        pos_slice[is_base] * 25 + gc[is_base] * 5 + rc[is_base],
        minlength=n_sl * 25,
    ).reshape(n_sl, 25).astype(np.float32)

    # roll-up with the loop's non-cancelling formulation:
    #   path_map[r] = specials_r + stored_sup @ S + unsup_pen @ (1-S)
    #   counts25[r] = S^T @ pc25
    # S[i] = support[node_i] (zero row for trailing no-node slices),
    # evaluated as chunked padded einsums ([B, Mmax, P] intermediates
    # bounded to ~32MB).
    has_node = i_within < n_map[sl_read]
    safe_map_idx = np.where(
        has_node, t.map_off[sl_read] + i_within, 0
    )
    node_idx = t.m_node[safe_map_idx] - graph.min_id
    path_map = np.tile(specials_r[:, None], (1, P))
    counts25 = np.zeros((R, P, 25), dtype=np.float32)
    Mmax = int(s_len.max())
    rank = i_within
    sup_rows = np.where(
        has_node[:, None], support[node_idx], False
    )
    B = max(1, int(4_000_000 // max(Mmax * P, 1)))
    for lo_r in range(0, R, B):
        hi_r = min(lo_r + B, R)
        sel = slice(first_of_read[lo_r], first_of_read[hi_r])
        rr = sl_read[sel] - lo_r
        kk = rank[sel]
        nb = hi_r - lo_r
        S_pad = np.zeros((nb, Mmax, P), dtype=np.float64)
        S_pad[rr, kk] = sup_rows[sel]
        stored_pad = np.zeros((nb, Mmax), dtype=np.float64)
        stored_pad[rr, kk] = stored_sup[sel]
        unsup_pad = np.zeros((nb, Mmax), dtype=np.float64)
        unsup_pad[rr, kk] = unsup_pen[sel]
        valid = np.zeros((nb, Mmax), dtype=np.float64)
        valid[rr, kk] = 1.0
        path_map[lo_r:hi_r] += np.einsum("bm,bmp->bp", stored_pad, S_pad)
        path_map[lo_r:hi_r] += np.einsum(
            "bm,bmp->bp", unsup_pad, valid[:, :, None] - S_pad
        )
        C_pad = np.zeros((nb, Mmax, 25), dtype=np.float32)
        C_pad[rr, kk] = pc25[sel]
        counts25[lo_r:hi_r] = np.einsum(
            "bmp,bmc->bpc", S_pad.astype(np.float32), C_pad
        )

    guards.check_loglik(path_map, "soibean pathMap")
    mx = path_map.max(axis=1, keepdims=True)
    ties = (path_map == mx).sum(axis=1)
    return ReadStats(
        names=names,
        path_map=path_map,
        counts25=counts25,
        most_prob_unique=ties == 1,
        most_prob_idx=path_map.argmax(axis=1),
    )


# ---------------------------------------------------------------------------
# base frequencies + HKY composites (`src/soibean.cpp:609-640`)
# ---------------------------------------------------------------------------
def load_base_freqs(path: str, dbprefix: str) -> Dict[str, float]:
    with open(path) as f:
        for line in f:
            t = line.split()
            if t and t[0] == dbprefix:
                a, c, g, tt = map(float, t[1:5])
                return make_freqs(a, c, g, tt)
    raise ValueError(f"no base frequencies for {dbprefix} in {path}")


def make_freqs(a: float, c: float, g: float, t: float) -> Dict[str, float]:
    f = {"A": a, "C": c, "G": g, "T": t}
    f["R"] = a + g
    f["Y"] = c + t
    f["M"] = 1.0 / (2.0 * (22.0 * a * g + 22.0 * c * t + (a * c + a * t + g * c + g * t)))
    return f


def signature_nodes(
    stats: ReadStats, path_names: List[str], tree_index: Dict[str, int],
    cutk: int = 0,
) -> Tuple[List[int], List[str]]:
    """Initial k estimate from unique-best-path read frequencies
    (`src/soibean.cpp:660-719`): paths that are the single best for at
    least 1% of reads, ordered by frequency."""
    freq: Dict[str, int] = {}
    for u, idx in zip(stats.most_prob_unique, stats.most_prob_idx):
        if u:
            name = path_names[int(idx)]
            freq[name] = freq.get(name, 0) + 1
    order = sorted(freq.items(), key=lambda kv: -kv[1])
    thres = len(stats.names) * 0.01
    nodes: List[int] = []
    paths: List[str] = []
    for name, count in order:
        if count >= thres and name in tree_index:
            nodes.append(tree_index[name])
            paths.append(name)
    if not nodes:
        for name, _count in order:
            if name in tree_index:
                nodes.append(tree_index[name])
                paths.append(name)
    if cutk > 0:
        nodes, paths = nodes[:cutk], paths[:cutk]
    return nodes, paths


def initial_log_like(stats: ReadStats, path_idxs: List[int]) -> float:
    """`src/soibean.cpp:750-776`: mean-field initial likelihood."""
    if len(path_idxs) == 1:
        return float(stats.path_map[:, path_idxs[0]].sum())
    freq = np.log(1.0 / len(path_idxs))
    sub = stats.path_map[:, path_idxs] + freq  # [R, k]
    mx = sub.max(axis=1, keepdims=True)
    return float((mx[:, 0] + np.log(np.exp(sub - mx).sum(axis=1))).sum())
