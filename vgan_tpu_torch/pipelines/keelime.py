# Copied from vgan_tpu/pipelines/keelime.py; imports repointed to this
# package, the two batched overlap scans routed through
# keelime_device.overlap_best_indexed on a sequence table and index arrays
# (the CUDA kernels on a card; its CPU route holds the native batch call that
# was overlap_best_batch_native here), the multihost branches dropped.
"""keelime: reference-guided hybrid assembly of a consensus genome.

Functional equivalent of the `assembly` class (`src/assembly.cpp`,
4,456 LoC): a damage-aware overlap-layout-consensus assembler over the
graph coordinate system. Full-parity rewrite of the simplified first
version: the overlap DAG (`GraphAss`, `src/assembly.h:78-126`), the
BFS contig builder (`mergeAllPaths`, `src/assembly.cpp:1102-1627`),
pairwise contig merging with mode-dependent majority rules
(`mergeContigs` `:1628-2363`, `tryMergeContigs` `:2372-3065`,
`mergeOverlappingContigs` `:3069-3345`), the final adjacent-merge pass
(`checkAndMergeContigs` `:3392-3552`), and the node-walk consensus
(`:4216-4450`) are all implemented with the reference's semantics.

Stages (reference `assembly::run`, `src/assembly.cpp:3560-4456`):
* GAM analysis (`:3837-3995`): keep mapped reads >25bp, operate on the
  *reconstructed* read string (gaps `-`, softclips `S`), reverse-
  complement minus-strand reads, per-base 5-state (ACGT-) post-damage
  probabilities (pre-damage off-base mass is q/4 over five states,
  INDELERRORPROB=1e-5), one-hot count rows, `cutbool` untrusted-end
  marker from >=3 bad graph chars.
* node depths by BFS from the clade start node
  (`reindex_odgi_graph`, `:123-161`); read ordering by depth
  (`compareByFirstNodeID`, `:236-296`); RYmer conversion of the first
  and last 5 bases only (`convertToRYmerSpace`, `:411-453`).
* density map of candidate pairs within a +10 depth window
  (`initial_overlap`, `:617-665`); overlap DAG with edges gated on
  end-node containment (`find_overlaps`, `:669-701`).
* BFS greedy contig build with subset absorption, the RY-gate (first/
  last 5 overlap bases RY-match, middle exact), and count-majority
  correction (`mergeAllPaths`).
* subset-contig removal (`isSubset`/`removeSubsetContigs`,
  SIMILARITY=0.98), pairwise merge to fixpoint, ordering along the
  reference path, final adjacent merge, consensus with N-bridging
  (`findMatch`), coverage mask and count-majority correction.

Documented quirks preserved (load-bearing for output parity):
* `get_overlap_length_and_score` never rejects on mismatch count (the
  break is commented out in the reference, `:555-559`); the score is
  sum(calculate_match_score) − sum(basesMatch penalties).
* `mergeAllPaths` calls the overlap scorer with min_overlap_length=1
  and uses `lenMin` (the -mL flag) as the minimum *score* (`:4043`,
  `:1217`); `find_overlaps` uses (lenMin, lenMin) for the scorer but
  gates edges on scoreMin (`:677`, `:688`).
* `checkAndMergeContigs` swaps the RY/plain sequence choice relative
  to everywhere else: deamination specified -> plain sequences,
  unspecified -> RYmer (`:3432-3437`).
* the >1-common-node-no-overlap branch of `tryMergeContigs`
  (`:2831-3047`) can never merge (its guard re-tests length 0 >=
  common>1) — implemented as a no-merge return.
* `cutbool` is decided from the pre-orientation graph string's first
  char while the bad-char counter runs over the oriented string
  (`:3898`, `:3983`).
* node-id lists concatenate *without* dedup in the N-bridge merge
  (`:3208-3209`) but dedup in all other merges.

Documented divergences (reference behavior is undefined or
nondeterministic there):
* the read-first branch of `mergeAllPaths` (`:1418-1419`) indexes the
  read's probability/count arrays out of bounds (C++ UB) whenever the
  contig tail is longer than the read; we implement the evident
  intent: merged = read + contig[olen:], prefix rows from the read,
  suffix rows from the contig.
* count-majority ties resolve in fixed "ACGT-" order (the reference
  iterates an unordered_map — unspecified order); all-zero count rows
  keep the original character instead of picking an arbitrary base.
* the merge-candidate list is processed in ascending contig order
  (reference: unordered_map iteration order).
"""
from __future__ import annotations

import gzip
import sys
from collections import deque
from dataclasses import dataclass, field
from functools import cmp_to_key
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..graph.packed import PackedGraph
from ..io.gam import Alignment
from ..models.damage import DamageModel
from ..models import phred

INDEL_ERROR_PROB = 1.0e-5  # src/assembly.cpp:27
SIMILARITY = 0.98  # src/assembly.cpp:28
MIN_READ_LEN = 25  # reads kept if len > 25, src/assembly.cpp:3846
BASES5 = "ACGT-"
_B5 = {c: i for i, c in enumerate(BASES5)}

# ----------------------------------------------------- char-pair tables
# calculate_match_score (src/assembly.cpp:455-486) minus the basesMatch
# mismatch penalty (src/assembly.cpp:323-386) in one 256x256 gather.
_ALPHABET = "ACGTRYNS-acgtry"


def _calc_match_score(a: str, b: str) -> float:
    if a == "-" and b == "-":
        return 1.0
    if a == "-" or b == "-":
        return 0.0
    if a == "N" or b == "N":
        return 0.0
    if a in "ACGT" and a == b:
        return 3.0
    if (a == "R" and b in "AG") or (b == "R" and a in "AG"):
        return 2.0
    if (a == "Y" and b in "CT") or (b == "Y" and a in "CT"):
        return 2.0
    if (a == "R" and b == "R") or (a == "Y" and b == "Y"):
        return 1.0
    if (a, b) in (("A", "G"), ("G", "A"), ("C", "T"), ("T", "C")):
        return -1.0
    return -3.0


def _bases_match(a: str, b: str) -> Tuple[bool, float]:
    """(matches, mismatch_penalty) per src/assembly.cpp:323-386."""
    if a == b:
        return True, 0.0
    if a == "-" or b == "-":
        return False, 0.0
    if a == "N" or b == "N":
        return False, 0.0
    au, bu = a.upper(), b.upper()
    if a in "Rr" and bu in ("A", "G", "R"):
        return True, 0.0
    if a in "Yy" and bu in ("C", "T", "Y"):
        return True, 0.0
    if a in "AaGg" and b in "Rr":
        return True, 0.0
    if a in "CcTt" and b in "Yy":
        return True, 0.0
    if (au, bu) in (("C", "T"), ("G", "A"), ("T", "C"), ("A", "G")) and (
        a.isupper() == b.isupper()
    ):
        return False, 0.5
    return False, 3.0


def _build_tables():
    comb = np.zeros((256, 256), dtype=np.float64)
    rym = np.zeros((256, 256), dtype=bool)
    dmg = np.zeros((256, 256), dtype=bool)
    rs, ys = "AGag", "CTct"
    for a in _ALPHABET:
        for b in _ALPHABET:
            m, pen = _bases_match(a, b)
            comb[ord(a), ord(b)] = _calc_match_score(a, b) - (
                0.0 if m else pen
            )
            # isRYMatch (src/assembly.cpp:390-408): same char, same
            # purine/pyrimidine class, or either is '-'
            rym[ord(a), ord(b)] = (
                a == b
                or (a in rs and b in rs)
                or (a in ys and b in ys)
                or a == "-"
                or b == "-"
            )
            # basesMatchWithDamage (src/assembly.cpp:2364-2370)
            dmg[ord(a), ord(b)] = a == b or (a + b) in (
                "CT", "TC", "GA", "AG"
            )
    return comb, rym, dmg


_COMBINED, _RYMATCH, _DMGMATCH = _build_tables()


def _enc(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("latin-1"), dtype=np.uint8)


# ----------------------------------------------------------- GAM stage
@dataclass
class Frag:
    """One usable read (reference `frags`, src/assembly.h:26-47)."""

    name: str
    seq: str  # oriented reconstructed read string (may contain -, S, N)
    graph_seq: str
    node_ids: List[int]
    offsets: List[int]
    coverage: List[int]
    probs: np.ndarray  # [L,5] post-damage state probabilities (ACGT-)
    counts: np.ndarray  # [L,5] one-hot counts
    cut: Tuple[bool, int]
    ry: str = ""


_RC = {"A": "T", "T": "A", "C": "G", "G": "C", "S": "S", "-": "-", "N": "N"}


def _revcomp_str(s: str) -> str:
    return "".join(_RC.get(c, "N") for c in reversed(s))


def analyse_gam_table(
    graph: PackedGraph,
    table,
    damage: Optional[DamageModel] = None,
) -> List[Frag]:
    """Columnar twin of analyse_gam: C++ batch reconstruction + the
    whole per-base probs/counts computation as padded [B, Lmax] array
    passes (the per-read-per-base Python loop below is the oracle,
    parity-tested in tests/test_keelime.py). Falls back to the loop
    when the reconstruction contains rare IUPAC graph chars (the code
    alphabet collapses them, the string path preserves them).

    Returns the same Frag list (src/assembly.cpp:3837-3995)."""
    from ..mapper.batch_map import AlignmentTable  # noqa: F401
    from ..utils import dna
    from .hc_columnar import reconstruct_table

    dm = damage or DamageModel.none()
    qtab = phred.qscore_vec()
    seq_lens = np.array([len(s) for s in table.seqs], dtype=np.int64)
    keep = (
        (table.identity != 0) & (table.nmap > 0)
        & (seq_lens > MIN_READ_LEN)
    )
    t = table.select(keep)
    B = t.n
    if B == 0:
        return []
    g_cat, g_off, g_len, r_cat, r_off, r_len, _sz, _so, _sl = (
        reconstruct_table(graph, t)
    )
    if (g_cat[: int(g_off[-1])] == dna.RARE).any() or (
        r_cat[: int(r_off[-1])] == dna.RARE
    ).any():
        return analyse_gam(graph, t.to_alignments(), damage=damage)

    isrev = t.m_rev[t.map_off[:-1]].astype(bool)
    L = r_len.astype(np.int64)
    Lmax = max(int(L.max()), 1)
    col = np.arange(Lmax, dtype=np.int64)
    valid = col[None, :] < L[:, None]
    # oriented code matrices: reverse reads read back-to-front with the
    # string-path complement (rare -> N, matching _revcomp_str's
    # .get(c, "N") default)
    idx = np.where(isrev[:, None], L[:, None] - 1 - col[None, :],
                   col[None, :])
    np.clip(idx, 0, None, out=idx)
    comp_rc = np.array(
        [dna.T, dna.G, dna.C, dna.A, dna.N, dna.GAP, dna.SOFTCLIP,
         dna.N],
        dtype=np.uint8,
    )
    rpos = np.clip(r_off[:-1][:, None] + idx, 0, max(len(r_cat) - 1, 0))
    gpos = np.clip(g_off[:-1][:, None] + idx, 0, max(len(g_cat) - 1, 0))
    rcodes = r_cat[rpos]
    gcodes = g_cat[gpos]
    rcodes = np.where(isrev[:, None], comp_rc[rcodes], rcodes)
    gcodes = np.where(isrev[:, None], comp_rc[gcodes], gcodes)

    # oriented per-base quality: qual[:L] zero-padded, reversed if rev
    qb_cat = np.frombuffer(b"".join(t.quals), dtype=np.uint8)
    qb_len = np.fromiter((len(q) for q in t.quals), dtype=np.int64,
                         count=B)
    qb_off = np.zeros(B + 1, dtype=np.int64)
    np.cumsum(qb_len, out=qb_off[1:])
    in_q = (idx < qb_len[:, None]) & valid
    qidx = np.where(in_q, qb_off[:-1][:, None] + idx, 0)
    baseq = (
        np.where(in_q, qb_cat[qidx], 0)
        if len(qb_cat)
        else np.zeros((B, Lmax), dtype=np.uint8)
    )

    # per-base classification (src/assembly.cpp:3907-3960)
    is_ns = (rcodes == dna.N) | (rcodes == dna.SOFTCLIP)
    is_gap = ~is_ns & (rcodes == dna.GAP)
    is_base = ~is_ns & ~is_gap & valid
    b4 = np.minimum(rcodes, 3).astype(np.int64)

    q = qtab[np.minimum(baseq.astype(np.int64), len(qtab) - 1)]
    # pre: q/4 everywhere, 1-q at the called base (5-state)
    pre4 = np.full((B, Lmax, 4), 0.0)
    pre4[...] = (q / 4.0)[..., None]
    np.put_along_axis(pre4, b4[..., None], (1.0 - q)[..., None], axis=2)
    pre_sum = q / 4.0 * 5.0 + (1.0 - q) - q / 4.0  # sum of the 5-vector

    # damage matrices D[b, l] = subDeamDiNuc[Lc][min(s, Lc-1)]
    # (combineDeamRates row select, src/damage.cpp:18-36)
    from ..models.damage import MAXLENGTHFRAGMENT

    Lc = np.clip(L, 1, 1000)
    lpos = np.minimum(col[None, :], (Lc - 1)[:, None])
    l5 = np.clip(lpos, 0, MAXLENGTHFRAGMENT - 1)
    l3 = np.clip(Lc[:, None] - lpos - 1, 0, MAXLENGTHFRAGMENT - 1)
    f5 = dm.sub5p[l5]  # [B, L, 4, 4]
    f3 = dm.sub3p[l3]
    d5 = np.einsum("...ii->...i", f5)
    d3 = np.einsum("...ii->...i", f3)
    D = np.where((d5 <= d3)[..., None], f5, f3)

    probs = np.zeros((B, Lmax, 5), dtype=np.float64)
    probs[..., :4] = np.einsum("blo,blod->bld", pre4, D)
    probs[..., 4] = pre_sum * INDEL_ERROR_PROB
    sub = np.zeros((B, Lmax, 5), dtype=np.float64)
    np.put_along_axis(sub, b4[..., None], INDEL_ERROR_PROB, axis=2)
    probs -= sub
    # specials overwrite the base-case rows
    probs = np.where(is_ns[..., None], 0.20, probs)
    gap_row = np.concatenate(
        [np.full(4, INDEL_ERROR_PROB / 4), [1.0 - INDEL_ERROR_PROB]]
    )
    probs = np.where(is_gap[..., None], gap_row, probs)
    probs = np.where(valid[..., None], probs, 0.0)

    counts = np.zeros((B, Lmax, 5), dtype=np.int64)
    np.put_along_axis(counts, b4[..., None], 1, axis=2)
    counts = np.where(is_base[..., None], counts, 0)
    gapc = np.zeros(5, dtype=np.int64)
    gapc[4] = 1
    counts = np.where(is_gap[..., None], gapc, counts)

    # cutbool: >= 3 oriented-graph "-NS" chars; direction from the
    # PRE-orientation graph string's first char (src/assembly.cpp:3983)
    g_ns = valid & (
        (gcodes == dna.GAP) | (gcodes == dna.N)
        | (gcodes == dna.SOFTCLIP)
    )
    n_bad = g_ns.sum(axis=1)
    first_g = g_cat[np.minimum(g_off[:-1], max(len(g_cat) - 1, 0))]
    cut_dir = np.where(first_g == dna.GAP, 1, 2)

    # per-mapping node/offset/coverage columns
    e_from_cum = np.zeros(len(t.e_from) + 1, dtype=np.int64)
    np.cumsum(t.e_from, out=e_from_cum[1:])
    cov_m = e_from_cum[t.e_off[1:]] - e_from_cum[t.e_off[:-1]]

    cd = dna._CODE2CHAR
    frags: List[Frag] = []
    for i in range(B):
        li = int(L[i])
        seq = cd[rcodes[i, :li]].tobytes().decode()
        gseq = cd[gcodes[i, :li]].tobytes().decode()
        m0, m1 = int(t.map_off[i]), int(t.map_off[i + 1])
        node_ids = t.m_node[m0:m1].tolist()
        offsets = t.m_off[m0:m1].astype(np.int64).tolist()
        cov = cov_m[m0:m1].astype(np.int64).tolist()
        if isrev[i]:
            node_ids.reverse()
            offsets.reverse()
            cov.reverse()
        cut = (
            (True, int(cut_dir[i])) if n_bad[i] >= 3 else (False, 0)
        )
        frags.append(
            Frag(t.names[i], seq, gseq, node_ids, offsets, cov,
                 probs[i, :li].copy(), counts[i, :li].copy(), cut)
        )
    return frags


def analyse_gam(
    graph: PackedGraph,
    alignments: Sequence[Alignment],
    damage: Optional[DamageModel] = None,
) -> List[Frag]:
    """GAM loop (src/assembly.cpp:3837-3995)."""
    from ..graph.reconstruct import reconstruct_graph_sequence

    dm = damage or DamageModel.none()
    qtab = phred.qscore_vec()
    frags: List[Frag] = []
    for a in alignments:
        if a.identity == 0 or not a.path.mappings:
            continue
        if len(a.sequence) <= MIN_READ_LEN:
            continue
        graph_seq0, read_seq0, _ = reconstruct_graph_sequence(
            graph, a.path, a.sequence
        )
        node_ids, offsets, coverage = [], [], []
        for m in a.path.mappings:
            node_ids.append(int(m.position.node_id))
            offsets.append(int(m.position.offset))
            coverage.append(sum(e.from_length for e in m.edits))
        isrev = a.path.mappings[0].position.is_reverse
        if isrev:
            node_ids.reverse()
            offsets.reverse()
            coverage.reverse()
            seq = _revcomp_str(read_seq0)
            gseq = _revcomp_str(graph_seq0)
        else:
            seq, gseq = read_seq0, graph_seq0
        L = len(seq)
        qual = np.frombuffer(a.quality, dtype=np.uint8)
        if len(qual) < L:  # reconstructed string can be longer (gaps)
            qual = np.concatenate([qual, np.zeros(L - len(qual), np.uint8)])
        baseq = qual[:L][::-1].copy() if isrev else qual[:L].copy()

        probs = np.zeros((L, 5), dtype=np.float64)
        counts = np.zeros((L, 5), dtype=np.int64)
        n_bad = 0
        Lc = min(max(L, 1), 1000)
        for s in range(L):
            c = seq[s]
            if gseq[s] in "-NS":
                n_bad += 1
            if c in "NS":
                probs[s] = 0.20
            elif c == "-":
                probs[s, :4] = INDEL_ERROR_PROB / 4
                probs[s, 4] = 1.0 - INDEL_ERROR_PROB
                counts[s, 4] = 1
            else:
                q = qtab[min(int(baseq[s]), len(qtab) - 1)]
                pre = np.full(5, q / 4.0)
                bi = _B5[c]
                pre[bi] = 1.0 - q
                counts[s, bi] = 1
                D = dm.dinuc(Lc, min(s, Lc - 1))
                probs[s, :4] = pre[:4] @ D
                probs[s, 4] = pre.sum() * INDEL_ERROR_PROB
                probs[s, bi] -= INDEL_ERROR_PROB
        # cutbool decided from the PRE-orientation graph string's first
        # char (src/assembly.cpp:3983 uses graph_seq, not graphSeq)
        cut = (False, 0)
        if n_bad >= 3:
            cut = (True, 1 if graph_seq0[0] == "-" else 2)
        frags.append(
            Frag(a.name, seq, gseq, node_ids, offsets, coverage, probs,
                 counts, cut)
        )
    return frags


# ------------------------------------------------- depth + order stage
def node_depths(
    graph: PackedGraph, start_id: int, end_id: int, max_steps: int = 2_000_000
) -> Dict[int, int]:
    """BFS depth map from the start node (reindex_odgi_graph,
    src/assembly.cpp:123-161): per-node max depth encountered."""
    fwd, _ = graph.oriented_adjacency()
    depths: Dict[int, int] = {}
    visited: Dict[Tuple[int, bool], int] = {}
    start = (start_id - graph.min_id, False)
    q = deque([(start, 1)])
    visited[start] = 1
    steps = 0
    while q and steps < max_steps:
        h, d = q.popleft()
        steps += 1
        nid = h[0] + graph.min_id
        if depths.get(nid, 0) < d:
            depths[nid] = d
        if nid == end_id and not h[1]:
            break
        for nxt in fwd.get(h, ()):  # forward edges only, as reference
            if visited.get(nxt, 0) < d + 1:
                visited[nxt] = d + 1
                q.append((nxt, d + 1))
    return depths


def sort_frags(frags: List[Frag], depths: Dict[int, int]) -> List[Frag]:
    """compareByFirstNodeID (src/assembly.cpp:236-296), stable."""

    def cmp(a: Frag, b: Frag) -> int:
        da = depths.get(a.node_ids[0], 0) if a.node_ids else 0
        db = depths.get(b.node_ids[0], 0) if b.node_ids else 0
        if da != db:
            return -1 if da < db else 1
        if not a.node_ids or not b.node_ids:
            if not b.node_ids and a.node_ids:
                return -1
            return 1 if (not a.node_ids and b.node_ids) else 0
        if a.node_ids[0] != b.node_ids[0]:
            return -1 if a.node_ids[0] < b.node_ids[0] else 1
        if not a.offsets or not b.offsets:
            if not b.offsets and a.offsets:
                return -1
            return 1 if (not a.offsets and b.offsets) else 0
        if a.offsets[0] != b.offsets[0]:
            return -1 if a.offsets[0] < b.offsets[0] else 1
        if a.cut[0] != b.cut[0]:
            return -1 if a.cut[0] > b.cut[0] else 1
        for x, y in zip(a.node_ids, b.node_ids):
            if x != y:
                return -1 if x < y else 1
        if len(a.node_ids) != len(b.node_ids):
            return -1 if len(a.node_ids) < len(b.node_ids) else 1
        if len(a.seq) != len(b.seq):
            return -1 if len(a.seq) > len(b.seq) else 1
        return 0

    return sorted(frags, key=cmp_to_key(cmp))


def to_rymer(seq: str) -> str:
    """First/last 5 bases -> R/Y; reads <10bp unconverted
    (convertToRYmerSpace, src/assembly.cpp:411-453)."""
    if len(seq) < 10:
        return seq
    out = []
    for i, c in enumerate(seq):
        if i < 5 or i >= len(seq) - 5:
            if c in "aAgG":
                out.append("R")
            elif c in "cCtT":
                out.append("Y")
            else:
                out.append(c)
        else:
            out.append(c)
    return "".join(out)


# --------------------------------------------------- overlap machinery
_COMBINED2_I16 = None  # lazily built int16 table (= _COMBINED * 2)
_OVB_READY = False


def _ovb_lib():
    """Native lib with the overlap_best entry points prepared."""
    global _COMBINED2_I16, _OVB_READY
    from ..mapper.batch_map import load_native

    lib = load_native()
    if not _OVB_READY:
        import ctypes

        u8p = ctypes.POINTER(ctypes.c_uint8)
        i16p = ctypes.POINTER(ctypes.c_int16)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.overlap_best.restype = ctypes.c_int64
        lib.overlap_best.argtypes = [
            u8p, ctypes.c_int64, u8p, ctypes.c_int64, i16p,
            ctypes.c_int64, ctypes.c_double, f64p,
        ]
        lib.overlap_best_batch.restype = None
        lib.overlap_best_batch.argtypes = [
            u8p, i64p, u8p, i64p, ctypes.c_int64, i16p,
            ctypes.c_int64, ctypes.c_double, i64p, f64p,
            ctypes.c_int32,
        ]
        t2 = _COMBINED * 2.0
        assert np.all(t2 == np.round(t2))
        _COMBINED2_I16 = np.ascontiguousarray(
            t2.astype(np.int16).reshape(-1)
        )
        _OVB_READY = True
    return lib


_TAB_PTR = None  # cached ctypes pointer to _COMBINED2_I16


def _overlap_best_native_arr(aa: np.ndarray, bb: np.ndarray,
                             min_olen: int, min_score: float, lib):
    """overlap_best on pre-encoded byte arrays (hot-loop variant)."""
    global _TAB_PTR
    import ctypes

    if _TAB_PTR is None:
        _TAB_PTR = _COMBINED2_I16.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int16)
        )
    sc = ctypes.c_double(0.0)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.overlap_best(
        aa.ctypes.data_as(u8p), len(aa),
        bb.ctypes.data_as(u8p), len(bb),
        _TAB_PTR,
        min_olen, float(min_score), ctypes.byref(sc),
    )
    return int(n), float(sc.value)


def overlap_score(
    a: str, b: str, min_olen: int, min_score: float
) -> Tuple[int, float]:
    """get_overlap_length_and_score (src/assembly.cpp:523-610): slide b
    along a from every start; overlap = min(len(b), len(a)-start);
    best by (length, then score) among candidates with score >=
    min_score and length >= min_olen.  Runs the native scan
    (cpp/overlapbest.cpp, bit-identical); the numpy sliding-window pass
    below is its parity oracle in the tests.  Scores are multiples of
    0.5, so the int32 accumulation is bit-identical to the numpy f64
    sums."""
    return _overlap_best_native_arr(_enc(a), _enc(b), min_olen,
                                    min_score, _ovb_lib())


def _overlap_score_numpy(
    a: str, b: str, min_olen: int, min_score: float
) -> Tuple[int, float]:
    la, lb = len(a), len(b)
    if la < min_olen or lb == 0:
        return 0, 0.0
    aa, bb = _enc(a), _enc(b)
    best_len, best_score = 0, 0.0
    # full-length block: starts where olen == lb (vectorized)
    n_full = la - lb + 1
    if n_full > 0 and lb >= min_olen:
        step = max(1, min(n_full, (1 << 22) // max(lb, 1)))
        for s0 in range(0, n_full, step):
            s1 = min(n_full, s0 + step)
            w = np.lib.stride_tricks.sliding_window_view(
                aa[s0 : s1 + lb - 1], lb
            )
            sc = _COMBINED[w, bb].sum(axis=1)
            ok = sc >= min_score
            if ok.any():
                smax = sc[ok].max()
                if lb > best_len or (lb == best_len and smax > best_score):
                    best_len, best_score = lb, float(smax)
    # tail block: olen shrinks below lb. Tail olens are distinct
    # (olen = la - start), so the per-start scan collapses to "largest
    # qualifying olen" — one masked sliding-window pass per chunk.
    t0 = max(0, n_full)
    hi = la - min_olen + 1
    if t0 < hi:
        starts = np.arange(t0, hi, dtype=np.int64)
        olens = la - starts
        keep = olens < lb
        starts, olens = starts[keep], olens[keep]
        if len(starts):
            Lb = int(olens.max())
            pad_a = np.concatenate(
                [aa, np.zeros(Lb, dtype=aa.dtype)]
            )
            col = np.arange(Lb, dtype=np.int64)
            step = max(1, min(len(starts), (1 << 22) // max(Lb, 1)))
            for s0 in range(0, len(starts), step):
                s1 = min(len(starts), s0 + step)
                st = starts[s0:s1]
                ol = olens[s0:s1]
                w = np.lib.stride_tricks.sliding_window_view(
                    pad_a[st[0] : st[-1] + Lb], Lb
                )
                scm = _COMBINED[w, bb[:Lb]]
                mask = col[None, :] < ol[:, None]
                sc = (scm * mask).sum(axis=1)
                ok = (sc >= min_score) & (ol >= min_olen)
                if ok.any():
                    i = int(np.flatnonzero(ok)[0])  # largest olen first
                    if ol[i] > best_len or (
                        ol[i] == best_len and sc[i] > best_score
                    ):
                        best_len, best_score = int(ol[i]), float(sc[i])
                    break  # later chunks only have smaller olens
    return best_len, best_score


def _match_count_windows(
    hay: np.ndarray, needle: np.ndarray, allowed: int
) -> np.ndarray:
    """For each start in hay: RY-match count before the (allowed+1)-th
    mismatch (isSubset / findAlignmentPosition inner loop,
    src/assembly.cpp:1036-1097)."""
    la = len(needle)
    n = len(hay) - la + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int64)
    out = np.zeros(n, dtype=np.int64)
    step = max(1, min(n, (1 << 22) // max(la, 1)))
    for s0 in range(0, n, step):
        s1 = min(n, s0 + step)
        w = np.lib.stride_tricks.sliding_window_view(
            hay[s0 : s1 + la - 1], la
        )
        m = _RYMATCH[w, needle]
        nm = (~m).cumsum(axis=1)
        full = m.sum(axis=1)
        capped = (m & (nm <= allowed)).sum(axis=1)
        total_mm = la - full
        out[s0:s1] = np.where(total_mm <= allowed, full, capped)
    return out


_RYMATCH_U8 = None


def _window_first_hit(hay: np.ndarray, needle: np.ndarray,
                      allowed: int, thresh: int) -> int:
    """First window start whose effective RY-match count reaches
    thresh, -1 if none. Native early-exit scan (cpp/matchwin.cpp); the
    numpy sliding-matrix pass _match_count_windows is its oracle in the
    tests — the counts are its semantics exactly."""
    global _RYMATCH_U8
    from ..mapper.batch_map import load_native

    lib = load_native()
    import ctypes

    if not getattr(lib, "_matchwin_ready", False):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.ry_window_hits.restype = ctypes.c_int64
        lib.ry_window_hits.argtypes = [
            u8p, ctypes.c_int64, u8p, ctypes.c_int64, u8p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            i64p, ctypes.c_int64,
        ]
        lib._matchwin_ready = True
    if _RYMATCH_U8 is None:
        _RYMATCH_U8 = np.ascontiguousarray(
            _RYMATCH.astype(np.uint8).reshape(-1)
        )
    hay = np.ascontiguousarray(hay, dtype=np.uint8)
    needle = np.ascontiguousarray(needle, dtype=np.uint8)
    out = np.zeros(1, dtype=np.int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    n = lib.ry_window_hits(
        hay.ctypes.data_as(u8p), len(hay),
        needle.ctypes.data_as(u8p), len(needle),
        _RYMATCH_U8.ctypes.data_as(u8p),
        allowed, max(thresh, 0), 1,
        out.ctypes.data_as(i64p), 1,
    )
    return int(out[0]) if n > 0 else -1


def is_subset(
    a_seq: str, a_ids: Sequence[int], b_seq: str, b_ids,
    allowed: int = 1, b_enc: "Optional[np.ndarray]" = None,
    a_enc: "Optional[np.ndarray]" = None,
) -> bool:
    """isSubset (src/assembly.cpp:1063-1097).  b_ids may be any
    container supporting `in` (pass a set/dict on hot paths); b_enc /
    a_enc skip re-encoding when the caller caches the byte arrays."""
    if len(a_seq) > len(b_seq):
        return False
    bset = b_ids if isinstance(b_ids, (set, frozenset, dict)) else set(b_ids)
    if a_ids and all(i in bset for i in a_ids):
        return True
    thresh = int(SIMILARITY * len(a_seq))
    return _window_first_hit(
        _enc(b_seq) if b_enc is None else b_enc,
        _enc(a_seq) if a_enc is None else a_enc,
        allowed, thresh,
    ) >= 0


def find_alignment_position(contig: str, read: str, allowed: int) -> int:
    """findAlignmentPosition (src/assembly.cpp:1036-1058); -1 if none."""
    if len(read) > len(contig):
        return -1
    thresh = int(SIMILARITY * len(read))
    return _window_first_hit(_enc(contig), _enc(read), allowed, thresh)


def find_match(contig: str, node_seq: str, from_start: bool) -> int:
    """findMatch lambda (src/assembly.cpp:4227-4250 / :2768-2791):
    damage-tolerant prefix/suffix agreement length."""
    mml = min(len(contig), len(node_seq))
    n = 0
    for i in range(mml):
        if from_start:
            ca, cb = contig[i], node_seq[len(node_seq) - mml + i]
        else:
            ca, cb = contig[len(contig) - mml + i], node_seq[i]
        if not _DMGMATCH[ord(ca), ord(cb)]:
            break
        n += 1
    return n


# ------------------------------------------------------- overlap graph
def initial_overlap(
    frags: List[Frag], depths: Dict[int, int]
) -> Tuple[Tuple[np.ndarray, np.ndarray], int]:
    """Candidate pairs (initial_overlap, src/assembly.cpp:617-665):
    frag i pairs with every frag whose first-node depth lies in
    [nd_i, nd_i + 10]. Returned as flat (pi, pj) arrays via
    sort + searchsorted — the former per-frag boolean mask was O(n^2)
    in the read count (minutes at 100k reads) for the identical pair
    SET, and pair order does not affect the overlap DAG (edge inserts
    are idempotent and neighbor traversal sorts by score)."""
    n = len(frags)
    nd = np.array(
        [depths.get(f.node_ids[0], -1) if f.node_ids else -1 for f in frags],
        dtype=np.int64,
    )
    known_idx = np.flatnonzero(nd != -1)
    if len(known_idx) == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64)), 1
    order = known_idx[np.argsort(nd[known_idx], kind="stable")]
    snd = nd[order]
    lo = np.searchsorted(snd, nd[known_idx], side="left")
    hi = np.searchsorted(snd, nd[known_idx] + 10, side="right")
    counts = hi - lo
    total = int(counts.sum())
    # flat slice gather: pj = order[lo_i + k] for k in 0..counts_i
    starts = np.zeros(len(known_idx), dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    flat = np.arange(total, dtype=np.int64) \
        - np.repeat(starts, counts) + np.repeat(lo, counts)
    pi = np.repeat(known_idx, counts)
    pj = order[flat]
    keep = pi != pj  # drop self-pairs
    pi, pj = pi[keep], pj[keep]
    # restore the former (i ascending, j ascending) emission order: the
    # overlap DAG's adjacency INSERTION order is a live tie-breaker in
    # merge_all_paths' score-sorted neighbor traversal (stable sort),
    # and equal scores are common (content-interned duplicates) — the
    # pair SET alone is not enough for output parity
    o = np.lexsort((pj, pi))
    pi, pj = pi[o], pj[o]
    inc = len(pi)
    if inc == 0:
        inc = 1
    return (pi, pj), inc // max(n, 1)


class GraphAss:
    """Overlap DAG (src/assembly.h:78-126)."""

    def __init__(self, n: int):
        self.adj: List[Dict[int, float]] = [dict() for _ in range(n)]
        self.in_degree = [0] * n

    def add_edge(self, u: int, v: int, s: float) -> None:
        if v not in self.adj[u]:
            self.adj[u][v] = s
            self.in_degree[v] += 1


def find_overlaps(
    frags: List[Frag],
    min_olen: int,
    min_score: float,
    pairs: Tuple[np.ndarray, np.ndarray],
    specified_deam: bool,
    len_min: float,
    *,
    device,
) -> Tuple[GraphAss, Dict[Tuple[int, int], Tuple[int, float]]]:
    """find_overlaps (src/assembly.cpp:669-701): edges require both the
    score gate and end-node containment in the partner's node list.
    `pairs` is initial_overlap's flat (pi, pj) candidate arrays. All
    distinct candidate pairs score in one batch on `device`
    (keelime_device.overlap_best_indexed over the interned contents: the
    CUDA kernels on a card, the threaded native scan on the CPU) with
    identical results."""
    import torch

    from .keelime_device import (L_WARP, count_long, intern, longest_of,
                                 overlap_best_indexed)

    n_frags = len(frags)
    g = GraphAss(n_frags)
    overlap_map: Dict[Tuple[int, int], Tuple[int, float]] = {}

    def seq(i: int) -> str:
        return frags[i].ry if specified_deam else frags[i].seq

    # intern fragment content once: reads at the same position repeat,
    # so pair dedup works on small int ids instead of long strings
    content_id = np.zeros(n_frags, dtype=np.int64)
    cmap: Dict[str, int] = {}
    contents: List[str] = []
    for i in range(n_frags):
        s = seq(i)
        cid = cmap.get(s)
        if cid is None:
            cid = len(contents)
            cmap[s] = cid
            contents.append(s)
        content_id[i] = cid
    C = len(contents)

    pi, pj = pairs
    # distinct (content_i, content_j) in both orientations
    ci = content_id[pi]
    cj = content_id[pj]
    keys = np.unique(
        np.concatenate([ci * C + cj, cj * C + ci])
    )
    dev = torch.device(device)
    table = intern(contents)
    ai = (keys // C).astype(np.int32)
    longest = longest_of(table[1])
    res_len, res_sc = (t.cpu().numpy() for t in overlap_best_indexed(
        *(torch.from_numpy(x).to(dev) for x in table),
        torch.from_numpy(ai).to(dev),
        torch.from_numpy((keys % C).astype(np.int32)).to(dev),
        min_olen, len_min, longest,
        count_long(table[1], ai) if longest > L_WARP else 0))
    k1 = np.searchsorted(keys, ci * C + cj)
    k2 = np.searchsorted(keys, cj * C + ci)
    l1, s1 = res_len[k1], res_sc[k1]
    l2, s2 = res_len[k2], res_sc[k2]
    pass1 = (l1 >= min_olen) & (s1 >= min_score)
    pass2 = (l2 >= min_olen) & (s2 >= min_score)
    any_pass = np.flatnonzero(pass1 | pass2)

    id_sets = [None] * n_frags
    for t in any_pass:
        i = int(pi[t])
        j = int(pj[t])
        if id_sets[i] is None:
            id_sets[i] = frozenset(frags[i].node_ids)
        if id_sets[j] is None:
            id_sets[j] = frozenset(frags[j].node_ids)
        if pass1[t] and frags[i].node_ids[-1] in id_sets[j]:
            g.add_edge(i, j, float(s1[t]))
            overlap_map[(i, j)] = (int(l1[t]), float(s1[t]))
        if pass2[t] and frags[j].node_ids[-1] in id_sets[i]:
            g.add_edge(j, i, float(s2[t]))
            overlap_map[(j, i)] = (int(l2[t]), float(s2[t]))
    return g, overlap_map


# -------------------------------------------------------------- contigs
@dataclass
class Contig:
    seq: str
    ry: str
    scoring: np.ndarray  # [L,5] log-probabilities
    counts: np.ndarray  # [L,5] int
    node_ids: List[int]
    cut: Tuple[bool, int]
    empty: np.ndarray = field(default=None)  # [L] bool: N-bridge rows

    def __post_init__(self):
        if self.empty is None:
            self.empty = np.zeros(len(self.seq), dtype=bool)


def _contig_from_frag(f: Frag) -> Contig:
    with np.errstate(divide="ignore"):
        scoring = np.log(f.probs)
    return Contig(f.seq, f.ry, scoring, f.counts.copy(),
                  list(f.node_ids), f.cut)


def _merge_cut(base: Tuple[bool, int], other: Tuple[bool, int]):
    """adjustFinalCut (src/assembly.cpp:1009-1034); returns the merged
    cut, or None where the reference `continue`s out of the merge
    (the N-bridge not-at-end variant, :3293-3298)."""
    if other == base:
        return base
    if not base[0]:
        if other[1] in (2, 3):
            return other
        return base
    if not other[0]:
        if base[1] == 2:
            return (False, 0)
        if base[1] == 3:
            return (True, 1)
        return base
    if base[1] != other[1]:
        if (base[1] == 1 and other[1] in (2, 3)) or (
            base[1] == 3 and other[1] == 1
        ):
            return (True, 3)
        if base[1] == 2 and other[1] == 1:
            return (False, 0)
        if base[1] == 3 and other[1] == 1:
            return (True, 1)
    return base


def _ry_gate(tail: str, head: str, olen: int) -> bool:
    """Overlap acceptance gate in mergeAllPaths (src/assembly.cpp:
    1384-1401): first/last 5 overlap bases RY-match, middle exact."""
    for i in range(olen):
        a, b = tail[len(tail) - olen + i], head[i]
        if i < 5 or i >= olen - 5:
            if not _RYMATCH[ord(a), ord(b)]:
                return False
        elif a != b:
            return False
    return True


def _majority_correct(seq: str, counts: np.ndarray) -> str:
    """Count-majority correction (src/assembly.cpp:1527-1557): replace
    a base not among the max-count bases. All-zero rows keep the
    original char (divergence: reference picks unordered_map-first)."""
    out = list(seq)
    mx = counts.max(axis=1)
    for i in range(len(out)):
        if mx[i] <= 0:
            continue
        maxbases = {BASES5[k] for k in np.flatnonzero(counts[i] == mx[i])}
        if out[i] not in maxbases:
            out[i] = BASES5[int(np.argmax(counts[i]))]
    return "".join(out)


def merge_all_paths(
    g: GraphAss,
    overlap_map: Dict[Tuple[int, int], Tuple[int, float]],
    frags: List[Frag],
    specified_deam: bool,
    len_min: float,
) -> List[Contig]:
    """mergeAllPaths (src/assembly.cpp:1102-1565): BFS greedy contig
    construction over the overlap DAG."""
    contigs: List[Contig] = []
    visited = set()
    # pre-encode every fragment once; the contig's encoding refreshes
    # only when it changes (native overlap/subset scans take arrays)
    _lib = _ovb_lib()
    f_seq_enc = [_enc(f.seq) for f in frags]
    f_ry_enc = [_enc(f.ry) for f in frags] if specified_deam else None
    for start in range(len(g.adj)):
        if start in visited:
            continue
        f0 = frags[start]
        contig = f0.seq
        ry = f0.ry
        contig_enc = _enc(contig)
        ry_enc = _enc(ry) if specified_deam else None
        # scoring/counts live in capacity-doubling buffers ([:cur] is
        # the live region) so each merge appends amortized O(merged
        # bases), not O(contig) reallocation; node_ids keeps a
        # first-index map so common-node lookups cost O(|read ids|)
        cur = len(f0.seq)
        cap = max(256, 4 * cur)
        sc_buf = np.zeros((cap, 5))
        ct_buf = np.zeros((cap, 5), np.int64)
        with np.errstate(divide="ignore"):
            sc_buf[:cur] = np.log(f0.probs)
        ct_buf[:cur] = f0.counts
        node_ids = list(f0.node_ids)
        # first-occurrence index per id (list.index semantics — a read
        # can visit a node twice)
        idx_of = {}
        for kk, nid in enumerate(node_ids):
            idx_of.setdefault(nid, kk)

        def _ensure(n):
            nonlocal cap, sc_buf, ct_buf
            if n <= cap:
                return
            cap = max(2 * cap, n)
            ns = np.zeros((cap, 5))
            nc = np.zeros((cap, 5), np.int64)
            ns[:cur] = sc_buf[:cur]
            nc[:cur] = ct_buf[:cur]
            sc_buf, ct_buf = ns, nc

        def _extend_ids(ids):
            for i in ids:
                if i not in idx_of:
                    idx_of[i] = len(node_ids)
                    node_ids.append(i)

        finalcut = f0.cut
        q = deque([start])
        visited.add(start)
        while q:
            v = q.popleft()
            neighbors = sorted(
                g.adj[v].keys(), key=lambda t: -overlap_map[(v, t)][1]
            )
            for nb in neighbors:
                if nb in visited:
                    continue
                fn = frags[nb]
                cand_ids = [i for i in fn.node_ids if i in idx_of]
                if not cand_ids:
                    continue
                # first common id in node_ids order
                first_common = min(cand_ids, key=lambda i: idx_of[i])
                pos_i = idx_of[first_common]
                pos_j = fn.node_ids.index(first_common)

                # one data-dependent pair a BFS step: the host's
                # native scan on every device
                ca, cb = (
                    (ry_enc, f_ry_enc[nb]) if specified_deam
                    else (contig_enc, f_seq_enc[nb])
                )
                bo = _overlap_best_native_arr(ca, cb, 1, len_min, _lib)
                bo2 = _overlap_best_native_arr(cb, ca, 1, len_min, _lib)

                # subset absorption (src/assembly.cpp:1232-1344)
                nb_sub = is_subset(fn.seq, fn.node_ids, contig, idx_of,
                                   0, b_enc=contig_enc,
                                   a_enc=f_seq_enc[nb])
                ct_sub = is_subset(contig, node_ids, fn.seq,
                                   fn.node_ids, 0, b_enc=f_seq_enc[nb],
                                   a_enc=contig_enc)
                if (
                    bo[0] == len(fn.seq) or bo[0] == len(contig)
                ) and (nb_sub or ct_sub):
                    if ct_sub:
                        old_contig = contig
                        old_cur = cur
                        old_counts = ct_buf[:cur].copy()
                        contig, ry = fn.seq, fn.ry
                        contig_enc = f_seq_enc[nb]
                        ry_enc = f_ry_enc[nb] if specified_deam else None
                        node_ids = list(fn.node_ids)
                        idx_of = {}
                        for kk, nid in enumerate(node_ids):
                            idx_of.setdefault(nid, kk)
                        # grow BEFORE rebinding cur: _ensure copies
                        # sc_buf[:cur], which must be the OLD live
                        # region (an absorbed fragment longer than cap
                        # would otherwise hit a broadcast-shape error)
                        _ensure(len(fn.seq))
                        cur = len(fn.seq)
                        with np.errstate(divide="ignore"):
                            sc_buf[:cur] = np.log(fn.probs)
                        ct_buf[:cur] = fn.counts
                        if cur < old_cur:
                            # later merges += into rows past cur; keep
                            # the shrunk tail zeroed
                            ct_buf[cur:old_cur] = 0
                        off = find_alignment_position(fn.seq, old_contig, 1)
                        if off >= 0:
                            end = min(cur, off + len(old_contig))
                            ct_buf[off:end] += old_counts[: end - off]
                        _extend_ids(fn.node_ids)
                    else:
                        pos = find_alignment_position(contig, fn.seq, 1)
                        if pos >= 0:
                            for i, c in enumerate(fn.seq):
                                if pos + i < cur and c in _B5:
                                    ct_buf[pos + i, _B5[c]] += 1
                        _extend_ids(fn.node_ids)
                    visited.add(nb)
                    continue

                if bo == (0, 0.0) and bo2 == (0, 0.0):
                    continue  # zero overlap despite common ids (:1348)
                if bo[0] > len(contig) or bo[0] > len(fn.seq):
                    continue
                if bo2[0] > len(contig) or bo2[0] > len(fn.seq):
                    continue

                # direction (src/assembly.cpp:1365-1374, C++ precedence
                # quirk on the last condition preserved)
                if pos_i > pos_j:
                    go2 = False
                elif pos_i < pos_j:
                    go2 = True
                elif bo2[1] > bo[1] and bo2[0] > bo[0]:
                    go2 = True
                elif bo2[1] > bo[1] or (bo2[0] > bo[0] and pos_i == pos_j):
                    go2 = True
                else:
                    go2 = False

                if go2:
                    # read-first merge (src/assembly.cpp:1376-1447)
                    if fn.node_ids[0] != node_ids[0]:
                        continue
                    olen = bo2[0]
                    if not _ry_gate(contig, fn.seq, olen):
                        continue
                    # merged = read + contig[olen:]; prefix rows from
                    # the read, suffix rows from the contig (see module
                    # docstring: the reference branch is UB here)
                    rl = len(fn.seq)
                    new_seq = fn.seq + contig[olen:]
                    new_ry = fn.ry + ry[olen:]
                    with np.errstate(divide="ignore"):
                        rsc = np.log(fn.probs)
                    new_len = rl + cur - olen
                    new_sc = np.zeros((max(cap, new_len), 5))
                    new_ct = np.zeros((max(cap, new_len), 5), np.int64)
                    new_sc[:rl] = rsc
                    new_sc[rl:new_len] = sc_buf[olen:cur]
                    new_ct[:rl] = fn.counts
                    new_ct[rl - olen : new_len] += ct_buf[:cur]
                    sc_buf, ct_buf = new_sc, new_ct
                    cap = len(sc_buf)
                    cur = new_len
                    contig, ry = new_seq, new_ry
                    contig_enc = _enc(contig)
                    ry_enc = _enc(ry) if specified_deam else None
                    finalcut = _merge_cut(finalcut, fn.cut) or finalcut
                    _extend_ids(fn.node_ids)
                else:
                    # contig-first merge (src/assembly.cpp:1449-1509)
                    olen = bo[0]
                    if not _ry_gate(contig, fn.seq, olen):
                        continue
                    rl = len(fn.seq)
                    start_idx = cur
                    contig = contig + fn.seq[olen:]
                    ry = ry + fn.ry[olen:]
                    contig_enc = np.concatenate(
                        [contig_enc, f_seq_enc[nb][olen:]]
                    )
                    if specified_deam:
                        ry_enc = np.concatenate(
                            [ry_enc, f_ry_enc[nb][olen:]]
                        )
                    with np.errstate(divide="ignore"):
                        rsc = np.log(fn.probs)
                    _ensure(cur + rl - olen)
                    sc_buf[cur : cur + rl - olen] = rsc[olen:]
                    ct_buf[start_idx - olen : start_idx - olen + rl] += (
                        fn.counts
                    )
                    cur += rl - olen
                    finalcut = _merge_cut(finalcut, fn.cut) or finalcut
                    _extend_ids(fn.node_ids)
                visited.add(nb)
                q.append(nb)
        counts = ct_buf[:cur].copy()
        scoring = sc_buf[:cur].copy()
        contig = _majority_correct(contig, counts)
        contigs.append(Contig(contig, ry, scoring, counts, node_ids,
                              finalcut))
    return contigs


def remove_subset_contigs(contigs: List[Contig]) -> List[Contig]:
    """removeSubsetContigs (src/assembly.cpp:1569-1625). Per-contig
    node sets and byte encodings are cached once (contigs are immutable
    here), and the j-in-i check short-circuits when i-in-j already
    removed i — the removal set is unchanged (j_in_i is unused on that
    branch in the reference loop too)."""
    sets = [frozenset(c.node_ids) for c in contigs]
    encs = [_enc(c.seq) for c in contigs]
    to_remove = set()
    for i in range(len(contigs)):
        if i in to_remove:
            continue
        for j in range(len(contigs)):
            if i == j or j in to_remove:
                continue
            if is_subset(contigs[i].seq, contigs[i].node_ids,
                         contigs[j].seq, sets[j], 2,
                         b_enc=encs[j], a_enc=encs[i]):
                to_remove.add(i)
                break
            if is_subset(contigs[j].seq, contigs[j].node_ids,
                         contigs[i].seq, sets[i], 2,
                         b_enc=encs[i], a_enc=encs[j]):
                to_remove.add(j)
    return [c for i, c in enumerate(contigs) if i not in to_remove]


# -------------------------------------------- pairwise contig merging
_TRANSITION = {("C", "T"), ("T", "C"), ("G", "A"), ("A", "G")}


def merge_contigs(
    c1: Contig, c2: Contig, olen: int, at_end: bool, mode: str
) -> Contig:
    """mergeContigs (src/assembly.cpp:1628-2363). at_end=True merges
    c2 onto c1's tail; False merges c1 onto c2's tail. Overlap bases
    resolve by mode-dependent majority rules (normal 0.65 / strict 0.9
    with transversion N-masking / reckless pure majority)."""
    A, B = (c1, c2) if at_end else (c2, c1)
    if olen > len(B.seq):
        return A
    new_len = len(A.seq) + len(B.seq) - olen
    seq = list(A.seq + B.seq[olen:])
    ryseq = list(A.ry + B.ry[olen:])
    scoring = np.zeros((new_len, 5), dtype=np.float64)
    counts = np.zeros((new_len, 5), dtype=np.int64)
    empty = np.zeros(new_len, dtype=bool)
    la = len(A.seq)
    scoring[:la] = A.scoring
    counts[:la] = A.counts
    empty[:la] = A.empty
    a_start = la - olen
    n_uniform = np.log(np.full(5, 0.20))

    for ov in range(olen):
        ai, bi = a_start + ov, ov
        ca, cb = seq[ai], B.seq[bi]
        if ca == cb:
            continue

        def count_of(ch: str) -> int:
            m = counts[ai, _B5[ch]] if ch in _B5 else 0
            o = B.counts[bi, _B5[ch]] if ch in _B5 else 0
            return int(m) + int(o)

        def take_b():
            scoring[ai] = B.scoring[bi]
            counts[ai] += B.counts[bi]
            seq[ai] = cb
            ryseq[ai] = B.ry[bi]

        def mask_n():
            seq[ai] = "N"
            counts[ai] += B.counts[bi]
            scoring[ai] = n_uniform
            ryseq[ai] = "N"

        if ca == "-" or cb == "-":
            if count_of(ca) < count_of(cb):
                take_b()
            continue
        is_ts = (ca, cb) in _TRANSITION
        if mode == "reckless":
            if count_of(ca) < count_of(cb):
                take_b()
            continue
        thr = 0.9 if mode == "strict" else 0.65
        n_a, n_b = count_of(ca), count_of(cb)
        total = n_a + n_b
        if total == 0:
            mask_n()
            continue
        if is_ts:
            if n_a / total >= thr:
                continue
            if n_b / total >= thr:
                take_b()
            else:
                mask_n()
        else:
            if n_b / total >= thr:
                take_b()
            elif n_a / total >= thr:
                continue
            else:
                mask_n()

    rest = len(B.seq) - olen
    if rest > 0:
        scoring[la:] = B.scoring[olen:]
        counts[la:] = B.counts[olen:]
        empty[la:] = B.empty[olen:]

    node_ids = list(A.node_ids)
    seen = set(node_ids)
    for i in B.node_ids:
        if i not in seen:
            node_ids.append(i)
            seen.add(i)
    cut = _merge_cut(A.cut, B.cut) or A.cut
    return Contig("".join(seq), "".join(ryseq), scoring, counts,
                  node_ids, cut, empty)


@dataclass
class MergeDecision:
    can: bool = False
    olen: int = 0
    score: float = 0.0
    at_end: bool = False
    num_n: int = -1


def try_merge_contigs(
    ci: Contig, cj: Contig,
    min_olen: int,
    node_seq_map: Dict[int, Tuple[str, int, int]],
    len_min: float,
    pre: Optional[Tuple] = None,
) -> MergeDecision:
    """tryMergeContigs (src/assembly.cpp:2372-3065). `pre` optionally
    supplies the four overlap scans precomputed by the caller's
    threaded native batch (identical winners)."""
    res = MergeDecision()
    jset = set(cj.node_ids)
    common = [i for i in ci.node_ids if i in jset]
    if not common:
        return res
    if pre is not None:
        end_r, begin_r, seq_te, seq_ts = pre
    else:
        end_r = overlap_score(ci.ry, cj.ry, min_olen, len_min)
        begin_r = overlap_score(cj.ry, ci.ry, min_olen, len_min)
        seq_te = overlap_score(ci.seq, cj.seq, min_olen, len_min)
        seq_ts = overlap_score(cj.seq, ci.seq, min_olen, len_min)
    if (seq_te[0] > end_r[0] and seq_te[1] > end_r[1]) or (
        seq_ts[0] > begin_r[0] and seq_ts[1] > begin_r[1]
    ):
        end_r, begin_r = seq_te, seq_ts

    first_common = common[0]
    pos_i = ci.node_ids.index(first_common)
    pos_j = cj.node_ids.index(first_common)
    is_i_to_j = pos_i < pos_j
    if pos_i != 0 and pos_j != 0 and pos_i != pos_j:
        is_i_to_j = not (end_r[0] > begin_r[0] and end_r[1] > begin_r[1])

    nc = len(common)
    if (end_r[0] > nc and end_r[1] > 0) or (
        begin_r[1] > 0 and begin_r[0] > nc
    ):
        if pos_i == pos_j:
            if end_r[1] > begin_r[1] and end_r[0] > begin_r[0]:
                best, at_end = end_r, True
            elif end_r[1] < begin_r[1] and end_r[0] < begin_r[0]:
                best, at_end = begin_r, False
            else:
                return res
        else:
            if (end_r[1] > begin_r[1] and end_r[0] > begin_r[0]) and not is_i_to_j:
                best, at_end = end_r, True
            elif (end_r[1] < begin_r[1] and end_r[0] < begin_r[0]) and is_i_to_j:
                best, at_end = begin_r, False
            elif ci.cut[0] or cj.cut[0]:
                if end_r[1] > begin_r[1] and end_r[0] > begin_r[0]:
                    best, at_end = end_r, True
                elif end_r[1] < begin_r[1] and end_r[0] < begin_r[0]:
                    best, at_end = begin_r, False
                else:
                    return res
            else:
                if not is_i_to_j:
                    best, at_end = end_r, True
                else:
                    best, at_end = begin_r, False
        res.can = True
        res.olen, res.score = best
        res.at_end = at_end
        return res

    if nc == 1:
        # single shared node: bridge across the node sequence with Ns
        # (src/assembly.cpp:2763-2827)
        cid = common[0]
        node_seq = node_seq_map.get(cid, ("", 0, 0))[0]
        if (
            ci.node_ids[-1] == cid and cj.node_ids[0] == cid
            and ci.cut[1] < 2 and cj.cut[1] not in (1, 3)
        ):
            mi = find_match(ci.seq, node_seq, False)
            mj = find_match(cj.seq, node_seq, True)
            res.can = True
            res.at_end = True
            res.num_n = (
                max(len(node_seq) - (mi + mj), 0) if mi > 0 and mj > 0 else 0
            )
        if (
            cj.node_ids[-1] == cid and ci.node_ids[0] == cid
            and cj.cut[1] < 2 and ci.cut[1] not in (1, 3)
        ):
            mj = find_match(cj.seq, node_seq, False)
            mi = find_match(ci.seq, node_seq, True)
            res.can = True
            res.at_end = False
            res.num_n = (
                max(len(node_seq) - (mi + mj), 0) if mi > 0 and mj > 0 else 0
            )
        return res

    # >1 common node, no qualifying overlap: the reference branch
    # (src/assembly.cpp:2831-3047) re-tests the same overlaps against a
    # now-stricter gate and can never pass with length 0 — no merge.
    return res


def merge_overlapping_contigs(
    contigs: List[Contig],
    min_olen: int,
    node_seq_map: Dict[int, Tuple[str, int, int]],
    mode: str,
    len_min: float,
    *,
    device,
) -> List[Contig]:
    """mergeOverlappingContigs (src/assembly.cpp:3069-3345). The
    candidate pairs' overlap scans run as one batch on `device`
    (keelime_device.overlap_best_indexed over every contig's ry and seq,
    interned once)."""
    import torch

    from .keelime_device import (count_long, intern, longest_of,
                                 overlap_best_indexed)

    contigs = remove_subset_contigs(contigs)
    # exact prefilter: try_merge_contigs is a no-merge for pairs with
    # no shared node id (its first check), so only pairs sharing >=1
    # node go through the full decision — the all-pairs loop was the
    # fixpoint's O(contigs^2 x contig-length) term
    node2c: Dict[int, List[int]] = {}
    for i, c in enumerate(contigs):
        for nid in set(c.node_ids):
            node2c.setdefault(nid, []).append(i)
    cand = set()
    for lst in node2c.values():
        for a in range(len(lst)):
            for b in range(a + 1, len(lst)):
                cand.add((lst[a], lst[b]))
    pairs_sorted = sorted(cand)
    # the four overlap scans per candidate pair run as ONE batch on
    # `device` (identical winners to the per-pair scorer)
    pre_by_pair = None
    if pairs_sorted:
        # contig c's ry is sequence 2c of the table, its seq 2c + 1; a
        # candidate's four scans: (ry_i, ry_j), (ry_j, ry_i), (seq_i,
        # seq_j), (seq_j, seq_i)
        ci, cj = (2 * np.array(pairs_sorted, dtype=np.int32)).T
        ai = np.stack([ci, cj, ci + 1, cj + 1], axis=1).reshape(-1)
        bi = np.stack([cj, ci, cj + 1, ci + 1], axis=1).reshape(-1)
        dev = torch.device(device)
        table = intern([s for c in contigs for s in (c.ry, c.seq)])
        ln, sc = overlap_best_indexed(
            *(torch.from_numpy(x).to(dev) for x in table + (ai, bi)),
            min_olen, len_min, longest_of(table[1]),
            count_long(table[1], ai))
        scored = list(zip(ln.cpu().tolist(), sc.cpu().tolist()))
        pre_by_pair = [
            tuple(scored[4 * t : 4 * t + 4])
            for t in range(len(pairs_sorted))
        ]
    potential: List[Tuple[int, int, MergeDecision]] = []
    for t, (i, j) in enumerate(pairs_sorted):
        d = try_merge_contigs(
            contigs[i], contigs[j], min_olen, node_seq_map, len_min,
            pre=pre_by_pair[t] if pre_by_pair is not None else None,
        )
        if not d.can:
            continue
        if (d.at_end and d.olen > len(contigs[j].seq)) or (
            not d.at_end and d.olen > len(contigs[i].seq)
        ):
            continue
        potential.append((i, j, d))

    # best candidate per (i, at_end) by score then length (:3123-3148)
    by_i: Dict[int, Dict[bool, Tuple[int, int, MergeDecision]]] = {}
    for i, j, d in potential:
        slot = by_i.setdefault(i, {})
        cur = slot.get(d.at_end)
        if (
            cur is None
            or d.score > cur[2].score
            or (d.score == cur[2].score and d.olen > cur[2].olen)
        ):
            slot[d.at_end] = (i, j, d)
    filtered = [t for i in sorted(by_i) for t in by_i[i].values()]

    merged_idx = set()
    out: List[Contig] = []
    for i, j, d in filtered:
        if i in merged_idx or j in merged_idx:
            continue
        if d.num_n > -1:
            # N-bridge concatenation (src/assembly.cpp:3166-3317)
            A, B = (contigs[i], contigs[j]) if d.at_end else (
                contigs[j], contigs[i]
            )
            cut = _merge_cut(A.cut, B.cut)
            if cut is None:
                continue
            ns = d.num_n
            seq = A.seq + "N" * ns + B.seq
            ry = A.ry + "N" * ns + B.ry
            scoring = np.concatenate(
                [A.scoring, np.zeros((ns, 5)), B.scoring]
            )
            cnts = np.concatenate(
                [A.counts, np.zeros((ns, 5), np.int64), B.counts]
            )
            empty = np.concatenate(
                [A.empty, np.ones(ns, dtype=bool), B.empty]
            )
            # no node-id dedup here (reference quirk, :3208-3209)
            node_ids = list(A.node_ids) + list(B.node_ids)
            out.append(Contig(seq, ry, scoring, cnts, node_ids, cut, empty))
        else:
            out.append(
                merge_contigs(contigs[i], contigs[j], d.olen, d.at_end, mode)
            )
        merged_idx.add(i)
        merged_idx.add(j)
    for i, c in enumerate(contigs):
        if i not in merged_idx:
            out.append(c)
    return out


def check_and_merge_contigs(
    ci: Contig, cj: Contig,
    node_seq_map: Dict[int, Tuple[str, int, int]],
    len_min: float, score_min: float, specified_deam: bool, mode: str,
) -> Optional[Contig]:
    """checkAndMergeContigs (src/assembly.cpp:3392-3552). Quirk: the
    RY/plain choice is inverted here relative to every other caller."""
    jset = set(cj.node_ids)
    common = [i for i in ci.node_ids if i in jset]
    if specified_deam:
        r1 = overlap_score(ci.seq, cj.seq, int(len_min), score_min)
        r2 = overlap_score(cj.seq, ci.seq, int(len_min), score_min)
    else:
        r1 = overlap_score(ci.ry, cj.ry, int(len_min), score_min)
        r2 = overlap_score(cj.ry, ci.ry, int(len_min), score_min)

    can1 = (ci.cut[0] and ci.cut[1] in (2, 3)) or (
        cj.cut[0] and cj.cut[1] in (1, 3)
    )
    can2 = (cj.cut[0] and cj.cut[1] in (2, 3)) or (
        ci.cut[0] and ci.cut[1] in (1, 3)
    )
    if (
        can1 and r1[0] > len_min and r1[1] > score_min
        and r1[0] < len(ci.seq) and r1[0] < len(cj.seq)
        and (r1[1] > r2[1] or r1[0] > r2[0])
    ):
        return merge_contigs(ci, cj, r1[0], True, mode)
    if (
        can2 and r2[0] > len_min and r2[1] > score_min
        and r2[0] < len(ci.seq) and r2[0] < len(cj.seq)
        and (r1[1] < r2[1] or r1[0] < r2[0])
    ):
        return merge_contigs(cj, ci, r2[0], False, mode)
    if common:
        # forced overlap from shared node spans (:3480-3548)
        uniq = sorted(set(common))
        forced = 0
        for nid in uniq:
            if nid not in node_seq_map:
                continue
            nseq, nlen, _ = node_seq_map[nid]
            if nid == uniq[0]:
                forced += find_match(ci.seq, nseq, True)
            elif nid == uniq[-1]:
                forced += find_match(cj.seq, nseq, False)
            else:
                forced += nlen
        if forced >= len(ci.seq):
            return ci
        return merge_contigs(ci, cj, forced, True, mode)
    return None


# --------------------------------------------------------- orchestration
def _node_seq_maps(graph: PackedGraph, ref_path: int):
    """nodeSequenceMap (chosen path) and nodeSequenceMap2 (all paths),
    src/assembly.cpp:4049-4088. Values: (seq, len, order)."""
    node_lengths: List[Tuple[int, int]] = []
    nmap: Dict[int, Tuple[str, int, int]] = {}
    for order, (nidx, rev) in enumerate(
        zip(graph.path_steps_node[ref_path], graph.path_steps_rev[ref_path])
    ):
        nid = int(nidx) + graph.min_id
        seq = graph.node_seq(nid, bool(rev))
        nmap[nid] = (seq, len(seq), order)
        node_lengths.append((nid, len(seq)))
    nmap2: Dict[int, Tuple[str, int, int]] = {}
    for p in range(graph.n_paths):
        for order, (nidx, rev) in enumerate(
            zip(graph.path_steps_node[p], graph.path_steps_rev[p])
        ):
            nid = int(nidx) + graph.min_id
            seq = graph.node_seq(nid, bool(rev))
            nmap2[nid] = (seq, len(seq), order)
    return node_lengths, nmap, nmap2


def assemble(
    graph: PackedGraph,
    frags: List[Frag],
    ref_path: int = 0,
    len_min: int = 10,
    score_min: int = 15,
    mode: str = "normal",
    specified_deam: bool = False,
    clade_range: Optional[Tuple[int, int]] = None,
    *,
    device,
) -> List[Contig]:
    """Full assembly pipeline (src/assembly.cpp:4001-4210): depth sort,
    overlap DAG, BFS contigs, subset removal, merge fixpoint, ordering
    along the reference path, final adjacent merge. The batched overlap
    scans run on `device`; the rest is host code."""
    if not frags:
        raise RuntimeError("Error: No reads are mapped. Unable to proceed.")
    if clade_range is not None:
        start_id, end_id = clade_range
    else:
        start_id, end_id = graph.min_id, graph.max_id
    depths = node_depths(graph, start_id, end_id)
    frags = sort_frags(frags, depths)
    for f in frags:
        f.ry = to_rymer(f.seq)

    density, _avg = initial_overlap(frags, depths)
    g, overlap_map = find_overlaps(
        frags, len_min, score_min, density, specified_deam, len_min,
        device=device,
    )
    contigs = merge_all_paths(g, overlap_map, frags, specified_deam, len_min)
    contigs = remove_subset_contigs(contigs)

    node_lengths, nmap, nmap2 = _node_seq_maps(graph, ref_path)
    merged = merge_overlapping_contigs(contigs, 1, nmap2, mode, len_min,
                                       device=device)
    while True:
        prev = len(merged)
        merged = merge_overlapping_contigs(merged, 1, nmap2, mode, len_min,
                                           device=device)
        if len(merged) >= prev:
            break

    # ordering along the reference path (:4114-4162)
    ordered: List[Contig] = []
    used = set()
    for nid, _ in node_lengths:
        for k, c in enumerate(merged):
            if k not in used and c.node_ids and c.node_ids[0] == nid:
                ordered.append(c)
                used.add(k)
                break
    unmatched = [c for k, c in enumerate(merged) if k not in used]
    for c in unmatched:
        rng = nmap2.get(c.node_ids[0], ("", 0, 1 << 30))[2]
        at = len(ordered)
        for k, oc in enumerate(ordered):
            if nmap2.get(oc.node_ids[0], ("", 0, 1 << 30))[2] > rng:
                at = k
                break
        ordered.insert(at, c)

    # final adjacent-merge fixpoint (:4167-4208)
    while True:
        occurred = False
        result: List[Contig] = []
        skip = set()
        for k in range(len(ordered)):
            if k in skip:
                continue
            c = ordered[k]
            if k + 1 < len(ordered) and (k + 1) not in skip:
                m = check_and_merge_contigs(
                    c, ordered[k + 1], nmap, len_min, score_min,
                    specified_deam, mode,
                )
                if m is not None:
                    c = m
                    skip.add(k + 1)
                    occurred = True
            result.append(c)
        ordered = result
        if not occurred:
            break
    return ordered


def consensus(
    graph: PackedGraph,
    contigs: List[Contig],
    ref_path: int = 0,
    min_coverage: int = 1,
    unknown_ref: bool = False,
    use_remaining: bool = False,
) -> Tuple[str, np.ndarray, np.ndarray, np.ndarray]:
    """Consensus along the reference path's node walk
    (src/assembly.cpp:4216-4438). Returns (fasta, scoring, counts,
    empty_mask)."""
    node_lengths, nmap, _ = _node_seq_maps(graph, ref_path)
    n_uniform = np.log(np.full(5, 0.20))
    fasta: List[str] = []
    sc_rows: List[np.ndarray] = []
    ct_rows: List[np.ndarray] = []
    em_rows: List[np.ndarray] = []
    used = set()
    in_contig = False
    last_node = -1
    contig_seq = ""

    def push_n(n: int):
        if n <= 0:
            return
        fasta.append("N" * n)
        sc_rows.append(np.tile(n_uniform, (n, 1)))
        ct_rows.append(np.zeros((n, 5), np.int64))
        em_rows.append(np.zeros(n, dtype=bool))

    for nid, nlen in node_lengths:
        hit = None
        for k, c in enumerate(contigs):
            if nid in c.node_ids:
                hit = k
                break
        if hit is not None and hit not in used:
            c = contigs[hit]
            contig_seq = c.seq
            nid_use = nid
            for cand in c.node_ids:
                if cand in nmap:
                    nid_use = cand
                    break
            node_seq = nmap[nid_use][0]
            m = find_match(contig_seq, node_seq, True)
            ns = 0 if m == 0 else max(len(node_seq) - m, 0)
            if c.cut[0]:
                ns = 0
            push_n(ns)
            fasta.append(contig_seq)
            sc_rows.append(c.scoring)
            ct_rows.append(c.counts)
            em_rows.append(c.empty)
            used.add(hit)
            last_node = c.node_ids[-1]
            in_contig = True
        else:
            if in_contig:
                if nid == last_node:
                    node_seq = nmap[nid][0]
                    m = find_match(contig_seq, node_seq, False)
                    ns = 1 if m == 0 else max(len(node_seq) - m, 0)
                    if hit is not None and contigs[hit].cut[0]:
                        ns = 1
                    push_n(ns)
                    in_contig = False
            else:
                if not unknown_ref:
                    push_n(nlen)
                else:
                    print(
                        "Unknown reference specified: not bridging unknown"
                        " node IDs with 'N'.",
                        file=sys.stderr,
                    )

    if use_remaining:
        for k, c in enumerate(contigs):
            if k in used:
                continue
            ns = 0
            if in_contig and c.node_ids and c.node_ids[0] in nmap:
                ns = max(find_match(c.seq, nmap[c.node_ids[0]][0], True), 0)
            if c.cut[0]:
                ns = 1
            push_n(ns)
            fasta.append(c.seq)
            sc_rows.append(c.scoring)
            ct_rows.append(c.counts)
            em_rows.append(c.empty)

    seq = list("".join(fasta))
    scoring = (
        np.concatenate(sc_rows) if sc_rows else np.zeros((0, 5))
    )
    counts = (
        np.concatenate(ct_rows) if ct_rows else np.zeros((0, 5), np.int64)
    )
    empty = (
        np.concatenate(em_rows) if em_rows else np.zeros(0, dtype=bool)
    )
    # coverage mask + majority correction (:4405-4438)
    totals = counts.sum(axis=1)
    mx = counts.max(axis=1)
    for i in range(len(seq)):
        if totals[i] < min_coverage:
            seq[i] = "N"
            continue
        if mx[i] > 0:
            best = BASES5[int(np.argmax(counts[i]))]
            if seq[i] != best:
                seq[i] = best
    return "".join(seq), scoring, counts, empty


def write_outputs(
    out_prefix: str,
    contigs: List[Contig],
    fasta: str,
    scoring: np.ndarray,
    counts: np.ndarray,
    empty: Optional[np.ndarray] = None,
) -> None:
    """Output files (src/assembly.cpp:164-233, 3350-3390, 4212-4450):
    Contig.fa.gz, Consensus.fa.gz, ProbabilityMatrix.tsv (probability
    space, empty rows blank), CountMatrix.tsv."""
    if empty is None:
        empty = np.zeros(len(fasta), dtype=bool)
    with gzip.open(f"{out_prefix}Contig.fa.gz", "wt") as f:
        for i, c in enumerate(contigs):
            f.write(f">contig_{i + 1}\n{c.seq}\n")
    with gzip.open(f"{out_prefix}Consensus.fa.gz", "wt") as f:
        f.write(f">Consensus\n{fasta}\n")
    with open(f"{out_prefix}ProbabilityMatrix.tsv", "w") as f:
        for i in range(len(scoring)):
            f.write(f"Position {i + 1}:\t")
            if not empty[i]:
                probs = np.exp(scoring[i])
                f.write(
                    "\t".join(
                        f"{BASES5[k]}={probs[k]:g}" for k in range(5)
                    )
                )
                f.write("\t")
            f.write("\n")
    with open(f"{out_prefix}CountMatrix.tsv", "w") as f:
        for i in range(len(counts)):
            f.write(f"Position {i + 1}:\t")
            if not empty[i]:
                f.write(
                    "\t".join(
                        f"{BASES5[k]}={counts[i][k]}" for k in range(5)
                    )
                )
                f.write("\t")
            f.write("\n")


# ------------------------------------------------------------------ CLI
def main_keelime(args: List[str]) -> int:
    """`keelime` on the command line; `--device` (default cuda) is where
    the mapper's SW kernel and the batched overlap scans run."""
    import os

    from ..io import fastx, gam as gamio
    from ..mapper.giraffe import BatchedMapper as Mapper
    from ..cli import _take, _load_graph
    from ..utils.device import resolve_device

    dbprefix = ""
    dbdir = ""
    fq1 = fq2 = gamfile = ""
    out = "keelime_output"
    ref_path_name = ""
    min_cov = 1
    len_min, score_min = 10, 15
    mode = "normal"
    deam5p = deam3p = ""
    unknown_ref = False
    use_remaining = False
    device = "cuda"
    i = 0
    while i < len(args):
        a = args[i]
        if a == "--dbprefix":
            dbprefix = _take(args, i); i += 2
        elif a in ("--keelime_dir", "--dbdir"):
            dbdir = _take(args, i); i += 2
        elif a == "-fq1":
            fq1 = _take(args, i); i += 2
        elif a == "-fq2":
            fq2 = _take(args, i); i += 2
        elif a == "-g":
            gamfile = _take(args, i); i += 2
        elif a == "-o":
            out = _take(args, i); i += 2
        elif a == "-p":
            ref_path_name = _take(args, i); i += 2
        elif a == "-c":
            min_cov = int(_take(args, i)); i += 2
        elif a in ("-mL", "--lenMin"):
            len_min = int(_take(args, i)); i += 2
        elif a == "-mS":
            score_min = int(_take(args, i)); i += 2
        elif a in ("-m", "--mode"):
            mode = _take(args, i); i += 2
        elif a == "--deam5p":
            deam5p = _take(args, i); i += 2
        elif a == "--deam3p":
            deam3p = _take(args, i); i += 2
        elif a in ("-uR", "--unknownRef"):
            unknown_ref = True; i += 1
        elif a in ("-uC", "--useRemaining"):
            use_remaining = True; i += 1
        elif a == "-t":
            from ..cli import _check_threads

            _check_threads(_take(args, i), "keelime"); i += 2
        elif a == "--profile":
            from ..utils import profiling

            profiling.enable(); i += 1
        elif a == "--device":
            device = _take(args, i); i += 2
        else:
            print(f"[keelime] ignoring unknown flag {a}", file=sys.stderr)
            i += 1
    dev = resolve_device(device)
    graph = _load_graph(os.path.join(dbdir, dbprefix))
    ref_path = 0
    if ref_path_name and ref_path_name in graph.path_names:
        ref_path = graph.path_names.index(ref_path_name)
    damage = None
    specified_deam = bool(deam5p or deam3p)
    if specified_deam:
        damage = DamageModel.from_profiles(deam5p or None, deam3p or None)
    from ..utils.profiling import PROFILER

    from ..mapper.batch_map import table_from_gam
    from ..parallel import multihost

    table = alignments = None
    if gamfile:
        with PROFILER.stage("read_gam"):
            table = table_from_gam(gamfile)
            if table is None:
                # a GAM the columnar codec cannot parse
                alignments = gamio.read_gam(gamfile)
        if multihost.active():
            # rank-shard the alignments; frags allgather below
            if table is not None:
                lo, hi = multihost.shard_bounds(
                    table.n, multihost.process_id(),
                    multihost.process_count())
                table = table.select(np.arange(lo, hi))
            else:
                alignments = multihost.shard_reads(alignments)
    else:
        mapper = Mapper(graph, device=dev)
        reads = fastx.read_fastq(fq1)
        r2 = fastx.read_fastq(fq2) if fq2 else []
        if multihost.active() and not r2:
            # paired input is not sharded: every rank maps every pair,
            # as the JAX package does
            reads = multihost.shard_reads(reads)
        with PROFILER.stage("map", items=len(reads) + len(r2)):
            if r2 and len(r2) == len(reads):
                alignments = mapper.map_read_pairs(reads, r2)
            else:
                table = mapper.map_reads_table(reads + r2)
    n_in = table.n if table is not None else len(alignments)
    with PROFILER.stage("analyse", items=n_in):
        if table is not None:
            frags = analyse_gam_table(graph, table, damage=damage)
        else:
            frags = analyse_gam(graph, alignments, damage=damage)
    if multihost.active():
        # mapping + per-read analysis shard across ranks; the OLC
        # assembly is a global read-order-dependent structure, so frags
        # gather (rank order = read order) and host 0 assembles+writes
        parts = multihost.allgather_objects(frags)
        frags = [f for part in parts for f in part]
        if not multihost.is_host0():
            PROFILER.report()
            return 0
    with PROFILER.stage("assemble", items=len(frags)):
        contigs = assemble(
            graph, frags, ref_path=ref_path, len_min=len_min,
            score_min=score_min, mode=mode, specified_deam=specified_deam,
            device=dev,
        )
    with PROFILER.stage("consensus"):
        fasta, scoring, counts, empty = consensus(
            graph, contigs, ref_path=ref_path, min_coverage=min_cov,
            unknown_ref=unknown_ref, use_remaining=use_remaining,
        )
    write_outputs(out, contigs, fasta, scoring, counts, empty)
    print(
        f"[keelime] {len(frags)} reads -> {len(contigs)} contigs, "
        f"consensus {len(fasta)}bp",
        file=sys.stderr,
    )
    PROFILER.report()
    return 0
