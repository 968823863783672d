"""Plain reference of what every pipeline's mapping produced, in numpy:
the world read as a graph, the program's alignments read out of its
table, whether an alignment is valid and where it lies, and vgan's
reconstruction of an alignment's graph and read strings
(`src/vgan_utils.h` lines 6-79, quirks included). Imports nothing of the
program.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

A, C, G, T, N, GAP, SOFTCLIP, RARE = range(8)
COMP = np.array([T, G, C, A, N, GAP, SOFTCLIP, RARE], dtype=np.uint8)
LUT = np.full(256, RARE, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    LUT[_b] = _i
    LUT[_b + 32] = _i
LUT[ord("N")] = LUT[ord("n")] = N
LUT[ord("-")] = GAP
LUT[ord("S")] = SOFTCLIP

def encode(s) -> np.ndarray:
    if isinstance(s, str):
        s = s.encode()
    return LUT[np.frombuffer(s, dtype=np.uint8)]


def qscore() -> np.ndarray:
    """Error probability of phred Q: 10^(-Q/10) above 2, else 0.25."""
    q = np.arange(100, dtype=np.float64)
    return np.where(q > 2, 10.0 ** (-q * 0.1), 0.25)


class RefGraph:
    """The world as the reference reads it: node codes by id, the set of
    forward edges, each node's path support in the given path order and
    the backbone node each node stands on."""

    def __init__(self, world, path_names: Sequence[str]):
        self.codes = {n: encode(s) for n, s in world.segments.items()}
        self.edges = set(world.links)
        self.backbone_of = world.backbone_of
        self.node_len = world.node_len
        self.min_id = min(world.segments)
        col = {nm: j for j, nm in enumerate(path_names)}
        self.n_paths = len(path_names)
        # [node id - min_id, path]: the path walks the node
        self.support = np.zeros((max(world.segments) - self.min_id + 1,
                                 self.n_paths), dtype=bool)
        for name, steps in world.paths:
            self.support[np.asarray(steps, dtype=np.int64) - self.min_id,
                         col[name]] = True

    def oriented(self, node: int, rev: bool) -> np.ndarray:
        c = self.codes[node]
        return COMP[c[::-1]] if rev else c


class Aln:
    """One read's alignment as the program's table gives it."""
    __slots__ = ("maps",)

    def __init__(self, maps):
        # [(node id, offset, reverse, [(from, to, seq codes)])]
        self.maps = maps


def table_alignments(table) -> List[Aln]:
    """Per read, its mappings and edits out of the columnar table."""
    out = []
    eseq = np.frombuffer(table.eseq, dtype=np.uint8)
    for i in range(table.n):
        maps = []
        for m in range(int(table.map_off[i]), int(table.map_off[i + 1])):
            edits = []
            for e in range(int(table.e_off[m]), int(table.e_off[m + 1])):
                s = LUT[eseq[int(table.e_soff[e]):int(table.e_soff[e + 1])]]
                edits.append((int(table.e_from[e]), int(table.e_to[e]), s))
            maps.append((int(table.m_node[m]), int(table.m_off[m]),
                         bool(table.m_rev[m]), edits))
        out.append(Aln(maps))
    return out


# ---------------------------------------------------------------- alignments
def alignment_fault(g: RefGraph, aln: Aln, read: str, start: int,
                    reverse: bool, read_len: int):
    """None when the alignment spells the read, follows the graph and
    covers the read's origin on the forward strand (shifted by no more
    than its clipped and inserted bases); else what is wrong."""
    if not aln.maps:
        return "unmapped"
    spelled, span, loose = [], [], 0
    prev = None
    for k, (node, off, rev, edits) in enumerate(aln.maps):
        if node not in g.codes:
            return f"node {node} not in the graph"
        seq = g.oriented(node, rev)
        if prev is not None:
            pnode, pend, prev_rev = prev
            if pend != len(g.codes[pnode]) or off != 0 or prev_rev != rev:
                return f"mapping {k} does not continue mapping {k - 1}"
            edge = (node, pnode) if rev else (pnode, node)
            if edge not in g.edges:
                return f"no edge {edge}"
        o = off
        for fr, to, s in edits:
            if fr == to and len(s) == 0:
                spelled.append(seq[o:o + fr])
            elif fr == to:
                if len(s) != fr:
                    return "substitution of the wrong length"
                spelled.append(s)
            elif fr == 0:
                spelled.append(s)
                loose += to
            elif to == 0:
                loose += fr
            else:
                return "edit neither match, substitution, insertion nor deletion"
            if fr:
                L = len(g.codes[node])
                lo = L - o - fr if rev else o
                b = g.backbone_of[node]
                span.append(((b - 1) * g.node_len + lo,
                             (b - 1) * g.node_len + lo + fr))
            o += fr
            if o > len(seq):
                return "edit past the node's end"
        prev = (node, o, rev)
    got = np.concatenate(spelled) if spelled else np.zeros(0, np.uint8)
    if not np.array_equal(got, encode(read)):
        return "edits do not spell the read"
    if not span:
        return "no reference base"
    lo = min(a for a, _ in span)
    hi = max(b for _, b in span)
    if reverse != aln.maps[0][2]:
        loose += read_len  # the wrong strand is never within the origin
    if abs(lo - start) + abs(hi - (start + read_len)) > loose:
        return f"placed at [{lo}, {hi}), drawn from [{start}, {start + read_len})"
    return None


# ------------------------------------------------------------ reconstruction
def _reconstruct(g: RefGraph, aln: Aln):
    """(graph codes, read codes, mppg sizes) of `src/vgan_utils.h` 6-79:
    a softclip mark only for an insertion at the start of mapping 0,
    gaps spliced into the read side at deletions, one size an edit."""
    ps = []
    for node, off, rev, edits in aln.maps:
        seq = g.oriented(node, rev)
        o = off
        for fr, to, s in edits:
            ps.append(seq[o:o + fr] if (fr == to and len(s) == 0) else s)
            o += fr
    ps = list(np.concatenate(ps)) if ps else []
    gparts, sizes, f = [], [], 0
    for mi, (node, off, rev, edits) in enumerate(aln.maps):
        seq = g.oriented(node, rev)
        o = off
        for fr, to, s in edits:
            if fr == to:
                seg = seq[o:o + fr]
                gparts.append(seg)
                size = len(seg)
            elif fr == 0 and to > 0:
                clip = mi == 0 and o == 0
                gparts.append(np.full(to, SOFTCLIP if clip else GAP, np.uint8))
                size = to
            elif to == 0 and fr > 0:
                seg = seq[o:o + fr]
                gparts.append(seg)
                size = len(seg)
                ps[f:f] = [GAP] * fr
            else:
                size = 0
            o += fr
            f += fr
            sizes.append(size)
    gc = np.concatenate(gparts) if gparts else np.zeros(0, np.uint8)
    return gc.astype(np.uint8), np.array(ps, dtype=np.uint8), sizes


