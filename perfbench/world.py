# Frozen from vgan_tpu_torch/bench.py (random_tree), tests/_torch_world.py (backbone, build_tree_graph) and vgan_tpu_torch/graph/synth.py (sample_reads).
"""The benchmark's worlds and reads, made from a seed with numpy alone.

A world is plain data: node sequences by id (`segments`), paths as lists
of node ids, and forward links. The pipelines hand it to the program as
the program's own graph type; the plain reference reads it as it is.
Later changes to the program's generators do not move these worlds.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
# code space of the reads: A C G T = 0..3
_COMP = np.array([3, 2, 1, 0], dtype=np.uint8)


class World(NamedTuple):
    segments: Dict[int, str]  # node id -> sequence (forward strand)
    paths: List[Tuple[str, List[int]]]  # (name, node ids in order)
    links: List[Tuple[int, int]]  # forward edges (from id, to id)
    backbone_of: Dict[int, int]  # node id -> backbone node id it replaces
    node_len: int


def random_tree(n_leaves, seed, lo=0.01, hi=0.3):
    """A random rooted binary tree: leaves L0..L{n-1} joined pairwise at
    random under internal nodes N0.. (the root is the last), branch
    lengths uniform in [lo, hi]. Returns (newick, children, length,
    root)."""
    rng = np.random.default_rng(seed)
    active = [f"L{i}" for i in range(n_leaves)]
    children, length = {}, {}
    for t in range(n_leaves - 1):
        i, j = sorted(rng.choice(len(active), size=2, replace=False))
        b = active.pop(j)
        a = active.pop(i)
        name = f"N{t}"
        children[name] = [a, b]
        for c in (a, b):
            length[c] = float(rng.uniform(lo, hi))
        active.append(name)
    root = active[0]

    def nwk(n):
        kids = children.get(n)
        body = f"({','.join(nwk(c) for c in kids)})" if kids else ""
        return body + n + (f":{length[n]:.6f}" if n in length else "")

    return nwk(root) + ";", children, length, root


def backbone(n_bp: int, seed: int) -> str:
    codes = np.random.default_rng(seed).integers(0, 4, size=n_bp)
    return ACGT[codes].tobytes().decode()


def build_tree_world(tree_world, n_bp, sites_per_unit, node_len, seed):
    """One path per tree node over a seeded random backbone, with
    phylogenetic variants: each branch brings max(1, round(length *
    sites_per_unit)) new single-base variants on distinct backbone nodes,
    and a node's path carries every variant on its way from the root.
    Returns (World, private) with private the variant count of each
    node's own branch."""
    _nwk, children, length, root = tree_world
    rng = np.random.default_rng(seed)
    ref = backbone(n_bp, seed)
    n_backbone = (n_bp + node_len - 1) // node_len
    segments = {i + 1: ref[i * node_len:(i + 1) * node_len]
                for i in range(n_backbone)}
    pool = list(rng.permutation(np.arange(2, n_backbone)))
    alt_of, carried, private = {}, {root: set()}, {root: 0}
    links = [(i, i + 1) for i in range(1, n_backbone)]
    order = [root]
    for n in order:  # breadth first: parents before children
        for c in children.get(n, []):
            order.append(c)
            own = set()
            for _ in range(max(1, round(length[c] * sites_per_unit))):
                if not pool:
                    break
                nid = int(pool.pop())
                seq = segments[nid]
                off = int(rng.integers(0, len(seq)))
                alt = "ACGT"[("ACGT".find(seq[off]) + 1
                              + int(rng.integers(0, 3))) % 4]
                alt_id = n_backbone + 1 + len(alt_of)
                segments[alt_id] = seq[:off] + alt + seq[off + 1:]
                alt_of[nid] = alt_id
                links += [(nid - 1, alt_id), (alt_id, nid + 1)]
                own.add(nid)
            carried[c] = carried[n] | own
            private[c] = len(own)
    paths = [(n, [alt_of[i] if i in carried[n] else i
                  for i in range(1, n_backbone + 1)]) for n in order]
    links = path_links(links, paths)
    backbone_of = {i: i for i in range(1, n_backbone + 1)}
    backbone_of.update({a: b for b, a in alt_of.items()})
    return World(segments, paths, links, backbone_of, node_len), private


def path_links(links, paths):
    """The links plus every step the paths take: two variants on
    neighbouring backbone nodes join alt to alt, which the generators
    this is frozen from leave out (their paths then walk a missing
    edge)."""
    seen = set(links)
    out = list(links)
    for _name, steps in paths:
        for e in zip(steps, steps[1:]):
            if e not in seen:
                seen.add(e)
                out.append(e)
    return out


def _encode(seq: str) -> np.ndarray:
    lut = np.zeros(256, dtype=np.uint8)
    for i, b in enumerate(b"ACGT"):
        lut[b] = i
    return lut[np.frombuffer(seq.encode(), dtype=np.uint8)]


class Reads(NamedTuple):
    """A batch of reads and where each came from."""
    seqs: List[str]
    quals: List[bytes]  # raw phred values
    path: np.ndarray  # [n] path index of the origin
    start: np.ndarray  # [n] start on the path (forward strand)
    reverse: np.ndarray  # [n] bool: the read is the reverse complement


def sample_reads(world: World, mix, read_len, error_rate, qual_lo, qual_hi,
                 rng) -> Reads:
    """Reads of each (path index, count) in `mix`, shuffled together:
    a uniform start on the path, substitution errors at `error_rate`,
    either strand with probability 1/2, qualities uniform in
    [qual_lo, qual_hi)."""
    seqs, quals, paths, starts, revs = [], [], [], [], []
    for p, n in mix:
        codes = _encode("".join(world.segments[x] for x in world.paths[p][1]))
        L = len(codes)
        st = rng.integers(0, L - read_len, size=n)
        win = codes[st[:, None] + np.arange(read_len)[None, :]].copy()
        err = rng.random((n, read_len)) < error_rate
        win[err] = rng.integers(0, 4, size=int(err.sum()))
        rev = rng.random(n) < 0.5
        win[rev] = _COMP[win[rev][:, ::-1]]
        q = rng.integers(qual_lo, qual_hi, size=(n, read_len)).astype(np.uint8)
        seqs += [ACGT[w].tobytes().decode() for w in win]
        quals += [row.tobytes() for row in q]
        paths.append(np.full(n, p))
        starts.append(st)
        revs.append(rev)
    order = rng.permutation(len(seqs))
    return Reads([seqs[i] for i in order], [quals[i] for i in order],
                 np.concatenate(paths)[order], np.concatenate(starts)[order],
                 np.concatenate(revs)[order])
