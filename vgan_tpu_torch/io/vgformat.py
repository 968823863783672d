# Copied unchanged from vgan_tpu/io/vgformat.py; its relative imports resolve to this package.
"""vg protobuf graph (.vg) reader.

The reference can consume vg-protobuf graphs (`src/readVG.h:31-194`
streams `vg::Graph` chunks via `vg::io::for_each`); this reads the
same format — a BGZF stream of type-tagged message groups (tag "VG",
same framing as GAM) of `Graph{node=1, edge=2, path=3}` with
`Node{sequence=1, name=2, id=3}`, `Edge{from=1, to=2, from_start=3,
to_end=4}` and the GAM `Path`/`Mapping` messages — directly into a
PackedGraph. Validated against the GFA twin of the bundled fixture
(`test/reconstructInputSeq/target_graph.{vg,gfa}` are the same graph).

Mapping ranks order the path steps; chunked graphs (vg emits <=1000
nodes per Graph message) accumulate across chunks, with path steps
concatenated in chunk order per path name (vg's own convention).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..graph.packed import PackedGraph
from ..utils import dna
from . import bgzf
from .gam import _iter_fields, _rv


def _iter_tagged_messages(payload: bytes, tag: bytes):
    p = 0
    n = len(payload)
    while p < n:
        count, p = _rv(payload, p)
        tl, p = _rv(payload, p)
        got = payload[p : p + tl]
        p += tl
        if got != tag:
            raise ValueError(f"unexpected group tag {got!r} (want {tag!r})")
        for _ in range(count - 1):
            ml, p = _rv(payload, p)
            yield payload[p : p + ml]
            p += ml


def read_vg(path: str, meta: Dict | None = None) -> PackedGraph:
    payload = bgzf.read_file(path)
    segments: Dict[int, str] = {}
    links: List[Tuple[int, bool, int, bool]] = []
    path_steps: Dict[str, List[Tuple[int, int, bool]]] = {}  # rank,node,rev
    path_order: List[str] = []

    for g in _iter_tagged_messages(payload, b"VG"):
        for fn, _wt, v in _iter_fields(g):
            if fn == 1:  # Node
                nid, seq = 0, ""
                for f2, _w2, v2 in _iter_fields(v):
                    if f2 == 1:
                        seq = v2.decode()
                    elif f2 == 3:
                        nid = v2
                segments[nid] = seq
            elif fn == 2:  # Edge
                a = b = 0
                fs = te = False
                for f2, _w2, v2 in _iter_fields(v):
                    if f2 == 1:
                        a = v2
                    elif f2 == 2:
                        b = v2
                    elif f2 == 3:
                        fs = bool(v2)
                    elif f2 == 4:
                        te = bool(v2)
                links.append((a, fs, b, te))
            elif fn == 3:  # Path
                name = ""
                steps: List[Tuple[int, int, bool]] = []
                for f2, _w2, v2 in _iter_fields(v):
                    if f2 == 1:
                        name = v2.decode()
                    elif f2 == 2:  # Mapping
                        node = 0
                        rev = False
                        rank = 0
                        for f3, _w3, v3 in _iter_fields(v2):
                            if f3 == 1:  # Position
                                for f4, _w4, v4 in _iter_fields(v3):
                                    if f4 == 1:
                                        node = v4
                                    elif f4 == 4:
                                        rev = bool(v4)
                            elif f3 == 5:
                                rank = v3
                        steps.append((rank, node, rev))
                if name not in path_steps:
                    path_steps[name] = []
                    path_order.append(name)
                path_steps[name].extend(steps)

    if not segments:
        raise ValueError(f"no nodes in vg graph {path}")
    ids = sorted(segments)
    min_id, max_id = ids[0], ids[-1]
    n_nodes = max_id - min_id + 1
    lens = np.zeros(n_nodes, dtype=np.int64)
    for nid in ids:
        lens[nid - min_id] = len(segments[nid])
    node_off = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(lens, out=node_off[1:])
    pool = np.zeros(int(node_off[-1]), dtype=np.uint8)
    for nid in ids:
        i = nid - min_id
        pool[node_off[i] : node_off[i + 1]] = dna.encode(segments[nid])

    steps_node, steps_rev = [], []
    for name in path_order:
        steps = sorted(path_steps[name], key=lambda t: t[0])
        steps_node.append(
            np.array([n - min_id for _r, n, _v in steps], dtype=np.int32)
        )
        steps_rev.append(np.array([v for _r, _n, v in steps], dtype=bool))

    support = np.zeros((n_nodes, len(path_order)), dtype=bool)
    for j, sn in enumerate(steps_node):
        support[sn, j] = True

    return PackedGraph(
        min_id=min_id,
        node_seq_pool=pool,
        node_off=node_off,
        edge_from=np.array([l[0] - min_id for l in links], dtype=np.int32),
        edge_from_rev=np.array([l[1] for l in links], dtype=bool),
        edge_to=np.array([l[2] - min_id for l in links], dtype=np.int32),
        edge_to_rev=np.array([l[3] for l in links], dtype=bool),
        path_names=list(path_order),
        path_steps_node=steps_node,
        path_steps_rev=steps_rev,
        path_support=support,
        meta=meta or {},
    )
