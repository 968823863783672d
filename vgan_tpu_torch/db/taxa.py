# Copied unchanged from vgan_tpu/db/taxa.py; its relative imports resolve to this package.
"""Per-taxon soibean DB construction (make_graph_files.sh equivalent).

The reference script (`share/vgan/soibean_dir/make_graph_files.sh`)
reads the taxon's node range from column 5/6 of `soibean_db.clade`,
chunks that range out of the super-graph with `vg chunk -r a:b`, and
rebuilds every index for the subgraph. Here the same subsetting runs
on the packed super-graph directly: nodes in [start, end], stored
paths trimmed to their in-range runs, edges induced — producing
`<taxon>.npz` that `vgan soibean --dbprefix <taxon>` loads.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from ..graph.packed import PackedGraph


def clade_node_range(clade_file: str, taxon: str) -> Tuple[int, int]:
    """Columns 5/6 of the clade line naming the taxon
    (`make_graph_files.sh` fifth_element/sixth_element)."""
    with open(clade_file) as f:
        for line in f:
            t = line.split()
            if len(t) >= 6 and taxon in line and t[1] == taxon:
                return int(float(t[4])), int(float(t[5]))
    # fall back to substring match like the shell script's grep
    with open(clade_file) as f:
        for line in f:
            t = line.split()
            if len(t) >= 6 and taxon in line:
                return int(float(t[4])), int(float(t[5]))
    raise KeyError(f"taxon {taxon} not found in {clade_file}")


def subset_graph(
    graph: PackedGraph, start_id: int, end_id: int
) -> PackedGraph:
    """Induced subgraph on node ids [start_id, end_id]; paths keep
    their longest in-range run of steps (vg chunk keeps path pieces;
    empty pieces are dropped)."""
    lo = max(start_id, graph.min_id)
    hi = min(end_id, graph.max_id)
    if hi < lo:
        raise ValueError("empty node range")
    n_nodes = hi - lo + 1
    shift = lo - graph.min_id
    node_off_src = graph.node_off
    lens = (node_off_src[shift + 1 : shift + n_nodes + 1]
            - node_off_src[shift : shift + n_nodes])
    node_off = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(lens, out=node_off[1:])
    pool = graph.node_seq_pool[
        node_off_src[shift] : node_off_src[shift + n_nodes]
    ].copy()

    in_range_e = (
        (graph.edge_from >= shift) & (graph.edge_from < shift + n_nodes)
        & (graph.edge_to >= shift) & (graph.edge_to < shift + n_nodes)
    )
    ef = (graph.edge_from[in_range_e] - shift).astype(np.int32)
    et = (graph.edge_to[in_range_e] - shift).astype(np.int32)
    efr = graph.edge_from_rev[in_range_e]
    etr = graph.edge_to_rev[in_range_e]

    path_names: List[str] = []
    steps_node: List[np.ndarray] = []
    steps_rev: List[np.ndarray] = []
    for name, sn, sr in zip(
        graph.path_names, graph.path_steps_node, graph.path_steps_rev
    ):
        inr = (sn >= shift) & (sn < shift + n_nodes)
        if not inr.any():
            continue
        # longest contiguous run
        idx = np.nonzero(inr)[0]
        brk = np.nonzero(np.diff(idx) > 1)[0]
        seg_start = np.concatenate([[0], brk + 1])
        seg_end = np.concatenate([brk, [len(idx) - 1]])
        best = int(np.argmax(seg_end - seg_start))
        keep = idx[seg_start[best] : seg_end[best] + 1]
        steps_node.append((sn[keep] - shift).astype(np.int32))
        steps_rev.append(np.asarray(sr)[keep])
        path_names.append(name)

    support = np.zeros((n_nodes, len(path_names)), dtype=bool)
    for j, sn in enumerate(steps_node):
        support[sn, j] = True
    return PackedGraph(
        min_id=lo,
        node_seq_pool=pool,
        node_off=node_off,
        edge_from=ef,
        edge_from_rev=efr,
        edge_to=et,
        edge_to_rev=etr,
        path_names=path_names,
        path_steps_node=steps_node,
        path_steps_rev=steps_rev,
        path_support=support,
        meta=dict(graph.meta, taxon_range=[int(lo), int(hi)]),
    )


def build_taxon_db(
    db_dir: str,
    taxon: str,
    out_dir: Optional[str] = None,
    clade_file: Optional[str] = None,
    graph: Optional[PackedGraph] = None,
) -> str:
    """make_graph_files.sh equivalent: writes <out_dir>/<taxon>.npz."""
    out_dir = out_dir or db_dir
    clade_file = clade_file or _find_clade(db_dir)
    start, end = clade_node_range(clade_file, taxon)
    if graph is None:
        graph = _load_super_graph(db_dir)
    sub = subset_graph(graph, start, end)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"{taxon}.npz")
    sub.save(out)
    return out


def _find_clade(db_dir: str) -> str:
    for name in ("soibean_db.clade", "euka_db.clade"):
        p = os.path.join(db_dir, name)
        if os.path.exists(p):
            return p
    for fn in os.listdir(db_dir):
        if fn.endswith(".clade"):
            return os.path.join(db_dir, fn)
    raise FileNotFoundError(f"no .clade file in {db_dir}")


def _load_super_graph(db_dir: str) -> PackedGraph:
    from ..io.odgi import read_og

    for name in ("graph.npz", "soibean_db.npz", "euka_db.npz"):
        p = os.path.join(db_dir, name)
        if os.path.exists(p):
            return PackedGraph.load(p)
    for name in ("soibean_db.og", "euka_db.og"):
        p = os.path.join(db_dir, name)
        if os.path.exists(p):
            return read_og(p)
    raise FileNotFoundError(f"no super-graph in {db_dir}")
