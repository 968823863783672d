# Copied from vgan_tpu/db/hc_build.py; imports repointed to this package.
"""HaploCart DB construction from raw consensus FASTAs.

The reference's DB is built offline with `vg construct` from a VCF +
rCRS and one-time generators: `src/readVG.h:31-194` derives the
`path_supports` file from the graph, and modified-mixemt scripts emit
`parents.txt` / `children.txt` from Phylotree; per-haplotype consensus
FASTAs come from `share/vgan/hc_scripts/vcf2fasta.py` (equal-length
sequences on rCRS coordinates). This module self-hosts that pipeline:

    build_hc_db(ref.fa, haplotypes.fa, out_dir, phylo.tsv)

* graph: segmented backbone (<=8bp nodes like the real mtDNA graph,
  `src/test.cpp:627`) with one bubble node per distinct alt version of
  a segment, one stored path per haplotype;
* sidecars in the reference's exact file formats (`src/load.cpp`):
  graph_paths, path_supports ('0'/'1' chars per node line),
  parsed_pangenome_mapping (node id -> 0-based rCRS position; the
  loader adds +1, `src/load.cpp:37`), mappability.tsv (BED-like),
  parents.txt (haplogroup -> ancestor chain) and children.txt
  (haplogroup -> immediate children) from a child->parent phylotree
  TSV.

The emitted directory is loadable both by our runner (load_db) and —
for the text sidecars — by the reference's own loaders.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..graph.packed import PackedGraph
from ..utils import dna


def graph_from_haplotypes(
    ref_seq: str,
    hap_seqs: List[str],
    hap_names: List[str],
    node_len: int = 8,
) -> Tuple[PackedGraph, np.ndarray]:
    """Variant-bubble graph from equal-length consensus sequences.

    Returns (graph, pang0) where pang0[node_idx] is the 0-based
    reference coordinate of the node (pangenome map source)."""
    L = len(ref_seq)
    for nm, s in zip(hap_names, hap_seqs):
        if len(s) != L:
            raise ValueError(
                f"haplotype {nm} length {len(s)} != reference {L} "
                "(vcf2fasta-style consensus FASTAs required)"
            )
    ref = ref_seq.upper()
    haps = [h.upper() for h in hap_seqs]
    n_seg = (L + node_len - 1) // node_len
    # node ids: backbone 1..n_seg, then alt nodes
    segments: Dict[int, str] = {}
    pang0: Dict[int, int] = {}
    for i in range(n_seg):
        segments[i + 1] = ref[i * node_len : (i + 1) * node_len]
        pang0[i + 1] = i * node_len
    next_id = n_seg + 1
    # per segment: distinct alt version -> node id
    alt_ids: List[Dict[str, int]] = [dict() for _ in range(n_seg)]
    # per path: node id per segment
    path_nodes = np.zeros((len(haps), n_seg), dtype=np.int64)
    for j, h in enumerate(haps):
        for i in range(n_seg):
            seg = h[i * node_len : (i + 1) * node_len]
            if seg == segments[i + 1]:
                path_nodes[j, i] = i + 1
            else:
                nid = alt_ids[i].get(seg)
                if nid is None:
                    nid = next_id
                    next_id += 1
                    alt_ids[i][seg] = nid
                    segments[nid] = seg
                    pang0[nid] = i * node_len
                path_nodes[j, i] = nid

    # edges: backbone chain + every adjacency observed on a path
    edges = set()
    for i in range(n_seg - 1):
        edges.add((i + 1, i + 2))
    for j in range(len(haps)):
        for i in range(n_seg - 1):
            edges.add((int(path_nodes[j, i]), int(path_nodes[j, i + 1])))

    n_nodes = next_id - 1
    lens = np.zeros(n_nodes, dtype=np.int64)
    for nid, s in segments.items():
        lens[nid - 1] = len(s)
    node_off = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(lens, out=node_off[1:])
    pool = np.zeros(int(node_off[-1]), dtype=np.uint8)
    for nid, s in segments.items():
        pool[node_off[nid - 1] : node_off[nid]] = dna.encode(s)

    steps_node = [
        (path_nodes[j] - 1).astype(np.int32) for j in range(len(haps))
    ]
    steps_rev = [np.zeros(n_seg, dtype=bool) for _ in range(len(haps))]
    support = np.zeros((n_nodes, len(haps)), dtype=bool)
    for j, sn in enumerate(steps_node):
        support[sn, j] = True
    ef = np.array([a - 1 for a, _ in sorted(edges)], dtype=np.int32)
    et = np.array([b - 1 for _, b in sorted(edges)], dtype=np.int32)
    graph = PackedGraph(
        min_id=1,
        node_seq_pool=pool,
        node_off=node_off,
        edge_from=ef,
        edge_from_rev=np.zeros(len(ef), dtype=bool),
        edge_to=et,
        edge_to_rev=np.zeros(len(et), dtype=bool),
        path_names=list(hap_names),
        path_steps_node=steps_node,
        path_steps_rev=steps_rev,
        path_support=support,
        meta={"source": "build-hc-db"},
    )
    pang_arr = np.zeros(n_nodes, dtype=np.int64)
    for nid, p in pang0.items():
        pang_arr[nid - 1] = p
    return graph, pang_arr


# ------------------------------------------------------------------ phylo
def load_phylo(path: str) -> Dict[str, str]:
    """child<TAB>parent edge list -> {child: parent}."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            t = line.split()
            if len(t) >= 2:
                out[t[0]] = t[1]
    return out


def ancestor_chain(hg: str, parent_of: Dict[str, str]) -> List[str]:
    chain = []
    cur = hg
    seen = set()
    while cur in parent_of and cur not in seen:
        seen.add(cur)
        cur = parent_of[cur]
        chain.append(cur)
    return chain


# ------------------------------------------------------------------ writers
def write_sidecars(
    graph: PackedGraph,
    pang0: np.ndarray,
    out_dir: str,
    parent_of: Optional[Dict[str, str]] = None,
    ref_name: str = "generated",
) -> None:
    """Emit the hcfiles sidecar family in the reference's formats."""
    with open(os.path.join(out_dir, "graph_paths"), "w") as f:
        for n in graph.path_names:
            f.write(n + "\n")
    # path_supports: one line per node, '0'/'1' per path
    # (`src/load.cpp:283-300`; generated by `src/readVG.h:31-194`)
    sup = graph.path_support
    with open(os.path.join(out_dir, "path_supports"), "w") as f:
        for i in range(graph.n_nodes):
            f.write("".join("1" if x else "0" for x in sup[i]) + "\n")
    # pangenome map: node id -> 0-based ref coordinate (loader adds 1,
    # `src/load.cpp:37`)
    with open(os.path.join(out_dir, "parsed_pangenome_mapping"), "w") as f:
        for i in range(graph.n_nodes):
            f.write(f"{i + graph.min_id}\t{int(pang0[i])}\n")
    # mappability: BED-like rows (chrom start end score)
    span = int(pang0.max()) + int(
        graph.node_off[-1] - graph.node_off[-2]
    ) if graph.n_nodes else 1
    with open(os.path.join(out_dir, "mappability.tsv"), "w") as f:
        f.write(f"{ref_name}\t0\t{span + 1}\t1.0\n")
    if parent_of is not None:
        children: Dict[str, List[str]] = {}
        for c, p in parent_of.items():
            children.setdefault(p, []).append(c)
        with open(os.path.join(out_dir, "parents.txt"), "w") as f:
            for n in graph.path_names:
                chain = ancestor_chain(n, parent_of)
                f.write(" ".join([n] + chain) + "\n")
        with open(os.path.join(out_dir, "children.txt"), "w") as f:
            nodes = set(parent_of) | set(children)
            for n in sorted(nodes):
                f.write(" ".join([n] + sorted(children.get(n, []))) + "\n")


def build_hc_db(
    ref_fa: str,
    haps_fa: str,
    out_dir: str,
    phylo_tsv: Optional[str] = None,
    node_len: int = 8,
) -> PackedGraph:
    """End-to-end: consensus FASTAs -> hcfiles-layout DB directory."""
    from ..io import fastx

    ref_seqs, ref_ids = fastx.read_fasta(ref_fa)
    hap_seqs, hap_ids = fastx.read_fasta(haps_fa)
    os.makedirs(out_dir, exist_ok=True)
    graph, pang0 = graph_from_haplotypes(
        ref_seqs[0], hap_seqs, hap_ids, node_len=node_len
    )
    graph.save(os.path.join(out_dir, "graph.npz"))
    parent_of = load_phylo(phylo_tsv) if phylo_tsv else None
    write_sidecars(graph, pang0, out_dir, parent_of, ref_name=ref_ids[0])
    return graph
