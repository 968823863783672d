"""soibean's Euclidean patristic-distance series, on the card.

The branch-level ESS of a chain source (`src/MCMC.h:576-621`, used at
`src/MCMC.cpp:23-147`) is the ESS of a series with one value a recorded
state: the Euclidean distance, over the leaves, of the point's patristic
distance to each leaf less 1 (0 for the leaves the point reaches through
its node's ancestor). `infer/diagnostics.patristic_distance_series`, the
JAX package's host function held unchanged, rebuilds its per-(node,
leaf) LCA tables on every call and sums [states x leaves] f64 arrays
with numpy. Here:

* `patristic_tables(tree)`: the tables dn, dl [nodes, leaves] and the
  branch lengths, computed by the held function's own lines, once per
  tree content (the tree's parent, dist and children), with one device
  copy a device;
* `patristic_distance_series(tables, nodes, pos, device)`: on a CUDA
  device one launch of patristic_series_kernel (csrc/patristic.cu, a
  thread a state), bit for bit the held function's numpy result; on the
  CPU the plain version `patristic_series_plain`, the held function's
  arithmetic on the cached tables.

Counters (utils/profiling.PROFILER): `patristic.table_builds`, the
cache's misses, and `patristic.card_states`, the states the kernel
computed.
"""
from __future__ import annotations

import ctypes
import hashlib
from typing import Dict, Tuple

import numpy as np
import torch

from ..utils.newick import Tree
from ..utils.profiling import PROFILER

LAUNCHES: Dict[str, int] = {"patristic_series": 0}
"""Kernel launches since the last reset_launches()."""


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class PatristicTables:
    """dn, dl [nodes, leaves]: the distances from a node and from a leaf
    up to their lowest common ancestor; dist [nodes]: the branch
    lengths (host f64); and their copies on each device used."""

    def __init__(self, dn: np.ndarray, dl: np.ndarray, dist: np.ndarray):
        self.dn, self.dl, self.dist = dn, dl, dist
        self._on: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}

    def on(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """(dn, dl, dist) on `device`, uploaded at the first call."""
        t = self._on.get(device)
        if t is None:
            t = self._on[device] = tuple(
                torch.from_numpy(a).to(device)
                for a in (self.dn, self.dl, self.dist))
        return t


_TABLES: Dict[bytes, PatristicTables] = {}


def _tree_key(tree: Tree) -> bytes:
    h = hashlib.sha256()
    for a in (tree.parent, tree.dist, tree.children):
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())
    return h.digest()


def patristic_tables(tree: Tree) -> PatristicTables:
    """The tree's tables, built at the first call for its content and
    taken from the cache after it."""
    key = _tree_key(tree)
    tables = _TABLES.get(key)
    if tables is None:
        PROFILER.count("patristic.table_builds")
        tables = _TABLES[key] = PatristicTables(*_build_tables(tree))
    return tables


def _build_tables(tree: Tree):
    """(dn, dl, dist): diagnostics.patristic_distance_series's lines up to
    its per-(node, leaf) tables, unchanged."""
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
    return dn, dl, np.array(tree.dist, dtype=np.float64)


def patristic_series_plain(tables: PatristicTables, nodes: np.ndarray,
                           pos: np.ndarray) -> np.ndarray:
    """[S] f64: diagnostics.patristic_distance_series's arithmetic on the
    cached tables."""
    dn, dl = tables.dn, tables.dl
    pob = tables.dist[nodes] * (1.0 - pos)  # posonbranch per sample
    node_side = dn[nodes] - pob[:, None]  # [S, n_leaves]
    total = node_side + dl[nodes]
    valid = node_side >= 0.0
    diff = np.where(valid, total - 1.0, 0.0)
    return np.sqrt((diff * diff).sum(axis=1))


def patristic_distance_series(tables: PatristicTables, nodes: np.ndarray,
                              pos: np.ndarray, device) -> np.ndarray:
    """[S] host f64: the series of the states (nodes[s], pos[s]), host
    arrays (a source's column of a trace). On a CPU device the plain
    version; on a CUDA device an upload of nodes (int32) and pos (f64),
    one launch of patristic_series_kernel on the current stream and the
    download, which synchronizes. Any other device raises."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return patristic_series_plain(tables, nodes, pos)
    if dev.type != "cuda":
        raise ValueError(f"patristic series: unsupported device {dev}")
    from .._native import patristic_lib

    nodes, pos = np.asarray(nodes), np.asarray(pos)
    n_nodes, n_leaves = tables.dn.shape
    S = len(nodes)
    if nodes.shape != (S,) or pos.shape != (S,):
        raise ValueError(f"patristic series: nodes {nodes.shape} and pos "
                         f"{pos.shape}, not two [S] columns")
    if S and (nodes.min() < 0 or nodes.max() >= n_nodes):
        raise ValueError(f"patristic series: node ids outside the tree's "
                         f"{n_nodes} nodes")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    out = torch.empty(S, dtype=torch.float64, device=dev)
    if S:
        dn, dl, dist = tables.on(dev)
        nodes_t = torch.from_numpy(
            np.ascontiguousarray(nodes, dtype=np.int32)).to(dev)
        pos_t = torch.from_numpy(
            np.ascontiguousarray(pos, dtype=np.float64)).to(dev)
        ptr = [ctypes.c_void_p(t.data_ptr())
               for t in (dn, dl, dist, nodes_t, pos_t, out)]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = patristic_lib().patristic_series_launch(
                *ptr[:5], n_leaves, S, ptr[5], ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"patristic_series kernel launch failed: "
                               f"CUDA error {rc}")
        LAUNCHES["patristic_series"] += 1
        PROFILER.count("patristic.card_states", S)
    return out.cpu().numpy()
