# Copied unchanged from vgan_tpu/utils/newick.py.
"""Newick tree parser -> flat arrays.

Replaces the vendored spimap (`dep/spimap`, used at
`src/soibean.cpp:567-594`) with a small parser producing the arrays the
TPU tree-MCMC consumes: parent[i], children (padded), dist[i],
longname[i]. Node indices follow spimap's convention of leaves first
(in parse order) then internal nodes, root last — only internal
consistency matters downstream (path names are the join key).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class _Node:
    name: str = ""
    dist: float = 0.0
    children: List["_Node"] = field(default_factory=list)
    parent: Optional["_Node"] = None
    index: int = -1


@dataclass
class Tree:
    names: List[str]
    parent: np.ndarray  # int32, -1 at root
    dist: np.ndarray  # float64
    children: np.ndarray  # int32 [n, max_children], -1 padded
    n_children: np.ndarray  # int32
    root: int

    @property
    def n_nodes(self) -> int:
        return len(self.names)

    def is_leaf(self, i: int) -> bool:
        return self.n_children[i] == 0

    @property
    def n_leaves(self) -> int:
        return int((self.n_children == 0).sum())

    def name_to_index(self):
        return {n: i for i, n in enumerate(self.names)}


def _tokenize(s: str):
    i = 0
    n = len(s)
    while i < n:
        c = s[i]
        if c in "(),;:":
            yield c
            i += 1
        elif c.isspace():
            i += 1
        else:
            j = i
            while j < n and s[j] not in "(),;:" and not s[j].isspace():
                j += 1
            yield s[i:j]
            i = j


def parse_newick(text: str) -> Tree:
    tokens = list(_tokenize(text))
    pos = 0

    def parse_clade() -> _Node:
        nonlocal pos
        node = _Node()
        if tokens[pos] == "(":
            pos += 1
            while True:
                child = parse_clade()
                child.parent = node
                node.children.append(child)
                if tokens[pos] == ",":
                    pos += 1
                    continue
                if tokens[pos] == ")":
                    pos += 1
                    break
        # optional label
        if pos < len(tokens) and tokens[pos] not in "(),;:":
            node.name = tokens[pos]
            pos += 1
        # optional :dist
        if pos < len(tokens) and tokens[pos] == ":":
            pos += 1
            node.dist = float(tokens[pos])
            pos += 1
        return node

    root = parse_clade()

    # spimap ordering: leaves first (parse order), then internals
    # post-order, root last
    leaves: List[_Node] = []
    internals: List[_Node] = []

    def collect(n: _Node):
        if not n.children:
            leaves.append(n)
        else:
            for c in n.children:
                collect(c)
            internals.append(n)

    collect(root)
    ordered = leaves + internals
    for i, n in enumerate(ordered):
        n.index = i

    N = len(ordered)
    maxc = max((len(n.children) for n in ordered), default=0)
    parent = np.full(N, -1, dtype=np.int32)
    dist = np.zeros(N, dtype=np.float64)
    children = np.full((N, max(maxc, 1)), -1, dtype=np.int32)
    n_children = np.zeros(N, dtype=np.int32)
    names = []
    for n in ordered:
        i = n.index
        names.append(n.name)
        dist[i] = n.dist
        if n.parent is not None:
            parent[i] = n.parent.index
        n_children[i] = len(n.children)
        for j, c in enumerate(n.children):
            children[i, j] = c.index
    return Tree(
        names=names,
        parent=parent,
        dist=dist,
        children=children,
        n_children=n_children,
        root=root.index,
    )


def read_newick(path: str) -> Tree:
    with open(path) as f:
        return parse_newick(f.read())
