"""The benchmark's worlds and reads as the program's own types."""
from __future__ import annotations

import numpy as np

from .. import world as W
from ..reference import align as ra


def program_graph(world: W.World):
    """The world as the program's PackedGraph (forward strand only)."""
    from vgan_tpu_torch.graph.packed import PackedGraph

    ids = sorted(world.segments)
    min_id = ids[0]
    n = ids[-1] - min_id + 1
    lens = np.zeros(n, dtype=np.int64)
    for i in ids:
        lens[i - min_id] = len(world.segments[i])
    off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=off[1:])
    pool = np.zeros(int(off[-1]), dtype=np.uint8)
    for i in ids:
        pool[off[i - min_id]:off[i - min_id + 1]] = ra.encode(world.segments[i])
    steps = [np.array([x - min_id for x in p], dtype=np.int32)
             for _n, p in world.paths]
    support = np.zeros((n, len(steps)), dtype=bool)
    for j, s in enumerate(steps):
        support[s, j] = True
    e = np.array(world.links, dtype=np.int64) - min_id
    return PackedGraph(
        min_id=min_id, node_seq_pool=pool, node_off=off,
        edge_from=e[:, 0].astype(np.int32),
        edge_from_rev=np.zeros(len(e), dtype=bool),
        edge_to=e[:, 1].astype(np.int32),
        edge_to_rev=np.zeros(len(e), dtype=bool),
        path_names=[p[0] for p in world.paths], path_steps_node=steps,
        path_steps_rev=[np.zeros(len(s), dtype=bool) for s in steps],
        path_support=support)


def program_reads(reads: W.Reads, prefix: str):
    from vgan_tpu_torch.io.fastx import Read

    return [Read(name=f"{prefix}r{i}", seq=s, qual=q)
            for i, (s, q) in enumerate(zip(reads.seqs, reads.quals))]
