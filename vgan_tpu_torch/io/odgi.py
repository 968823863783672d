# Copied unchanged from vgan_tpu/io/odgi.py; its relative imports resolve to this package.
"""bdsg ODGI (`.og`) binary graph reader.

The reference loads every euka/soibean/keelime database graph through
`bdsg::ODGI::deserialize` (`src/readOG_Euka.h:29-140`,
`src/readPathHandleGraph.cpp:14-37`), and the official vgan databases
are distributed in this format (`euka_db.og`, per-taxon soibean
graphs).  This module reads the same container directly into a
PackedGraph so those databases work without `vg view`/odgi installed.

Format (reverse-engineered from the bundled fixture
`test/reconstructInputSeq/target_graph.og`, whose GFA twin provides
exact ground truth; the layout mirrors bdsg's ODGI serialize):

  u32  magic 0x3479ADAB
  u64  _max_node_id   (internal rank space)
  u64  _min_node_id   (internal rank space)
  u64  node_v.size()
  u64  _edge_count
  u64  _path_count
  u64  _path_handle_next
  u64  _deleted_node_count
  u64  _id_increment   (external id = internal id + increment)
  u64  (reserved/0)
  node records x node_v.size():
    u32 seq_len, u32 edge_entries, u32 edge_count,
    u64 seq_plus_edge_bytes,
    seq bytes (ASCII),
    edge blob (LEB128 varints; `edge_entries` values = pairs of
      (zigzag delta to other node, type bits)); type bits:
      bit0 = this side reverse, bit1 = other side reverse,
      bit2 = edge points TO this node (incoming),
    step vector (fixed-width packed ints):
      u64 n_words, n_words x u64 data, u64 mask, u64 n_ints,
      u8 width_bits, u8 ints_per_word
      -- values packed LSB-first, `ints_per_word` per 64-bit word
         (no word-crossing); 5 ints per path step:
         (path_id<<1|is_rev, prev, prev_rank, next, next_rank)
         where prev/next = zigzag(delta)+2, 0 = path start,
         1 = path end; zigzag(d) = 2|d| + (d<0)
  <auxiliary structures: deleted-id bitvector etc.; skipped by
   scanning for the path-metadata section (see _find_metadata)>
  u64 path_metadata count, then per path:
    u64 length, u64 first_id (internal<<1|rev), u64 first_rank,
    u64 last_id, u64 last_rank, u64 name_len, name bytes
  u64 name-map count, then per path:
    u64 name_len, name bytes, u64 path_id+1

Paths are reconstructed by walking the per-node step linked lists
from each path's first (node, rank) anchor.  Every decoded structure
is cross-checked (path lengths vs metadata, final step vs last
anchor, edge count vs header) so a layout variant fails loudly
instead of producing a silently wrong graph.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

from ..graph.packed import PackedGraph
from ..utils import dna

MAGIC = 0x3479ADAB
STEP_FIELDS = 5
STEP_PATH_BEGIN = 0
STEP_PATH_END = 1


def _leb128(blob: bytes, count: int) -> List[int]:
    """Decode `count` LEB128 varints; require the blob fully consumed."""
    vals = []
    p = 0
    for _ in range(count):
        shift = 0
        v = 0
        while True:
            b = blob[p]
            p += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        vals.append(v)
    if p != len(blob):
        raise ValueError(
            f"odgi edge blob: {len(blob) - p} undecoded bytes "
            f"(varint layout mismatch)"
        )
    return vals


def _unzigzag(z: int) -> int:
    return -(z >> 1) if z & 1 else z >> 1


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.p = 0

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.data, self.p)
        self.p += 4
        return v

    def u64(self) -> int:
        (v,) = struct.unpack_from("<Q", self.data, self.p)
        self.p += 8
        return v

    def raw(self, n: int) -> bytes:
        out = self.data[self.p : self.p + n]
        if len(out) != n:
            raise ValueError("odgi: truncated file")
        self.p += n
        return out

    def packed_ints(self) -> List[int]:
        n_words = self.u64()
        words = struct.unpack_from(f"<{n_words}Q", self.data, self.p)
        self.p += 8 * n_words
        mask = self.u64()
        n_ints = self.u64()
        width = self.data[self.p]
        ipw = self.data[self.p + 1]
        self.p += 2
        if n_ints == 0:
            return []
        if ipw == 0 or width == 0:
            raise ValueError("odgi: zero-width packed vector with entries")
        if (n_ints + ipw - 1) // ipw > n_words:
            raise ValueError("odgi: packed vector shorter than its size")
        return [
            (words[i // ipw] >> (width * (i % ipw))) & mask
            for i in range(n_ints)
        ]


def _find_metadata(data: bytes, start: int, n_paths: int):
    """Locate and parse the path-metadata + name-map tail sections.

    The structures between the node records and the metadata
    (deleted-id bitvector and friends) are irrelevant for a read-only
    load, so instead of decoding them we scan forward for the unique
    offset at which a strict parse of both tail sections consumes the
    file exactly.
    """
    n = len(data)
    target = struct.pack("<Q", n_paths)
    pos = data.find(target, start)
    while pos != -1:
        meta = _try_parse_tail(data, pos, n_paths, n)
        if meta is not None:
            return meta
        pos = data.find(target, pos + 1)
    raise ValueError("odgi: path metadata section not found")


def _try_parse_tail(data, pos, n_paths, n):
    try:
        r = _Reader(data)
        r.p = pos
        if r.u64() != n_paths:
            return None
        metas = []
        for _ in range(n_paths):
            length = r.u64()
            first_id, first_rank = r.u64(), r.u64()
            last_id, last_rank = r.u64(), r.u64()
            name_len = r.u64()
            if name_len > n - r.p or name_len == 0 or name_len > 4096:
                return None
            name = r.raw(name_len).decode("utf-8")
            metas.append((length, first_id, first_rank, last_id, last_rank, name))
        if r.u64() != n_paths:
            return None
        ids = {}
        for _ in range(n_paths):
            name_len = r.u64()
            if name_len > n - r.p or name_len == 0 or name_len > 4096:
                return None
            name = r.raw(name_len).decode("utf-8")
            pid_plus1 = r.u64()
            if not 1 <= pid_plus1 <= n_paths:
                return None
            ids[name] = pid_plus1 - 1
        if r.p != n:
            return None
        if set(ids) != {m[5] for m in metas}:
            return None
        return metas, ids
    except (struct.error, UnicodeDecodeError, ValueError):
        return None


def read_og(path: str, meta: Dict | None = None) -> PackedGraph:
    data = open(path, "rb").read()
    r = _Reader(data)
    if r.u32() != MAGIC:
        raise ValueError(f"{path}: not an ODGI file (bad magic)")
    r.u64()  # _max_node_id (internal)
    r.u64()  # _min_node_id (internal)
    n_nodes = r.u64()
    edge_count_hdr = r.u64()
    n_paths = r.u64()
    r.u64()  # _path_handle_next
    n_deleted = r.u64()
    id_increment = r.u64()
    r.u64()  # reserved
    if n_deleted:
        raise ValueError(
            f"{path}: graph has {n_deleted} deleted nodes; re-serialize "
            "with `odgi sort`/`vg convert` to compact it first"
        )

    sequences: List[str] = []
    node_edges: List[List[Tuple[int, int]]] = []
    node_steps: List[List[Tuple[int, ...]]] = []
    for _ in range(n_nodes):
        seq_len = r.u32()
        edge_entries = r.u32()
        r.u32()  # edge count (= edge_entries // 2)
        blob_len = r.u64()
        seq = r.raw(seq_len).decode("ascii")
        edge_vals = _leb128(r.raw(blob_len - seq_len), edge_entries)
        ints = r.packed_ints()
        if len(ints) % STEP_FIELDS:
            raise ValueError("odgi: step vector not a multiple of 5 ints")
        sequences.append(seq)
        node_edges.append(list(zip(edge_vals[0::2], edge_vals[1::2])))
        node_steps.append(
            [tuple(ints[i : i + STEP_FIELDS]) for i in range(0, len(ints), STEP_FIELDS)]
        )

    metas, _name_ids = _find_metadata(data, r.p, n_paths)

    # ---- edges: each edge is recorded on both endpoints; keep one
    # canonical copy. type bits: bit0 this-side rev, bit1 other rev,
    # bit2 incoming.
    edge_set = {}
    for internal, entries in enumerate(node_edges):
        for zz, etype in entries:
            other = internal + _unzigzag(zz)
            on_rev = bool(etype & 1)
            other_rev = bool(etype & 2)
            to_curr = bool(etype & 4)
            if to_curr:
                e = (other, other_rev, internal, on_rev)
            else:
                e = (internal, on_rev, other, other_rev)
            flip = (e[2], not e[3], e[0], not e[1])
            edge_set[min(e, flip)] = e
    edges = sorted(edge_set.values())
    if edge_count_hdr and len(edges) != edge_count_hdr:
        raise ValueError(
            f"odgi: decoded {len(edges)} edges, header says {edge_count_hdr}"
        )

    # ---- paths: walk the per-node step linked lists
    paths: List[Tuple[str, List[Tuple[int, bool]]]] = []
    for length, first_id, first_rank, last_id, last_rank, name in metas:
        steps: List[Tuple[int, bool]] = []
        node = first_id >> 1
        rank = first_rank
        for _ in range(length):
            st = node_steps[node][rank]
            steps.append((node + id_increment, bool(st[0] & 1)))
            nxt = st[3]
            if nxt == STEP_PATH_END:
                break
            node = node + _unzigzag(nxt - 2)
            rank = st[4]
        if len(steps) != length:
            raise ValueError(f"odgi: path {name} truncated at {len(steps)}/{length}")
        if node != last_id >> 1 or rank != last_rank:
            raise ValueError(f"odgi: path {name} does not end at its anchor")
        paths.append((name, steps))

    # ---- pack (same construction as PackedGraph.from_gfa)
    min_id = id_increment
    lens = np.array([len(s) for s in sequences], dtype=np.int64)
    node_off = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(lens, out=node_off[1:])
    pool = np.zeros(int(node_off[-1]), dtype=np.uint8)
    for i, s in enumerate(sequences):
        pool[node_off[i] : node_off[i + 1]] = dna.encode(s.upper())

    path_names = [p[0] for p in paths]
    steps_node = [
        np.array([nid - min_id for nid, _ in p[1]], dtype=np.int32) for p in paths
    ]
    steps_rev = [np.array([rev for _, rev in p[1]], dtype=bool) for p in paths]
    support = np.zeros((n_nodes, len(paths)), dtype=bool)
    for j, sn in enumerate(steps_node):
        support[sn, j] = True

    ef = np.array([e[0] for e in edges], dtype=np.int32)
    efr = np.array([e[1] for e in edges], dtype=bool)
    et = np.array([e[2] for e in edges], dtype=np.int32)
    etr = np.array([e[3] for e in edges], dtype=bool)

    return PackedGraph(
        min_id=min_id,
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
        meta=meta or {},
    )
