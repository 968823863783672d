# Copied unchanged from vgan_tpu/io/gbz.py; its relative imports resolve to this package.
"""GBZ (GBWT + GBWTGraph) reader -> PackedGraph.

Decodes the index family giraffe consumes in HaploCart mode
(`vgan haplocart` maps against `graph.giraffe.gbz`,
`src/map_giraffe.cpp:41-55`). The format is the simple-sds
serialization of jltsiren's GBZ: every structure is a little-endian
u64 stream —

    Vec<u64>      {n_words, words}
    RawVector     {len_bits, Vec<u64>}
    BitVector     {RawVector, Option(rank), Option(select), Option(select0)}
    IntVector     {len_items, width, RawVector}
    SparseVector  {universe, ones, high: BitVector, low: IntVector}
                  (Elias-Fano: value_i = (select(i) - i) << low_width | low_i)
    StringArray   {index: SparseVector(start offsets), alphabet
                  {len, bytes}, symbols: IntVector}
    Option<T>     {n_words, body} — n_words=0 when absent

File layout (verified byte-exact on the bundled fixture
`test/input_files/target.giraffe.gbz`):

    GBZ:   {tag 0x205A4247, version u32, flags u64}, Tags(StringArray),
           GBWT, GraphZ
    GBWT:  {tag 0x6B376B37, version u32, sequences, size, offset,
           alphabet_size, flags}, Tags, BWT{index: SparseVector(record
           byte offsets), data: bytes}, Option(DA samples),
           Option(Metadata)
    Metadata: {tag 0x6B375E7A, version u32, sample_count,
           haplotype_count, contig_count, flags}, Vec<PathName{sample
           u32, contig u32, phase u32, count u32}>, sample names
           (StringArray), contig names (StringArray)
    GraphZ: {tag 0x6B3764AF, version u32, nodes, flags},
           sequences (StringArray, forward node sequences in id order),
           Option(node-to-segment translation)

GBWT record encoding (ByteCode = LEB128, 7 bits/byte, msb = continue):
    outdegree sigma, then sigma edges (node gap-coded from 0, offset),
    then runs — sigma < 255: one byte c, rank = c % sigma,
    len = c/sigma + 1, with c/sigma == 255/sigma meaning an extra
    ByteCode length follows; sigma >= 255: ByteCode pair (rank, len-1).
GBWT node space: gbwt_node = 2 * node_id + orientation; record 0 is
the endmarker, record i>0 is gbwt_node (offset + i). Sequence 2p is
the forward orientation of path p (bidirectional index).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils import dna

GBZ_TAG = 0x205A4247
GBWT_TAG = 0x6B376B37
METADATA_TAG = 0x6B375E7A
GRAPH_TAG = 0x6B3764AF


class _Reader:
    def __init__(self, buf: bytes, pos: int = 0):
        self.b = buf
        self.p = pos

    def u64(self) -> int:
        v = struct.unpack_from("<Q", self.b, self.p)[0]
        self.p += 8
        return v

    def words(self, n: int) -> np.ndarray:
        out = np.frombuffer(self.b, dtype="<u8", count=n, offset=self.p)
        self.p += 8 * n
        return out

    def bytes_padded(self, n: int) -> bytes:
        out = self.b[self.p : self.p + n]
        self.p += 8 * ((n + 7) // 8)
        return out


def _vec_u64(r: _Reader) -> np.ndarray:
    return r.words(r.u64())


def _raw_vector(r: _Reader) -> Tuple[int, np.ndarray]:
    bits = r.u64()
    return bits, _vec_u64(r)


def _bit_vector(r: _Reader) -> Tuple[int, np.ndarray]:
    bits, w = _raw_vector(r)
    for _ in range(3):  # rank / select / select0 support Options
        skip = r.u64()  # NB: r.u64() moves r.p — evaluate before +=
        r.p += 8 * skip
    return bits, w


def _unpack_ints(n: int, width: int, w: np.ndarray) -> np.ndarray:
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    bits = np.unpackbits(
        w.view(np.uint8), bitorder="little"
    )[: n * width].reshape(n, width)
    return (bits.astype(np.int64) << np.arange(width, dtype=np.int64)).sum(
        axis=1
    )


def _int_vector(r: _Reader) -> np.ndarray:
    n = r.u64()
    width = r.u64()
    bits, w = _raw_vector(r)
    if bits != n * width:
        raise ValueError("IntVector length mismatch")
    return _unpack_ints(n, width, w)


def _sparse_values(r: _Reader) -> np.ndarray:
    """SparseVector -> sorted values of the set bits."""
    universe = r.u64()  # noqa: F841  (length of the conceptual bitvec)
    ones = r.u64()
    hbits, hw = _bit_vector(r)
    n = r.u64()
    low_width = r.u64()
    bits, w = _raw_vector(r)
    lows = _unpack_ints(n, low_width, w)
    if ones == 0:
        return np.zeros(0, dtype=np.int64)
    allbits = np.unpackbits(hw.view(np.uint8), bitorder="little")[:hbits]
    pos = np.nonzero(allbits)[0]
    if len(pos) != ones:
        raise ValueError("SparseVector high/ones mismatch")
    high = pos - np.arange(ones)
    return (high.astype(np.int64) << low_width) | lows


def _string_array(r: _Reader) -> List[str]:
    starts = _sparse_values(r)
    alpha_len = r.u64()
    alpha = r.bytes_padded(alpha_len)
    syms = _int_vector(r)
    s = bytes(alpha[i] for i in syms)
    out = []
    for i in range(len(starts)):
        end = int(starts[i + 1]) if i + 1 < len(starts) else len(s)
        out.append(s[int(starts[i]) : end].decode())
    return out


# --------------------------------------------------------------- GBWT records
def _bytecode(buf: bytes, p: int) -> Tuple[int, int]:
    v = 0
    s = 0
    while True:
        c = buf[p]
        p += 1
        v |= (c & 0x7F) << s
        if not (c & 0x80):
            return v, p
        s += 7


class _Record:
    __slots__ = ("edges", "runs")

    def __init__(self, buf: bytes):
        p = 0
        sigma, p = _bytecode(buf, p)
        edges = []
        prev = 0
        for _ in range(sigma):
            d, p = _bytecode(buf, p)
            prev += d
            off, p = _bytecode(buf, p)
            edges.append((prev, off))
        runs: List[Tuple[int, int]] = []
        if sigma:
            max_code = 255 // sigma if sigma < 255 else 0
            while p < len(buf):
                if sigma < 255:
                    c = buf[p]
                    p += 1
                    rank = c % sigma
                    code = c // sigma
                    if code < max_code:
                        ln = code + 1
                    else:
                        extra, p = _bytecode(buf, p)
                        ln = max_code + extra + 1
                else:
                    rank, p = _bytecode(buf, p)
                    ln, p = _bytecode(buf, p)
                    ln += 1
                runs.append((rank, ln))
        self.edges = edges
        self.runs = runs

    def lf(self, pos: int) -> Tuple[int, int]:
        """(next_gbwt_node, next_offset) from offset `pos` here."""
        seen: Dict[int, int] = {}
        at = 0
        for rank, ln in self.runs:
            if pos < at + ln:
                node, off = self.edges[rank]
                return node, off + seen.get(rank, 0) + (pos - at)
            seen[rank] = seen.get(rank, 0) + ln
            at += ln
        raise IndexError("LF offset out of record")


class GBZ:
    """Decoded GBZ: node sequences, topology (path-covered edges),
    haplotype paths with names."""

    def __init__(
        self,
        node_seqs: Dict[int, str],
        edges: List[Tuple[int, bool, int, bool]],
        paths: List[Tuple[str, List[Tuple[int, bool]]]],
    ):
        self.node_seqs = node_seqs
        self.edges = edges
        self.paths = paths

    def to_packed_graph(self, meta: Optional[dict] = None):
        from ..graph.packed import PackedGraph

        ids = sorted(self.node_seqs)
        min_id = ids[0]
        n_nodes = ids[-1] - min_id + 1
        lens = np.zeros(n_nodes, dtype=np.int64)
        for nid in ids:
            lens[nid - min_id] = len(self.node_seqs[nid])
        node_off = np.zeros(n_nodes + 1, dtype=np.int64)
        np.cumsum(lens, out=node_off[1:])
        pool = np.zeros(int(node_off[-1]), dtype=np.uint8)
        for nid in ids:
            i = nid - min_id
            pool[node_off[i] : node_off[i + 1]] = dna.encode(
                self.node_seqs[nid]
            )
        path_names = [p[0] for p in self.paths]
        steps_node = [
            np.array([nid - min_id for nid, _ in p[1]], dtype=np.int32)
            for p in self.paths
        ]
        steps_rev = [
            np.array([rev for _, rev in p[1]], dtype=bool)
            for p in self.paths
        ]
        support = np.zeros((n_nodes, len(self.paths)), dtype=bool)
        for j, sn in enumerate(steps_node):
            support[sn, j] = True
        ef = np.array([e[0] - min_id for e in self.edges], dtype=np.int32)
        efr = np.array([e[1] for e in self.edges], dtype=bool)
        et = np.array([e[2] - min_id for e in self.edges], dtype=np.int32)
        etr = np.array([e[3] for e in self.edges], dtype=bool)
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
            meta=meta or {"source": "gbz"},
        )


class _GBWTIndex:
    """Parsed GBWT: record access + path extraction + edge set."""

    def __init__(self, sequences, offset, alphabet_size, record_of,
                 n_records, path_names):
        self.sequences = sequences
        self.offset = offset
        self.alphabet_size = alphabet_size
        self.record_of = record_of
        self.n_records = n_records
        self.path_names = path_names

    def extract_paths(self) -> List[Tuple[str, List[Tuple[int, bool]]]]:
        n_fwd = self.sequences // 2
        paths = []
        for p in range(n_fwd):
            gnode, pos = self.record_of(0).lf(2 * p)
            steps: List[Tuple[int, bool]] = []
            while gnode != 0:
                steps.append((gnode >> 1, bool(gnode & 1)))
                gnode, pos = self.record_of(gnode).lf(pos)
            name = (
                self.path_names[p]
                if p < len(self.path_names)
                else f"path_{p}"
            )
            paths.append((name, steps))
        return paths

    def edge_list(self) -> List[Tuple[int, bool, int, bool]]:
        edge_set = set()
        for idx in range(1, self.n_records):
            gnode = self.offset + idx
            for succ, _off in self.record_of(gnode).edges:
                if succ == 0:
                    continue
                a = (gnode >> 1, bool(gnode & 1))
                b = (succ >> 1, bool(succ & 1))
                ra = (b[0], not b[1])
                rb = (a[0], not a[1])
                edge_set.add(min((a, b), (ra, rb)))
        return [(a[0], a[1], b[0], b[1]) for a, b in sorted(edge_set)]


def _parse_gbwt_body(r: _Reader) -> _GBWTIndex:
    """GBWT serialization after the tag|version word."""
    sequences = r.u64()
    r.u64()  # total size
    offset = r.u64()
    alphabet_size = r.u64()
    r.u64()  # flags
    _string_array(r)  # GBWT tags
    rec_starts = _sparse_values(r)
    nb = r.u64()
    bwt_bytes = r.bytes_padded(nb)
    n_records = alphabet_size - offset
    if len(rec_starts) != n_records:
        raise ValueError("BWT record count mismatch")
    bounds = np.append(rec_starts, nb)
    records: Dict[int, _Record] = {}

    def record_of(gnode: int) -> _Record:
        idx = 0 if gnode == 0 else gnode - offset
        rec = records.get(idx)
        if rec is None:
            rec = _Record(
                bwt_bytes[int(bounds[idx]) : int(bounds[idx + 1])]
            )
            records[idx] = rec
        return rec

    skip = r.u64()  # Option: DA samples
    r.p += 8 * skip
    meta_words = r.u64()
    meta_end = r.p + 8 * meta_words
    path_names_meta: List[str] = []
    if meta_words:
        mh = r.u64()
        if mh & 0xFFFFFFFF != METADATA_TAG:
            raise ValueError("GBWT metadata tag mismatch")
        r.u64()  # sample_count
        r.u64()  # haplotype_count
        r.u64()  # contig_count
        r.u64()  # flags
        n_paths_meta = r.u64()
        raw_names = []
        for _ in range(n_paths_meta):
            w1 = r.u64()
            w2 = r.u64()
            raw_names.append(
                (
                    w1 & 0xFFFFFFFF,  # sample
                    w1 >> 32,  # contig
                    w2 & 0xFFFFFFFF,  # phase
                    w2 >> 32,  # count
                )
            )
        # names are Dictionaries: {StringArray, sorted_ids: IntVector}
        sample_names = _string_array(r)
        _int_vector(r)  # sorted ids (binary-search support)
        contig_names = _string_array(r)
        _int_vector(r)
        for s, c, ph, cnt in raw_names:
            sn = sample_names[s] if s < len(sample_names) else str(s)
            cn = contig_names[c] if c < len(contig_names) else str(c)
            # giraffe-style naming: generic samples surface the contig
            # name alone (the toy graph: seq_1..seq_5)
            if sn in ("", "_gbwt_ref", "unknown") or len(sample_names) <= 1:
                path_names_meta.append(cn)
            else:
                name = f"{sn}#{ph}#{cn}" if ph else f"{sn}#{cn}"
                path_names_meta.append(name)
        r.p = meta_end
    return _GBWTIndex(sequences, offset, alphabet_size, record_of,
                      n_records, path_names_meta)


def read_gbwt(path: str) -> _GBWTIndex:
    """Standalone .gbwt file (simple-sds flavor — the serialization of
    the bundled fixtures and of vg's gbwt builds with simple-sds on)."""
    data = open(path, "rb").read()
    r = _Reader(data)
    h = r.u64()
    if h & 0xFFFFFFFF != GBWT_TAG:
        raise ValueError(f"{path}: not a (simple-sds) GBWT file")
    return _parse_gbwt_body(r)


def read_gbz(path: str) -> GBZ:
    data = open(path, "rb").read()
    r = _Reader(data)
    hdr = r.u64()
    if hdr & 0xFFFFFFFF != GBZ_TAG:
        raise ValueError(f"{path}: not a GBZ file")
    r.u64()  # flags
    _string_array(r)  # GBZ tags

    # ---- GBWT
    h = r.u64()
    if h & 0xFFFFFFFF != GBWT_TAG:
        raise ValueError("GBWT section tag mismatch")
    gbwt = _parse_gbwt_body(r)
    sequences = gbwt.sequences
    offset = gbwt.offset
    record_of = gbwt.record_of
    n_records = gbwt.n_records
    path_names_meta = gbwt.path_names

    # ---- GraphZ
    gh = r.u64()
    if gh & 0xFFFFFFFF != GRAPH_TAG:
        raise ValueError("GBWTGraph section tag mismatch")
    n_nodes = r.u64()
    r.u64()  # flags
    seq_strings = _string_array(r)
    if len(seq_strings) != n_nodes:
        raise ValueError("GraphZ node count mismatch")

    # node ids: records i>0 are gbwt nodes offset+i; gbwt node = 2*id+o
    first_node_id = (offset + 1 + 1) // 2
    node_ids = list(range(first_node_id, first_node_id + n_nodes))
    node_seqs = dict(zip(node_ids, seq_strings))

    # ---- extract forward paths by LF walk from the endmarker
    n_fwd = sequences // 2
    paths: List[Tuple[str, List[Tuple[int, bool]]]] = []
    for p in range(n_fwd):
        gnode, pos = 0, 2 * p
        steps: List[Tuple[int, bool]] = []
        rec = record_of(0)
        gnode, pos = rec.lf(pos)
        while gnode != 0:
            steps.append((gnode >> 1, bool(gnode & 1)))
            gnode, pos = record_of(gnode).lf(pos)
        name = (
            path_names_meta[p] if p < len(path_names_meta) else f"path_{p}"
        )
        paths.append((name, steps))

    # ---- edges: union of record successors over both orientations
    edge_set = set()
    for idx in range(1, n_records):
        gnode = offset + idx
        rec = record_of(gnode)
        for succ, _off in rec.edges:
            if succ == 0:
                continue
            a = (gnode >> 1, bool(gnode & 1))
            b = (succ >> 1, bool(succ & 1))
            # canonicalize: an edge and its reverse complement are one
            ra = (b[0], not b[1])
            rb = (a[0], not a[1])
            key = min((a, b), (ra, rb))
            edge_set.add(key)
    edges = [
        (a[0], a[1], b[0], b[1]) for a, b in sorted(edge_set)
    ]
    return GBZ(node_seqs, edges, paths)


def load_packed_graph(path: str):
    """GBZ file -> PackedGraph (build-db / load_db entry point)."""
    return read_gbz(path).to_packed_graph(meta={"source": "gbz"})


# ------------------------------------------------------------------- .gg
GG_MAGIC = b"GBG "


def read_gg_seqs(path: str) -> List[str]:
    """GBWTGraph .gg (sdsl flavor): 4-byte magic, header {tag u32
    0x6B3764AF, version u32, nodes u64, flags u64}, a StringArray of
    2*nodes oriented sequences ({total_chars u64, chars, offsets:
    sdsl::int_vector {size_bits u64, width u8, packed data}}).
    Returns the FORWARD sequence per node in id order (layout verified
    byte-exact on target.gg vs the GFA twin)."""
    import struct

    data = open(path, "rb").read()
    if data[:4] != GG_MAGIC:
        raise ValueError(f"{path}: not a .gg (GBWTGraph) file")
    tag, version = struct.unpack_from("<II", data, 4)
    if tag != GRAPH_TAG:
        raise ValueError(f"{path}: GBWTGraph tag mismatch")
    n_nodes = struct.unpack_from("<Q", data, 12)[0]
    # flags u64 at 20, chars length u64 at 28
    n_chars = struct.unpack_from("<Q", data, 28)[0]
    chars = data[36 : 36 + n_chars]
    p = 36 + n_chars
    size_bits = struct.unpack_from("<Q", data, p)[0]
    width = data[p + 8]
    raw = np.frombuffer(data, dtype=np.uint8, offset=p + 9)
    bits = np.unpackbits(raw, bitorder="little")[:size_bits]
    n = size_bits // width
    offs = (
        bits.reshape(n, width).astype(np.int64)
        << np.arange(width, dtype=np.int64)
    ).sum(axis=1)
    if n != 2 * n_nodes + 1:
        raise ValueError(f"{path}: offset count mismatch")
    return [
        chars[int(offs[2 * i]) : int(offs[2 * i + 1])].decode()
        for i in range(n_nodes)
    ]


def load_packed_graph_gg(gg_path: str, gbwt_path: Optional[str] = None):
    """<prefix>.gg + <prefix>.gbwt -> PackedGraph (the euka/soibean-era
    giraffe index pair, `src/map_giraffe_Euka.cpp:16-101`): node
    sequences from the .gg, topology + haplotype paths + names from the
    GBWT's records and metadata."""
    if gbwt_path is None:
        gbwt_path = gg_path[: -len(".gg")] + ".gbwt"
    seqs = read_gg_seqs(gg_path)
    gbwt = read_gbwt(gbwt_path)
    first_node_id = (gbwt.offset + 1 + 1) // 2
    node_seqs = {first_node_id + i: s for i, s in enumerate(seqs)}
    return GBZ(
        node_seqs, gbwt.edge_list(), gbwt.extract_paths()
    ).to_packed_graph(meta={"source": "gg+gbwt"})
