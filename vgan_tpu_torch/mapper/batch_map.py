# Copied from vgan_tpu/mapper/batch_map.py; imports repointed to this package,
# the device phase swapped to mapper/sw.py (torch tensors, CUDA kernel);
# the module's stage-time sums replaced by PROFILER's mapper.* spans.
"""Fully-vectorized batch mapping path (host side).

The production fast path behind `BatchedMapper.map_reads`: seeding,
candidate packing, content dedup, winner selection and GAM projection
all run as numpy array passes + ONE native C++ call
(cpp/mapfinalize.cpp) — no per-read Python loops. The device scores
every candidate window in one `sw.gather_score_hash` launch, exactly
like the object-based path it replaces (giraffe.py::_gather_candidates),
and produces identical alignments.

This is the TPU-native replacement for the reference's in-process
`vg giraffe` invocation (`src/map_giraffe.cpp:82-86`): the reference
maps reads with OpenMP threads inside vg; here the alignment-scoring
FLOPs ride the TPU and the irregular finalize work is one C++ batch
call on the host.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np
import torch

from ..io import gam
from ..utils import dna
from ..utils.profiling import PROFILER
from .align import FULL_LENGTH_BONUS
from .index import _path_codes

_POW1 = None
_POW2 = None


def _pows(n: int):
    """Powers of two odd 32-bit bases for the content-dedup hash
    (wrapping mod 2^32), as int32 bit patterns for the device hash
    (sw.gather_score_hash)."""
    global _POW1, _POW2
    if _POW1 is None or len(_POW1) < n:
        m = max(n, 512)

        def mk(base):
            x = np.full(m, base, dtype=np.uint64)
            x[0] = 1
            acc = np.multiply.accumulate(x) & np.uint64(0xFFFFFFFF)
            return acc.astype(np.uint32).view(np.int32)

        _POW1 = mk(0x9E3779B9)
        _POW2 = mk(0x85EBCA77)
    return _POW1[:n], _POW2[:n]


def _pack_reads_mat(read_buf, read_off, read_lens, n_rows: int,
                    width: int) -> np.ndarray:
    """[n_rows, width] uint8 matrix, row i = read i's codes, 255-padded
    (vectorized scatter from the packed buffer — no per-read loop)."""
    n_reads = len(read_lens)
    mat = np.full((n_rows, width), 255, dtype=np.uint8)
    total = int(read_lens.sum())
    if total == 0:
        return mat
    rows = np.repeat(np.arange(n_reads, dtype=np.int64), read_lens)
    cols = np.arange(total, dtype=np.int64) - np.repeat(
        read_off[:-1], read_lens
    )
    mat.ravel()[rows * width + cols] = read_buf
    return mat


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _bucket_rows(n: int) -> int:
    """Row-count bucket for the device scorer (limits recompiles)."""
    b = 512
    while b < n:
        b *= 2
    return b


# ---------------------------------------------------------------- native lib
_lib = None


def load_native():
    """The native host library with the mapper's entry points typed
    (built by _native.host_lib; raises when it cannot be built)."""
    global _lib
    if _lib is None:
        from .._native import host_lib

        lib = host_lib()
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.map_finalize_batch.restype = ctypes.c_int64
        lib.map_finalize_batch.argtypes = [
            u8p, i64p, ctypes.c_int64,                       # reads
            u8p, f32p, f32p, u8p, i32p, u8p, i64p, i64p, i32p, i32p,  # winners (+mq override)
            u8p, i64p,                                       # path codes
            i32p, u8p, i64p, i64p, i64p,                     # path steps
            i64p, ctypes.c_int64,                            # node_len, min_id
            u8p, i64p, i64p, i64p, i32p, i64p,               # window ref+CSR
            i32p, i32p, i32p, u8p, i64p,                     # window pos+handles
            i32p, f64p, i32p, i32p,                          # per-read out
            i64p, i32p, u8p, i32p, ctypes.c_int64,           # mappings out
            i32p, i32p, i32p, ctypes.c_int64,                # edits out
            ctypes.c_char_p, ctypes.c_int64,                 # eseq out
            i64p,                                            # counts
        ]
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.batch_seed_hits.restype = ctypes.c_int64
        lib.batch_seed_hits.argtypes = [
            u8p, i64p, ctypes.c_int64,                       # reads
            ctypes.c_int32, ctypes.c_int32,                  # k, ry
            u64p, ctypes.c_int64, i64p,                      # index hashes
            i32p, i64p, u8p,                                 # postings
            i32p, i32p, u8p, i64p, ctypes.c_int64,           # hits out
        ]
        _lib = lib
    return _lib


def _p(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


# ---------------------------------------------------------------- pools
class PoolSnapshot:
    """Immutable view of the pooled path arrays at one point in time.

    Holders (including a finalize running on a worker thread while the
    main thread submits the next chunk) stay consistent even if the
    pools rebuild afterwards — a rebuild makes a NEW snapshot and never
    mutates an existing one."""

    __slots__ = (
        "pc_buf", "pc_beg", "pc_len", "st_beg", "st_cnt",
        "ps_node", "ps_rev", "ps_start", "node_len", "_dev_pc",
    )

    def device_pc(self, device) -> torch.Tensor:
        """pc_buf as a resident uint8 tensor on `device`, cached on the
        snapshot (rebuilt only when a new path is touched)."""
        if self._dev_pc is None or self._dev_pc.device != device:
            self._dev_pc = torch.from_numpy(self.pc_buf).to(device)
        return self._dev_pc


class NativePools:
    """Concatenated per-path code/step pools shared with the C++ call.

    Grows lazily as paths are touched; rebuilt (cheap concat) only when
    a new path appears. ensure/arrays are lock-guarded so the streaming
    pipeline may finalize one chunk on a worker thread while the main
    thread seeds the next."""

    def __init__(self, graph, path_cache):
        import threading

        self.graph = graph
        self.codes = path_cache  # path -> codes (shared with mapper)
        self._steps = {}
        self._dirty = True
        self._lock = threading.Lock()
        self._snap = None
        self.node_len = np.ascontiguousarray(
            np.diff(graph.node_off).astype(np.int64)
        )

    def ensure(self, paths) -> None:
        g = self.graph
        with self._lock:
            for p in paths:
                p = int(p)
                if p not in self.codes:
                    self.codes[p] = _path_codes(g, p)
                    self._dirty = True
                if p not in self._steps:
                    self._steps[p] = (
                        np.ascontiguousarray(
                            g.path_steps_node[p], dtype=np.int32
                        ),
                        np.ascontiguousarray(
                            g.path_steps_rev[p], dtype=np.uint8
                        ),
                        np.ascontiguousarray(
                            g.step_offsets(p), dtype=np.int64
                        ),
                    )
                    self._dirty = True

    def arrays(self) -> PoolSnapshot:
        with self._lock:
            if self._dirty or self._snap is None:
                n_paths = self.graph.n_paths
                s = PoolSnapshot()
                s.pc_beg = np.zeros(n_paths, dtype=np.int64)
                s.pc_len = np.zeros(n_paths, dtype=np.int64)
                s.st_beg = np.zeros(n_paths, dtype=np.int64)
                s.st_cnt = np.zeros(n_paths, dtype=np.int64)
                s.node_len = self.node_len
                s._dev_pc = None
                keys = sorted(self._steps)
                pc_parts, sn_parts, sr_parts, ss_parts = [], [], [], []
                pc_pos = st_pos = 0
                for p in keys:
                    c = self.codes[p]
                    sn, sr, ss = self._steps[p]
                    s.pc_beg[p] = pc_pos
                    s.pc_len[p] = len(c)
                    s.st_beg[p] = st_pos
                    s.st_cnt[p] = len(sn)
                    pc_pos += len(c)
                    st_pos += len(sn)
                    pc_parts.append(c)
                    sn_parts.append(sn)
                    sr_parts.append(sr)
                    ss_parts.append(ss)
                s.pc_buf = (
                    np.ascontiguousarray(np.concatenate(pc_parts))
                    if pc_parts
                    else np.zeros(0, dtype=np.uint8)
                )
                s.ps_node = (
                    np.concatenate(sn_parts)
                    if sn_parts else np.zeros(0, np.int32)
                )
                s.ps_rev = (
                    np.concatenate(sr_parts)
                    if sr_parts else np.zeros(0, np.uint8)
                )
                s.ps_start = (
                    np.concatenate(ss_parts)
                    if ss_parts else np.zeros(0, np.int64)
                )
                self._dirty = False
                self._snap = s
            return self._snap


def _pack_window(win):
    """(ref, pred_off, pred_idx, pos_handle, pos_offset, h_node, h_rev)
    cached on the Window object."""
    packed = getattr(win, "_packed", None)
    if packed is None:
        from .graph_align import _window_csr

        ref, off, idx = _window_csr(win)
        h_node = np.array([h[0] for h in win.handles], dtype=np.int32)
        h_rev = np.array([1 if h[1] else 0 for h in win.handles],
                         dtype=np.uint8)
        packed = (
            np.ascontiguousarray(ref),
            np.ascontiguousarray(off, dtype=np.int64),
            np.ascontiguousarray(idx, dtype=np.int32),
            np.ascontiguousarray(win.pos_handle, dtype=np.int32),
            np.ascontiguousarray(win.pos_offset, dtype=np.int32),
            h_node,
            h_rev,
        )
        win._packed = packed
    return packed


# ---------------------------------------------------------------- gather
class BatchResult:
    """Per-read winner table + candidate arrays from one gather pass."""

    __slots__ = (
        "read_codes", "read_lens", "read_buf", "read_off",
        "cand_read", "cand_path", "cand_strand",
        "cand_lo", "cand_wlen", "scores", "w_has", "w_cand", "w_second",
        "w_has2", "topk_rows", "topk_scores", "top2_score", "top2_has",
    )


class PendingGather:
    """In-flight device batch: host candidate arrays + the undownloaded
    device result. Produced by gather_submit, consumed by
    gather_collect — the split lets map_reads_table overlap the next
    chunk's host work (seed/pack) and the previous chunk's finalize
    with device execution (double-buffering, VERDICT r2 #1c)."""

    __slots__ = (
        "n_reads", "read_codes", "read_lens", "read_buf", "read_off",
        "c_read", "c_path", "c_strand", "lo", "L", "wlen", "dev", "m",
        "span_lo", "span_hi", "span_grp",
    )


def gather_and_score(mapper, reads, max_candidates: int = 8,
                     pad: int = 24) -> Optional[BatchResult]:
    """Seed + cluster + pack + dedup + device-score + winner-select for
    a whole batch, all as array passes. Returns None when nothing
    seeded (all reads unmapped).

    The device phase is ONE launch (sw.gather_score_hash):
    window gather from the device-resident path-code pool, oriented
    query build from the packed read matrix, content hashing, and SW
    scoring all fuse on device, so per-batch host->device traffic is
    the uint8 read matrix + ~13 bytes per candidate instead of the
    full (rows, Wmax)+(rows, Rmax) int32 matrices. All candidate rows
    are scored (duplicate windows score identically); the host dedups
    afterwards with the returned hashes, so winner-select semantics
    are unchanged from the host-dedup-first formulation."""
    return gather_collect(gather_submit(mapper, reads, max_candidates, pad))


def gather_submit(mapper, reads, max_candidates: int = 8,
                  pad: int = 24) -> Optional[PendingGather]:
    """The `mapper.submit` span (host seeding, packing and the async
    dispatch) of one chunk."""
    with PROFILER.span("mapper.submit"):
        return _gather_submit(mapper, reads, max_candidates, pad)


def _gather_submit(mapper, reads, max_candidates: int = 8,
                   pad: int = 24) -> Optional[PendingGather]:
    """Phase 1 of gather_and_score: seed + cluster + candidate spans +
    async device dispatch. Returns None when nothing seeded; the
    returned PendingGather's device work proceeds asynchronously."""
    from .giraffe import seed_and_cluster_arrays
    from .sw import gather_score_hash

    n_reads = len(reads)
    # one-pass encode into a packed buffer (views replace per-read
    # encodes; the buffer feeds the native seeding + finalize directly)
    read_lens = np.array([len(r.seq) for r in reads], dtype=np.int64)
    read_off = np.zeros(n_reads + 1, dtype=np.int64)
    np.cumsum(read_lens, out=read_off[1:])
    read_buf = dna.encode("".join(r.seq for r in reads))
    read_buf = np.ascontiguousarray(read_buf, dtype=np.uint8)
    read_codes = [
        read_buf[read_off[i] : read_off[i + 1]] for i in range(n_reads)
    ]
    arrs = seed_and_cluster_arrays(
        mapper.index, read_codes, ry_index=mapper.ry_index,
        read_buf=read_buf, read_off=read_off,
    )
    if arrs is None:
        return None
    c_read, c_path, c_strand, c_dlo, c_dhi, c_size = arrs
    n = len(c_read)

    # top-K clusters per read by n_seeds (stable in cluster order)
    order = np.lexsort((np.arange(n), -c_size, c_read))
    c_read = c_read[order]
    c_path = c_path[order]
    c_strand = c_strand[order]
    c_dlo = c_dlo[order]
    c_dhi = c_dhi[order]
    first = np.ones(n, dtype=bool)
    first[1:] = c_read[1:] != c_read[:-1]
    grp_start = np.maximum.accumulate(np.where(first, np.arange(n), 0))
    rank = np.arange(n) - grp_start
    keep = rank < max_candidates
    c_read, c_path, c_strand, c_dlo, c_dhi = (
        c_read[keep], c_path[keep], c_strand[keep], c_dlo[keep], c_dhi[keep]
    )

    # window spans on the haplotype linearization
    mapper._pools.ensure(np.unique(c_path))
    pools = mapper._pools.arrays()
    L = read_lens[c_read]
    lo = np.maximum(0, c_dlo - pad)
    hi = np.minimum(pools.pc_len[c_path], c_dhi + L + pad)
    ok = hi > lo
    c_read, c_path, c_strand, lo, hi, L = (
        c_read[ok], c_path[ok], c_strand[ok], lo[ok], hi[ok], L[ok]
    )
    m = len(c_read)
    if m == 0:
        return None
    wlen = hi - lo

    # ---- device phase: gather + hash + score, one dispatch ----
    # (row/width-bucketed to bound recompiles)
    Wmax = _round_up(int(wlen.max()), 64)
    Rmax = _round_up(int(read_lens.max()), 32)
    Nb = _bucket_rows(n_reads)
    Mb = _bucket_rows(m)
    reads_mat = _pack_reads_mat(read_buf, read_off, read_lens, Nb, Rmax)
    rl = np.zeros(Nb, dtype=np.int32)
    rl[:n_reads] = read_lens
    big_pool = len(pools.pc_buf) + Wmax + 2 > 2**31
    gdt = np.int64 if big_pool else np.int32
    aux = np.zeros((4, Mb), dtype=gdt)
    aux[0, :m] = c_read
    aux[1, :m] = pools.pc_beg[c_path] + lo
    aux[2, :m] = wlen
    aux[3, :m] = c_strand
    p = PendingGather()
    p.n_reads = n_reads
    p.read_codes = read_codes
    p.read_lens = read_lens
    p.read_buf = read_buf
    p.read_off = read_off
    p.c_read = c_read
    p.c_path = c_path
    p.c_strand = c_strand
    sp_lo, sp_hi = mapper.graph.path_node_spans()
    p.span_lo = sp_lo[c_path]
    p.span_hi = sp_hi[c_path]
    p.span_grp = mapper.graph.path_span_groups()[c_path]
    p.lo = lo
    p.L = L
    p.wlen = wlen
    p.m = m
    dev = mapper.device
    p.dev = gather_score_hash(
        pools.device_pc(dev), torch.from_numpy(reads_mat).to(dev),
        torch.from_numpy(rl).to(dev), torch.from_numpy(aux).to(dev), Wmax,
    )  # async on CUDA: not downloaded until gather_collect
    return p


def gather_collect(p: Optional[PendingGather]) -> Optional[BatchResult]:
    """The `mapper.collect` span: the wait for the card, the download,
    dedup and winner-select."""
    with PROFILER.span("mapper.collect"):
        return _gather_collect(p)


def _gather_collect(p: Optional[PendingGather]) -> Optional[BatchResult]:
    """Phase 2 of gather_and_score: download scores/hashes, dedup,
    winner-select -> BatchResult."""
    if p is None:
        return None
    n_reads = p.n_reads
    read_codes = p.read_codes
    read_lens = p.read_lens
    read_buf = p.read_buf
    read_off = p.read_off
    c_read, c_path, c_strand = p.c_read, p.c_path, p.c_strand
    lo, L, wlen, m = p.lo, p.L, p.wlen, p.m
    scores, h1, h2 = (x.cpu().numpy()[:m] for x in p.dev)

    # content dedup per (read, strand, span group): keep first in lo
    # order; identical windows are one placement only when they also
    # OVERLAP — equal content from disjoint-span paths (other taxa) or
    # at a distant offset (tandem repeat) is a distinct placement
    grp = p.span_grp
    pos_in = np.arange(m)
    ordd = np.lexsort((pos_in, lo, h2, h1, wlen, grp, c_strand, c_read))
    rs, ss, gs, w_s, h1s, h2s, los = (
        c_read[ordd], c_strand[ordd], grp[ordd], wlen[ordd], h1[ordd],
        h2[ordd], lo[ordd],
    )
    same_key = (
        (rs[1:] == rs[:-1]) & (ss[1:] == ss[:-1]) & (gs[1:] == gs[:-1])
        & (w_s[1:] == w_s[:-1])
        & (h1s[1:] == h1s[:-1]) & (h2s[1:] == h2s[:-1])
    )
    dup = np.zeros(m, dtype=bool)
    dup[1:] = same_key & (los[1:] < los[:-1] + w_s[:-1])  # intervals overlap
    # The adjacent-row comparison above matches the host path's
    # kept-only semantics (giraffe._gather_candidates: a candidate is a
    # dup iff it overlaps a KEPT span) except in >=3-row chains, where a
    # DROPPED row can wrongly suppress its successor (A kept, B dup of
    # A, C overlaps B but not A -> C must be kept).  Adjacent-only can
    # only over-drop (the last kept lo <= previous lo, so adjacent-keep
    # implies kept-only-keep), and only where a dup row follows another
    # dup row — exact greedy rescan on just those rare groups.  Widths
    # are equal within a group (wlen is in the key), so overlap with any
    # kept span reduces to overlap with the LAST kept span.
    suspect = np.nonzero(dup[1:] & dup[:-1])[0] + 1
    if suspect.size:
        is_start = np.concatenate(([True], ~same_key))
        start_of = np.maximum.accumulate(
            np.where(is_start, np.arange(m), -1)
        )
        for g in np.unique(start_of[suspect]):
            last_hi = los[g] + w_s[g]
            j = g + 1
            while j < m and not is_start[j]:
                if los[j] < last_hi:
                    dup[j] = True
                else:
                    dup[j] = False
                    last_hi = los[j] + w_s[j]
                j += 1
    kept_rows = np.sort(ordd[~dup])
    c_read, c_path, c_strand, lo, wlen, L, scores = (
        c_read[kept_rows], c_path[kept_rows], c_strand[kept_rows],
        lo[kept_rows], wlen[kept_rows], L[kept_rows], scores[kept_rows],
    )
    span_lo = p.span_lo[kept_rows]
    span_hi = p.span_hi[kept_rows]
    m = len(c_read)

    # winner + runner-up per read; the runner-up is the best candidate
    # at a genuinely DISTINCT placement (same strand + overlapping
    # haplotype interval = the same placement via another haplotype —
    # does not compete for MQ; see giraffe.same_placement)
    hi = lo + wlen
    ordw = np.lexsort((np.arange(m), -scores, c_read))
    rw = c_read[ordw]
    fw = np.ones(m, dtype=bool)
    fw[1:] = rw[1:] != rw[:-1]
    first_idx = np.nonzero(fw)[0]
    win_rows = ordw[first_idx]
    rr_all = rw[first_idx]  # read id per group
    wstrand = np.zeros(n_reads, dtype=c_strand.dtype)
    wlo = np.zeros(n_reads, dtype=np.int64)
    whi = np.zeros(n_reads, dtype=np.int64)
    wsp_lo = np.zeros(n_reads, dtype=np.int64)
    wsp_hi = np.zeros(n_reads, dtype=np.int64)
    wstrand[rr_all] = c_strand[win_rows]
    wlo[rr_all] = lo[win_rows]
    whi[rr_all] = hi[win_rows]
    wsp_lo[rr_all] = span_lo[win_rows]
    wsp_hi[rr_all] = span_hi[win_rows]
    strand_o = c_strand[ordw]
    lo_o = lo[ordw]
    hi_o = hi[ordw]
    # same placement = same strand + overlapping path interval + the
    # paths' node-index spans overlap (disjoint-span paths — different
    # taxa — never share a placement; see giraffe.same_placement)
    ovl = (
        (strand_o == wstrand[rw]) & (lo_o < whi[rw]) & (wlo[rw] < hi_o)
        & (span_lo[ordw] <= wsp_hi[rw]) & (wsp_lo[rw] <= span_hi[ordw])
    )
    pos_ok = np.where(~ovl, np.arange(m), m)
    first_ok = np.minimum.reduceat(pos_ok, first_idx)
    grp_end = np.append(first_idx[1:], m)
    has2 = first_ok < grp_end
    second = np.full(len(first_idx), -1e30, dtype=np.float32)
    second[has2] = scores[ordw[np.minimum(first_ok, m - 1)]][has2]

    out = BatchResult()
    out.read_codes = read_codes
    out.read_lens = read_lens
    out.read_buf = read_buf
    out.read_off = read_off
    out.cand_read = c_read
    out.cand_path = c_path
    out.cand_strand = c_strand
    out.cand_lo = lo
    out.cand_wlen = wlen
    out.scores = scores
    out.w_has = np.zeros(n_reads, dtype=np.uint8)
    out.w_cand = np.full(n_reads, -1, dtype=np.int64)
    out.w_second = np.full(n_reads, -1e30, dtype=np.float32)
    out.w_has2 = np.zeros(n_reads, dtype=np.uint8)
    rr = rw[first_idx]
    out.w_has[rr] = 1
    out.w_cand[rr] = win_rows
    out.w_second[rr] = second
    out.w_has2[rr] = has2
    # top-K candidates per read (paired-end joint selection) + the
    # best/second CONTENT-level scores (the paired path's MQ inputs)
    K = 4
    rank_in = np.arange(m) - np.repeat(first_idx, np.diff(
        np.append(first_idx, m)
    ))
    out.topk_rows = np.full((n_reads, K), -1, dtype=np.int64)
    out.topk_scores = np.full((n_reads, K), -1e30, dtype=np.float32)
    sel_k = rank_in < K
    out.topk_rows[rw[sel_k], rank_in[sel_k]] = ordw[sel_k]
    out.topk_scores[rw[sel_k], rank_in[sel_k]] = scores[ordw[sel_k]]
    out.top2_score = np.full(n_reads, -1e30, dtype=np.float32)
    out.top2_has = np.zeros(n_reads, dtype=bool)
    nxt = first_idx + 1
    ok2c = (nxt < m) & (np.append(rw[1:], -1)[first_idx] == rw[first_idx])
    rr2 = rw[first_idx][ok2c]
    out.top2_has[rr2] = True
    out.top2_score[rr2] = scores[ordw[np.minimum(nxt, m - 1)]][ok2c]
    return out


# ---------------------------------------------------------------- finalize
def finalize_batch(mapper, reads, br: Optional[BatchResult]
                   ) -> List[gam.Alignment]:
    """Native batch finalize, materialized to gam.Alignment objects."""
    return finalize_table(mapper, reads, br).to_alignments()


def _empty_table(reads) -> "AlignmentTable":
    t = AlignmentTable()
    t.names = [r.name for r in reads]
    t.seqs = [r.seq for r in reads]
    t.quals = [bytes(r.qual or b"") for r in reads]
    n = len(reads)
    t.score = np.zeros(n, dtype=np.int32)
    t.identity = np.zeros(n, dtype=np.float64)
    t.mq = np.zeros(n, dtype=np.int32)
    t.nmap = np.zeros(n, dtype=np.int32)
    t.map_off = np.zeros(n + 1, dtype=np.int64)
    t.m_node = np.zeros(0, dtype=np.int64)
    t.m_off = np.zeros(0, dtype=np.int32)
    t.m_rev = np.zeros(0, dtype=np.uint8)
    t.e_off = np.zeros(1, dtype=np.int64)
    t.e_from = np.zeros(0, dtype=np.int32)
    t.e_to = np.zeros(0, dtype=np.int32)
    t.e_soff = np.zeros(1, dtype=np.int64)
    t.eseq = b""
    t.read_paired = np.zeros(n, dtype=bool)
    return t


def finalize_table(mapper, reads, br: Optional[BatchResult],
                   sel_override: Optional[np.ndarray] = None,
                   mq_override: Optional[np.ndarray] = None,
                   second_override: Optional[np.ndarray] = None,
                   ) -> "AlignmentTable":
    """The `mapper.finalize` span: the native table build."""
    with PROFILER.span("mapper.finalize"):
        return _finalize_table(mapper, reads, br, sel_override,
                               mq_override, second_override)


def _finalize_table(mapper, reads, br: Optional[BatchResult],
                    sel_override: Optional[np.ndarray] = None,
                    mq_override: Optional[np.ndarray] = None,
                    second_override: Optional[np.ndarray] = None,
                    ) -> "AlignmentTable":
    """Run the native batch finalize; columnar output.

    sel_override[i]: candidate row to finalize for read i (-1 =
    unmapped) instead of br.w_cand — the paired-end joint selection.
    mq_override[i] >= 0 fixes the read's MQ (pair-level MQ).
    second_override[i]: runner-up score for the MQ gap (NaN = none)."""
    lib = load_native()
    n_reads = len(reads)
    graph = mapper.graph
    pools = mapper._pools.arrays()

    if br is None:
        return _empty_table(reads)

    # per-read winner tables
    if sel_override is not None:
        sel = np.asarray(sel_override, dtype=np.int64)
        w_has = (sel >= 0).astype(np.uint8)
    else:
        sel = br.w_cand
        w_has = br.w_has.copy()
    w_score = np.zeros(n_reads, dtype=np.float32)
    w_path = np.zeros(n_reads, dtype=np.int32)
    w_strand = np.zeros(n_reads, dtype=np.uint8)
    w_lo = np.zeros(n_reads, dtype=np.int64)
    w_wlen = np.zeros(n_reads, dtype=np.int64)
    w_win = np.full(n_reads, -1, dtype=np.int32)
    hasw = w_has == 1
    rows = sel[hasw]
    w_score[hasw] = br.scores[rows]
    w_path[hasw] = br.cand_path[rows]
    w_strand[hasw] = br.cand_strand[rows]
    w_lo[hasw] = br.cand_lo[rows]
    w_wlen[hasw] = br.cand_wlen[rows]
    if second_override is not None:
        w_second = np.where(
            np.isnan(second_override), -1e30, second_override
        ).astype(np.float32)
        w_has2 = (~np.isnan(second_override)).astype(np.uint8)
    else:
        w_second = br.w_second
        w_has2 = br.w_has2
    mq_ovr = (
        np.asarray(mq_override, dtype=np.int32)
        if mq_override is not None
        else np.full(n_reads, -1, dtype=np.int32)
    )

    # graph windows for non-perfect winners (bucket-cached)
    perfect = np.zeros(n_reads, dtype=bool)
    perfect[hasw] = (
        w_score[hasw] == (br.read_lens[hasw] + 2 * FULL_LENGTH_BONUS)
    )
    need_win = hasw & ~perfect
    if not hasattr(mapper, "_win_cache"):
        mapper._win_cache = {}
    from .graph_align import build_window

    win_list = []
    win_ids = {}
    for i in np.nonzero(need_win)[0]:
        lo_b = (int(w_lo[i]) // 128) * 128
        hi_b = -(-(int(w_lo[i]) + int(w_wlen[i])) // 128) * 128
        wkey = (int(w_path[i]), lo_b, hi_b)
        wid = win_ids.get(wkey)
        if wid is None:
            win = mapper._win_cache.get(wkey)
            if win is None:
                win = build_window(graph, wkey[0], lo_b, hi_b)
                mapper._win_cache[wkey] = win
            if win is None:
                w_has[i] = 0  # empty path: unmapped
                continue
            wid = len(win_list)
            win_ids[wkey] = wid
            win_list.append(_pack_window(win))
        w_win[i] = wid

    # pack windows
    def _begs(parts):
        b = np.zeros(len(parts), dtype=np.int64)
        if len(parts) > 1:
            np.cumsum([len(p) for p in parts[:-1]], out=b[1:])
        return b

    if win_list:
        wref = np.concatenate([w[0] for w in win_list])
        wref_off = np.zeros(len(win_list) + 1, dtype=np.int64)
        np.cumsum([len(w[0]) for w in win_list], out=wref_off[1:])
        wpo = np.concatenate([w[1] for w in win_list])
        wpo_beg = _begs([w[1] for w in win_list])
        wpi = np.concatenate([w[2] for w in win_list])
        wpi_beg = _begs([w[2] for w in win_list])
        wpos_h = np.concatenate([w[3] for w in win_list])
        wpos_o = np.concatenate([w[4] for w in win_list])
        wh_node = np.concatenate([w[5] for w in win_list])
        wh_rev = np.concatenate([w[6] for w in win_list])
        wh_beg = _begs([w[5] for w in win_list])
    else:
        wref = np.zeros(0, dtype=np.uint8)
        wref_off = np.zeros(1, dtype=np.int64)
        wpo = np.zeros(0, dtype=np.int64)
        wpo_beg = np.zeros(1, dtype=np.int64)
        wpi = np.zeros(0, dtype=np.int32)
        wpi_beg = np.zeros(1, dtype=np.int64)
        wpos_h = np.zeros(0, dtype=np.int32)
        wpos_o = np.zeros(0, dtype=np.int32)
        wh_node = np.zeros(0, dtype=np.int32)
        wh_rev = np.zeros(0, dtype=np.uint8)
        wh_beg = np.zeros(1, dtype=np.int64)

    # reads buffer (packed once in gather_and_score)
    read_off = br.read_off
    read_buf = br.read_buf

    # outputs
    Lmax = int(br.read_lens.max()) if n_reads else 0
    map_cap = int(n_reads * max(Lmax, 1) + 16)
    edit_cap = int(n_reads * (2 * max(Lmax, 1) + 4) + 16)
    eseq_cap = int(n_reads * (2 * max(Lmax, 1) + 4) + 16)
    o_score = np.zeros(n_reads, dtype=np.int32)
    o_ident = np.zeros(n_reads, dtype=np.float64)
    o_mq = np.zeros(n_reads, dtype=np.int32)
    o_nmap = np.zeros(n_reads, dtype=np.int32)
    o_mnode = np.zeros(map_cap, dtype=np.int64)
    o_moff = np.zeros(map_cap, dtype=np.int32)
    o_mrev = np.zeros(map_cap, dtype=np.uint8)
    o_mne = np.zeros(map_cap, dtype=np.int32)
    o_efrom = np.zeros(edit_cap, dtype=np.int32)
    o_eto = np.zeros(edit_cap, dtype=np.int32)
    o_eslen = np.zeros(edit_cap, dtype=np.int32)
    o_eseq = ctypes.create_string_buffer(eseq_cap)
    counts = np.zeros(3, dtype=np.int64)

    i32, i64, u8, f32, f64 = (
        ctypes.c_int32, ctypes.c_int64, ctypes.c_uint8, ctypes.c_float,
        ctypes.c_double,
    )
    rc = lib.map_finalize_batch(
        _p(read_buf, u8), _p(read_off, i64), n_reads,
        _p(w_has, u8), _p(w_score, f32), _p(w_second, f32),
        _p(w_has2, u8), _p(w_path, i32), _p(w_strand, u8),
        _p(w_lo, i64), _p(w_wlen, i64), _p(w_win, i32), _p(mq_ovr, i32),
        _p(pools.pc_buf, u8), _p(pools.pc_beg, i64),
        _p(pools.ps_node, i32), _p(pools.ps_rev, u8),
        _p(pools.ps_start, i64), _p(pools.st_beg, i64),
        _p(pools.st_cnt, i64),
        _p(pools.node_len, i64), graph.min_id,
        _p(wref, u8), _p(wref_off, i64), _p(wpo, i64), _p(wpo_beg, i64),
        _p(wpi, i32), _p(wpi_beg, i64),
        _p(wpos_h, i32), _p(wpos_o, i32),
        _p(wh_node, i32), _p(wh_rev, u8), _p(wh_beg, i64),
        _p(o_score, i32), _p(o_ident, f64), _p(o_mq, i32), _p(o_nmap, i32),
        _p(o_mnode, i64), _p(o_moff, i32), _p(o_mrev, u8), _p(o_mne, i32),
        map_cap,
        _p(o_efrom, i32), _p(o_eto, i32), _p(o_eslen, i32), edit_cap,
        o_eseq, eseq_cap,
        _p(counts, i64),
    )
    if rc != 0:
        raise RuntimeError(f"map_finalize_batch overflow at read {-rc - 1}")

    retry = np.nonzero(o_nmap == -2)[0]
    if len(retry):
        # rare: perfect-score search miss with no window built — run
        # the per-read slow path for those reads, then rebuild the
        # table from objects (keeps the columnar contract)
        out = _materialize(reads, o_nmap, o_score, o_ident, o_mq, o_mnode,
                           o_moff, o_mrev, o_mne, o_efrom, o_eto, o_eslen,
                           o_eseq.raw)
        from .giraffe import Candidate

        for i in retry:
            row = int(sel[i])
            cand = Candidate(
                path=int(br.cand_path[row]),
                strand=bool(br.cand_strand[row]),
                diag_lo=0, diag_hi=0, n_seeds=0,
            )
            cand_rec = (
                i, cand,
                pools.pc_buf[
                    pools.pc_beg[cand.path] + br.cand_lo[row] :
                    pools.pc_beg[cand.path] + br.cand_lo[row]
                    + br.cand_wlen[row]
                ],
                int(br.cand_lo[row]),
            )
            second = float(w_second[i]) if w_has2[i] else None
            out[i] = mapper._finalize(
                reads[i], br.read_codes[i], cand_rec,
                float(br.scores[row]), second,
                mq_override=(int(mq_ovr[i]) if mq_ovr[i] >= 0 else None),
            )
        return table_from_alignments(out)

    M = int(counts[0])
    E = int(counts[1])
    SB = int(counts[2])
    t = AlignmentTable()
    t.names = [r.name for r in reads]
    t.seqs = [r.seq for r in reads]
    t.quals = [bytes(r.qual or b"") for r in reads]
    t.score = o_score
    t.identity = o_ident
    t.mq = o_mq
    t.nmap = o_nmap
    t.map_off = np.zeros(n_reads + 1, dtype=np.int64)
    np.cumsum(o_nmap, out=t.map_off[1:])
    t.m_node = o_mnode[:M]
    t.m_off = o_moff[:M]
    t.m_rev = o_mrev[:M]
    t.e_off = np.zeros(M + 1, dtype=np.int64)
    np.cumsum(o_mne[:M], out=t.e_off[1:])
    t.e_from = o_efrom[:E]
    t.e_to = o_eto[:E]
    t.e_soff = np.zeros(E + 1, dtype=np.int64)
    np.cumsum(o_eslen[:E], out=t.e_soff[1:])
    t.eseq = o_eseq.raw[:SB]
    t.read_paired = np.zeros(n_reads, dtype=bool)
    return t


def _materialize(reads, nmap, score, ident, mq, m_node, m_off, m_rev,
                 m_ne, e_from, e_to, e_slen, eseq) -> List[gam.Alignment]:
    out: List[gam.Alignment] = []
    mi = ei = si = 0
    Alignment, Path, Mapping, Position, Edit = (
        gam.Alignment, gam.Path, gam.Mapping, gam.Position, gam.Edit
    )
    for i, r in enumerate(reads):
        nm = int(nmap[i])
        a = Alignment(sequence=r.seq, name=r.name,
                      quality=bytes(r.qual or b""))
        if nm > 0:
            mappings = []
            for k in range(nm):
                ne = int(m_ne[mi])
                edits = []
                for _ in range(ne):
                    sl = int(e_slen[ei])
                    seq = eseq[si : si + sl].decode() if sl else ""
                    edits.append(Edit(int(e_from[ei]), int(e_to[ei]), seq))
                    si += sl
                    ei += 1
                mappings.append(
                    Mapping(
                        position=Position(
                            node_id=int(m_node[mi]),
                            offset=int(m_off[mi]),
                            is_reverse=bool(m_rev[mi]),
                        ),
                        edits=edits,
                        rank=k + 1,
                    )
                )
                mi += 1
            a.path = Path(mappings=mappings)
            a.score = int(score[i])
            a.identity = float(ident[i])
            a.mapping_quality = int(mq[i])
        out.append(a)
    return out


class AlignmentTable:
    """Columnar alignment batch — the mapper's TPU-native output form.

    Per read: names/seqs/quals (host lists), score/identity/mq/nmap,
    map_off [n+1]. Per mapping: m_node/m_off/m_rev, e_off [M+1].
    Per edit: e_from/e_to, e_soff [E+1] into the eseq byte pool.
    The production haplocart path consumes this directly
    (pipelines/hc_columnar.py); `to_alignments()` materializes
    gam.Alignment objects for GAM output and the object-based APIs.
    """

    __slots__ = (
        "names", "seqs", "quals", "score", "identity", "mq", "nmap",
        "map_off", "m_node", "m_off", "m_rev", "e_off", "e_from", "e_to",
        "e_soff", "eseq", "read_paired",
    )

    @property
    def n(self) -> int:
        return len(self.names)

    def to_alignments(self) -> List[gam.Alignment]:
        from ..io.fastx import Read

        reads = [
            Read(name=n, seq=s, qual=q)
            for n, s, q in zip(self.names, self.seqs, self.quals)
        ]
        e_slen = np.diff(self.e_soff).astype(np.int32)
        m_ne = np.diff(self.e_off).astype(np.int32)
        out = _materialize(
            reads, self.nmap, self.score, self.identity, self.mq,
            self.m_node, self.m_off, self.m_rev, m_ne, self.e_from,
            self.e_to, e_slen, self.eseq,
        )
        for a, p in zip(out, self.read_paired):
            a.read_paired = bool(p)
        return out

    @staticmethod
    def _ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
        """Concatenate [starts[i], starts[i]+counts[i]) ranges,
        vectorized."""
        total = int(counts.sum())
        if total == 0:
            return np.zeros(0, dtype=np.int64)
        off = np.zeros(len(counts) + 1, dtype=np.int64)
        np.cumsum(counts, out=off[1:])
        within = np.arange(total, dtype=np.int64) - np.repeat(
            off[:-1], counts
        )
        return np.repeat(starts.astype(np.int64), counts) + within

    def select(self, idx: np.ndarray) -> "AlignmentTable":
        """Row subset/reorder by read indices (filter / sort / dedup) —
        pure array gathers."""
        idx = np.asarray(idx)
        if idx.dtype == bool:
            idx = np.nonzero(idx)[0]
        t = AlignmentTable()
        t.names = [self.names[i] for i in idx]
        t.seqs = [self.seqs[i] for i in idx]
        t.quals = [self.quals[i] for i in idx]
        t.score = self.score[idx]
        t.identity = self.identity[idx]
        t.mq = self.mq[idx]
        t.nmap = self.nmap[idx]
        t.read_paired = self.read_paired[idx]
        nm = t.nmap.astype(np.int64)
        t.map_off = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(nm, out=t.map_off[1:])
        rows = self._ranges(self.map_off[idx], nm)
        M = len(rows)
        t.m_node = self.m_node[rows]
        t.m_off = self.m_off[rows]
        t.m_rev = self.m_rev[rows]
        ne = (self.e_off[rows + 1] - self.e_off[rows]).astype(np.int64)
        t.e_off = np.zeros(M + 1, dtype=np.int64)
        np.cumsum(ne, out=t.e_off[1:])
        erows = self._ranges(self.e_off[rows], ne)
        t.e_from = self.e_from[erows]
        t.e_to = self.e_to[erows]
        sl = (self.e_soff[erows + 1] - self.e_soff[erows]).astype(np.int64)
        E = len(erows)
        t.e_soff = np.zeros(E + 1, dtype=np.int64)
        np.cumsum(sl, out=t.e_soff[1:])
        spos = self._ranges(self.e_soff[erows], sl)
        t.eseq = (
            np.frombuffer(self.eseq, dtype=np.uint8)[spos].tobytes()
            if len(spos)
            else b""
        )
        return t

    @staticmethod
    def concat(tables: List["AlignmentTable"]) -> "AlignmentTable":
        """Concatenate chunk tables in order (the double-buffered
        map_reads_table merge) — offsets rebased, pure array concats."""
        if len(tables) == 1:
            return tables[0]
        t = AlignmentTable()
        t.names = [n for x in tables for n in x.names]
        t.seqs = [s for x in tables for s in x.seqs]
        t.quals = [q for x in tables for q in x.quals]
        t.score = np.concatenate([x.score for x in tables])
        t.identity = np.concatenate([x.identity for x in tables])
        t.mq = np.concatenate([x.mq for x in tables])
        t.nmap = np.concatenate([x.nmap for x in tables])
        t.read_paired = np.concatenate([x.read_paired for x in tables])
        n = len(t.names)
        t.map_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(t.nmap.astype(np.int64), out=t.map_off[1:])
        t.m_node = np.concatenate([x.m_node for x in tables])
        t.m_off = np.concatenate([x.m_off for x in tables])
        t.m_rev = np.concatenate([x.m_rev for x in tables])
        M = len(t.m_node)
        ne = np.concatenate([np.diff(x.e_off) for x in tables])
        t.e_off = np.zeros(M + 1, dtype=np.int64)
        np.cumsum(ne, out=t.e_off[1:])
        t.e_from = np.concatenate([x.e_from for x in tables])
        t.e_to = np.concatenate([x.e_to for x in tables])
        E = len(t.e_from)
        sl = np.concatenate([np.diff(x.e_soff) for x in tables])
        t.e_soff = np.zeros(E + 1, dtype=np.int64)
        np.cumsum(sl, out=t.e_soff[1:])
        t.eseq = b"".join(x.eseq for x in tables)
        return t

    def first_positions(self):
        """Per read: (first node_id, first offset, last node_id, last
        offset) of its mappings (zeros when unmapped) — the gamsort /
        duprm coordinates."""
        n = self.n
        if len(self.m_node) == 0:
            z = np.zeros(n, dtype=np.int64)
            return z, z.copy(), z.copy(), z.copy()
        first = np.minimum(self.map_off[:-1], len(self.m_node) - 1)
        last = np.minimum(
            np.maximum(self.map_off[1:] - 1, self.map_off[:-1]),
            len(self.m_node) - 1,
        )
        has = self.nmap > 0
        fn = np.where(has, self.m_node[first], 0)
        fo = np.where(has, self.m_off[first], 0)
        ln = np.where(has, self.m_node[last], 0)
        lo = np.where(has, self.m_off[last], 0)
        return fn, fo, ln, lo


def table_from_gam(path: str) -> Optional[AlignmentTable]:
    """GAM file -> AlignmentTable straight from the native codec's
    columnar decode (no per-read objects; None when the codec cannot
    parse the file). The GAM-input twin of map_reads_table."""
    from ..io.gam_native import read_gam_columns

    cols = read_gam_columns(path)
    if cols is None:
        return None
    t = AlignmentTable()
    n = cols.n_reads
    t.names = [cols.read_name(i) for i in range(n)]
    t.seqs = [cols.read_seq(i) for i in range(n)]
    t.quals = [cols.read_qual(i) for i in range(n)]
    t.score = cols.score
    t.identity = cols.identity
    t.mq = cols.mapq
    t.read_paired = cols.paired.astype(bool)
    t.nmap = np.diff(cols.map_start).astype(np.int32)
    t.map_off = cols.map_start
    t.m_node = cols.node_id
    t.m_off = cols.node_off
    t.m_rev = cols.is_rev
    t.e_off = cols.edit_start
    t.e_from = cols.from_len
    t.e_to = cols.to_len
    t.e_soff = cols.eseq_off
    t.eseq = cols.eseqs
    return t


def table_from_alignments(alignments) -> AlignmentTable:
    """Objects -> columnar table (GAM-input path + retry fallback)."""
    t = AlignmentTable()
    t.names = [a.name for a in alignments]
    t.seqs = [a.sequence for a in alignments]
    t.quals = [bytes(a.quality or b"") for a in alignments]
    n = len(alignments)
    t.score = np.array([a.score for a in alignments], dtype=np.int32)
    t.identity = np.array([a.identity for a in alignments],
                          dtype=np.float64)
    t.mq = np.array([a.mapping_quality for a in alignments], dtype=np.int32)
    t.read_paired = np.array([a.read_paired for a in alignments],
                             dtype=bool)
    t.nmap = np.array(
        [len(a.path.mappings) if a.identity != 0 else 0
         for a in alignments],
        dtype=np.int32,
    )
    t.map_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(t.nmap, out=t.map_off[1:])
    m_node, m_off, m_rev, e_cnt = [], [], [], []
    e_from, e_to, seqs = [], [], []
    for a in alignments:
        if a.identity == 0:
            continue
        for m in a.path.mappings:
            m_node.append(m.position.node_id)
            m_off.append(m.position.offset)
            m_rev.append(1 if m.position.is_reverse else 0)
            e_cnt.append(len(m.edits))
            for e in m.edits:
                e_from.append(e.from_length)
                e_to.append(e.to_length)
                seqs.append(e.sequence)
    M = len(m_node)
    t.m_node = np.array(m_node, dtype=np.int64)
    t.m_off = np.array(m_off, dtype=np.int32)
    t.m_rev = np.array(m_rev, dtype=np.uint8)
    t.e_off = np.zeros(M + 1, dtype=np.int64)
    np.cumsum(np.array(e_cnt, dtype=np.int64), out=t.e_off[1:])
    E = len(e_from)
    t.e_from = np.array(e_from, dtype=np.int32)
    t.e_to = np.array(e_to, dtype=np.int32)
    t.e_soff = np.zeros(E + 1, dtype=np.int64)
    np.cumsum(np.array([len(s) for s in seqs], dtype=np.int64),
              out=t.e_soff[1:])
    t.eseq = "".join(seqs).encode()
    return t
