"""keelime's batched overlap scans on the card: the port of
vgan_tpu/pipelines/keelime_device.py.

The reference scores candidate read pairs one at a time on the host
(`get_overlap_length_and_score`, `src/assembly.cpp:523-610`). keelime's
two batched scans (find_overlaps' candidate pairs and
merge_overlapping_contigs' four scans a contig pair) score a whole pair
list in one call:

  scores[n, s] = sum_j TABLE[a[n, s+j], b[n, j]]   for every start s,

where TABLE is the combined calculate_match_score − basesMatch-penalty
char-pair table (keelime._COMBINED) and the overlap length at start s
is min(len_b, len_a − s). The winner is the reference's: the longest
qualifying overlap (olen >= min_olen, score >= min_score), ties by
score.

* `overlap_best_indexed(seq_buf, seq_off, ai, bi, min_olen, min_score,
  longest)` is what keelime calls: pair i is (sequence ai[i], sequence
  bi[i]) of one table (the latin-1 bytes of every sequence back to back
  and their offsets). On a CUDA device the pairs are split by a's length
  (`split_by_length`) and scanned by `overlap_warp_kernel` (la <=
  L_WARP, a warp a pair) and `overlap_best_kernel` (longer, a
  thread-block cluster of G CTAs a pair, G from `long_cluster_size`; not
  launched when the caller's `longest` is at most L_WARP),
  both in csrc/keelime.cu on the current stream, each mapping the bytes
  to the 16-code alphabet as it stages a pair; on the CPU the codes are
  a torch op (`seq_codes`) and the threaded native scan
  (cpp/overlapbest.cpp) runs on the pairs gathered from the table, as
  the JAX package runs it in production.
* `overlap_best_batch(pairs, min_olen, min_score, device)` takes string
  pairs: it interns them into a table and calls overlap_best_indexed.
* Each kernel's wrapper (`warp_scan`, `block_scan`) counts
  `LAUNCHES[name]` where it launches the kernel. Their plain versions
  (`plain_warp_scan`, `plain_block_scan`, both on `plain_indexed`) and `overlap_scores_batch(pairs, ...)`, the plain
  PyTorch version of JAX's overlap_scores_batch, are the oracles of the
  tests and of the smoke test on the card, never on the CLI's path.

Every score is a multiple of 0.5 (the table holds halves only), so the
kernels' int32 sums of the doubled table, the native scan's and the f32
sums of the plain versions are all exact: they agree bit for bit.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from .keelime import _ALPHABET, _COMBINED, _enc

LAUNCHES: Dict[str, int] = {"overlap_warp": 0, "overlap_best": 0}
"""Kernel launches since the last reset_launches()."""

L_WARP = 256
"""Pairs with la <= L_WARP scan a warp a pair (overlap_warp_kernel), the
longer ones a cluster a pair (overlap_best_kernel): kLWarp of
csrc/keelime.cu, which sizes the warp kernel's shared memory."""


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------ tables
OTHER = len(_ALPHABET)  # the code of every byte outside the alphabet
N_CODES = OTHER + 1  # 16


def code_tables() -> Tuple[np.ndarray, np.ndarray]:
    """(lut [256] uint8, table2 [16, 16] int32): each byte's code in the
    16-code alphabet (the 15 characters of keelime._ALPHABET, then one
    code for every other byte), and the doubled combined score of each
    code pair. The other code's row and column are 0, as they are in
    keelime._COMBINED."""
    lut = np.full(256, OTHER, dtype=np.uint8)
    ords = np.frombuffer(_ALPHABET.encode("latin-1"), dtype=np.uint8)
    lut[ords] = np.arange(len(ords), dtype=np.uint8)
    t2 = np.zeros((N_CODES, N_CODES), dtype=np.int32)
    t2[:OTHER, :OTHER] = (2.0 * _COMBINED[np.ix_(ords, ords)]).astype(np.int32)
    assert np.array_equal(t2[:OTHER, :OTHER] / 2.0,
                          _COMBINED[np.ix_(ords, ords)])
    return lut, t2


_TABLE_CACHE: Dict[torch.device, Dict[str, torch.Tensor]] = {}


def pair_table(t2: np.ndarray) -> np.ndarray:
    """[65536] int8: the doubled scores of two cells at once,
    ptab[(a0 | a1 << 4) | (b0 | b1 << 4) << 8] = t2[a0, b0] + t2[a1, b1]
    (|.| <= 24), the table overlap_warp_kernel builds in its prologue and
    overlap_best_kernel copies in."""
    k = np.arange(1 << 16)
    return (t2[k & 15, (k >> 8) & 15]
            + t2[(k >> 4) & 15, k >> 12]).astype(np.int8)


def _tables(dev: torch.device) -> Dict[str, torch.Tensor]:
    """code_tables() on `dev`, made once a device: the lut, the doubled
    table as int8 ([16, 16] row-major), its pair table (pair_table), its
    f32 half for the plain version, and (on the CPU) the native scan's
    [256 x 256] int16 table indexed by (code_a << 8) | code_b."""
    tabs = _TABLE_CACHE.get(dev)
    if tabs is None:
        lut, t2 = code_tables()
        tabs = dict(lut=torch.from_numpy(lut).to(dev),
                    t2_i8=torch.from_numpy(t2.astype(np.int8).reshape(-1))
                    .to(dev),
                    pair=torch.from_numpy(pair_table(t2)).to(dev),
                    half=torch.from_numpy(t2.astype(np.float32) / 2).to(dev))
        if dev.type == "cpu":
            native = np.zeros((256, 256), dtype=np.int16)
            native[:N_CODES, :N_CODES] = t2
            tabs["native"] = torch.from_numpy(native.reshape(-1))
        _TABLE_CACHE[dev] = tabs
    return tabs


def intern(strings: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """(seq_buf uint8, seq_off [S+1] int64): the latin-1 bytes of the S
    strings back to back, and their offsets."""
    off = np.zeros(len(strings) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in strings], out=off[1:])
    return _enc("".join(strings)).copy(), off  # writable, for torch


# ------------------------------------------------------------ the scan
def _native_lib():
    from . import keelime

    return keelime._ovb_lib()


def _check_indexed(seq_buf, seq_off, ai, bi) -> torch.device:
    dev = seq_buf.device
    for t in (seq_off, ai, bi):
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and "
                             f"{t.device}")
    if seq_buf.dtype != torch.uint8 or seq_buf.dim() != 1:
        raise ValueError("overlap_best_indexed: seq_buf must be uint8 [B]")
    if seq_off.dtype != torch.int64 or seq_off.dim() != 1:
        raise ValueError("overlap_best_indexed: seq_off must be int64 "
                         "[S + 1]")
    if ai.dtype != torch.int32 or bi.dtype != torch.int32 \
            or ai.dim() != 1 or ai.shape != bi.shape:
        raise ValueError("overlap_best_indexed: ai and bi must be int32 [n]")
    return dev


def seq_codes(seq_buf: torch.Tensor) -> torch.Tensor:
    """The table's bytes mapped to the 16-code alphabet (code_tables) by
    the lut, a torch op on seq_buf's device: the native scan's input on
    the CPU and the plain versions'. The kernels apply the lut
    themselves."""
    return _tables(seq_buf.device)["lut"][seq_buf.long()]


def gather_packed(buf, off, idx):
    """(packed [sum of lengths], poff [n+1] int64): the sequences idx of
    the table (buf, off) back to back and their offsets, the layout of
    the native scan (and of the kernel before the table), by torch ops."""
    start = off[idx.long()]
    ln = off[idx.long() + 1] - start
    poff = torch.zeros(len(idx) + 1, dtype=torch.int64, device=buf.device)
    torch.cumsum(ln, 0, out=poff[1:])
    pos = torch.repeat_interleave(start - poff[:-1], ln) \
        + torch.arange(int(poff[-1]), device=buf.device)
    return buf[pos], poff


NATIVE_CHUNK = 1 << 16  # pairs a native call: bounds the gathered bytes


def _native_scan(codes, seq_off, ai, bi, min_olen, min_score, out_len,
                 out_score):
    """The threaded native scan (cpp/overlapbest.cpp) on the pairs of a
    CPU code table, gathered NATIVE_CHUNK pairs at a time."""
    lib = _native_lib()
    tab = _tables(codes.device)["native"]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i16p = ctypes.POINTER(ctypes.c_int16)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)

    def p(t, typ):
        return ctypes.cast(t.data_ptr(), typ)

    for c0 in range(0, len(ai), NATIVE_CHUNK):
        sl = slice(c0, c0 + NATIVE_CHUNK)
        abuf, aoff = gather_packed(codes, seq_off, ai[sl])
        bbuf, boff = gather_packed(codes, seq_off, bi[sl])
        lib.overlap_best_batch(
            p(abuf, u8p), p(aoff, i64p), p(bbuf, u8p), p(boff, i64p),
            len(aoff) - 1, p(tab, i16p), int(min_olen), float(min_score),
            p(out_len[sl], i64p), p(out_score[sl], f64p),
            min(8, os.cpu_count() or 1),
        )


def split_by_length(la: torch.Tensor):
    """(order [n] int32, n_short [1] int32) by torch ops on la's device,
    with no wait on the host: order holds the pairs with la <= L_WARP
    first, then the longer ones, each class in index order; n_short is
    the size of the first class."""
    n = la.numel()
    long_ = la > L_WARP
    c_long = torch.cumsum(long_, 0, dtype=torch.int32)  # longs up to k
    n_short = n - c_long[-1:]
    k = torch.arange(n, dtype=torch.int32, device=la.device)
    pos = torch.where(long_, n_short + c_long - 1, k - c_long)
    order = torch.empty(n, dtype=torch.int32, device=la.device)
    order[pos.long()] = k
    return order, n_short


def _launch(fn, name, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def warp_scan(seq_buf, seq_off, ai, bi, order, n_short, min_olen,
              min_score, out_len, out_score, n_long=None, longest=None):
    """overlap_warp_kernel on the pairs order[:n_short] (each la <=
    L_WARP), writing out_len / out_score at their indices, on the current
    stream. CUDA tensors only. (n_long and longest, the host's hints of
    the scan signature, are block_scan's.)"""
    from .._native import keelime_lib

    dev = seq_buf.device
    tabs = _tables(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(keelime_lib().overlap_warp_launch, "overlap_warp",
                seq_buf.data_ptr(), seq_off.data_ptr(), ai.data_ptr(),
                bi.data_ptr(), order.data_ptr(), n_short.data_ptr(),
                order.numel(), tabs["lut"].data_ptr(),
                tabs["t2_i8"].data_ptr(), int(min_olen), float(min_score),
                out_len.data_ptr(), out_score.data_ptr(),
                ctypes.c_void_p(stream))


CLUSTER_SIZES = (16, 8, 4, 2, 1)
"""CTAs a long pair that overlap_best_kernel is launched with, largest
first (16 is a non-portable cluster size)."""
MIN_CHUNK = 256
"""The fewest overlap positions a CTA of a cluster takes (kMinChunk of
csrc/keelime.cu): a pair of span L keeps at most L // MIN_CHUNK CTAs
busy."""


def long_cluster_size(n_long: int, longest, n_sm: int,
                      resident: Callable[[int], int]) -> int:
    """CTAs a long pair: the largest G of CLUSTER_SIZES at which all
    `n_long` pairs' clusters run at once (n_long * G <= n_sm and
    `resident(G)`, the card's cudaOccupancyMaxActiveClusters, injected
    so that this runs without a card, >= n_long) and a CTA's chunk of
    the longest pair (`longest` bp, None when not known) keeps at least
    MIN_CHUNK positions; else 1 (also where there is no long pair), at
    which the pairs' blocks may queue. `resident` is asked only where the
    other two hold."""
    for G in CLUSTER_SIZES:
        if G == 1 or (0 < n_long and n_long * G <= n_sm
                      and (longest is None or G * MIN_CHUNK <= longest)
                      and resident(G) >= n_long):
            return G
    return 1


def long_clusters(n_long: int, G: int, resident: Callable[[int], int]):
    """Clusters of G CTAs to launch over n_long long pairs: one a pair, at
    most as many as the card holds at once (they then stride over the
    pairs); one where there are none (the launch finds no pair) or where
    the card holds none (the launch is then refused)."""
    return max(1, min(n_long, resident(G)))


@functools.lru_cache(maxsize=None)
def _resident(index: int, G: int) -> int:
    """Clusters of G CTAs of overlap_best_kernel that card `index` holds
    at once."""
    from .._native import keelime_lib

    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = keelime_lib().overlap_best_max_active_clusters(
            G, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"overlap_best: residency query for clusters of "
                           f"{G} failed: CUDA error {rc}")
    return out.value


def card_long_cluster_size(dev: torch.device, n_long: int, longest) -> int:
    """long_cluster_size for n_long pairs on card `dev`."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    n_sm = torch.cuda.get_device_properties(index).multi_processor_count
    return long_cluster_size(n_long, longest, n_sm,
                             lambda G: _resident(index, G))


def block_scan(seq_buf, seq_off, ai, bi, order, n_short, min_olen,
               min_score, out_len, out_score, n_long=None, longest=None,
               cluster=None) -> int:
    """overlap_best_kernel on the pairs order[n_short:], writing out_len /
    out_score at their indices, on the current stream: one cluster of G
    CTAs a pair, G = `cluster` when given (the tests and the smoke force
    it), else card_long_cluster_size of `n_long` (the long pairs' count)
    and `longest` (a bound on a's length). Where the caller does not give
    n_long, it and the table's longest sequence are read back from the
    card (one wait, behind the split and the warp kernel). Returns G.
    CUDA tensors only; a launch the card refuses raises, and nothing
    falls back to a smaller G."""
    from .._native import keelime_lib

    dev = seq_buf.device
    tabs = _tables(dev)
    if n_long is None:
        head = torch.cat((n_short.to(torch.int64), seq_off)).cpu().numpy()
        n_long = order.numel() - int(head[0])
        longest = int(np.diff(head[1:]).max(initial=0))
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    G = cluster or card_long_cluster_size(dev, n_long, longest)
    clusters = long_clusters(n_long, G, lambda g: _resident(index, g))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(keelime_lib().overlap_best_launch, "overlap_best",
                seq_buf.data_ptr(), seq_off.data_ptr(), ai.data_ptr(),
                bi.data_ptr(), order.data_ptr(), n_short.data_ptr(),
                order.numel(), tabs["lut"].data_ptr(),
                tabs["pair"].data_ptr(), int(min_olen), float(min_score),
                out_len.data_ptr(), out_score.data_ptr(), G, clusters,
                ctypes.c_void_p(stream))
    return G


def scan_by_class(seq_buf, seq_off, ai, bi, min_olen, min_score,
                  longest=None, scans=(warp_scan, block_scan), n_long=None):
    """(out_len [n] int64, out_score [n] f64): the pairs split by a's
    length (split_by_length), scans[0] run on the short class and
    scans[1] on the long one, each writing its pairs' results at their
    indices and given the host's hints n_long and longest. scans[1] is
    not run when `longest` (a bound on a's length the caller knows on the
    host) is at most L_WARP."""
    n = ai.numel()
    dev = seq_buf.device
    out_len = torch.empty(n, dtype=torch.int64, device=dev)
    out_score = torch.empty(n, dtype=torch.float64, device=dev)
    la = seq_off[ai.long() + 1] - seq_off[ai.long()]
    order, n_short = split_by_length(la)
    if longest is not None and longest <= L_WARP:
        scans = scans[:1]
    for scan in scans:
        scan(seq_buf, seq_off, ai, bi, order, n_short, min_olen, min_score,
             out_len, out_score, n_long, longest)
    return out_len, out_score


def longest_of(seq_off: np.ndarray) -> int:
    """The longest sequence of a table by its host offsets (0 if none):
    overlap_best_indexed's `longest`."""
    return int(np.diff(seq_off).max(initial=0))


def count_long(seq_off: np.ndarray, ai: np.ndarray) -> int:
    """The pairs whose a is longer than L_WARP, by the table's host
    offsets and the host's index array: overlap_best_indexed's
    `n_long`."""
    return int((np.diff(seq_off)[ai] > L_WARP).sum())


def overlap_best_indexed(seq_buf, seq_off, ai, bi, min_olen: int,
                         min_score: float, longest=None, n_long=None):
    """(len [n] int64, score [n] f64) on seq_buf's device: the reference
    winner of each pair (sequence ai[i], sequence bi[i]) of the table
    (seq_buf uint8, seq_off [S+1] int64; ai, bi int32 [n]). `longest`,
    when given, bounds the length of every a (longest_of the table):
    at most L_WARP, the block kernel is not launched. `n_long`, when
    given, is the count of pairs whose a is longer than L_WARP
    (count_long), which sizes the block kernel's launch without a wait
    on the card.

    CUDA tensors run overlap_warp_kernel and overlap_best_kernel on their
    length classes, on the current stream; the host waits on the card
    only where the long class runs and n_long is not given (block_scan
    then reads it); a failed build or launch raises. CPU
    tensors run the threaded native scan (cpp/overlapbest.cpp): this is
    the port's one CPU route that is the native library and not the plain
    torch version (plain_indexed), because the native scan is what
    keelime runs on the host in production."""
    dev = _check_indexed(seq_buf, seq_off, ai, bi)
    n = ai.numel()
    if n == 0:
        return (torch.empty(0, dtype=torch.int64, device=dev),
                torch.empty(0, dtype=torch.float64, device=dev))
    if dev.type == "cpu":
        out_len = torch.empty(n, dtype=torch.int64)
        out_score = torch.empty(n, dtype=torch.float64)
        _native_scan(seq_codes(seq_buf), seq_off.contiguous(), ai, bi,
                     min_olen, min_score, out_len, out_score)
        return out_len, out_score
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return scan_by_class(seq_buf.contiguous(), seq_off.contiguous(),
                         ai.contiguous(), bi.contiguous(), min_olen,
                         min_score, longest, n_long=n_long)


def overlap_best_batch(pairs: Sequence[Tuple[str, str]], min_olen: int,
                       min_score: float, device) -> List[Tuple[int, float]]:
    """Reference-exact (length, score) for every (a, b) pair: the pairs'
    strings interned into one table, then overlap_best_indexed on
    `device`. Nothing falls back."""
    if not pairs:
        return []
    ids: Dict[str, int] = {}
    ai = np.fromiter((ids.setdefault(a, len(ids)) for a, _ in pairs),
                     np.int32, len(pairs))
    bi = np.fromiter((ids.setdefault(b, len(ids)) for _, b in pairs),
                     np.int32, len(pairs))
    dev = torch.device(device)
    buf, off = intern(list(ids))
    out_len, out_score = overlap_best_indexed(
        *(torch.from_numpy(x).to(dev) for x in (buf, off, ai, bi)),
        min_olen, min_score, longest_of(off), count_long(off, ai))
    return list(zip(out_len.cpu().tolist(), out_score.cpu().tolist()))


# ------------------------------------------------------------ plain version
def _bucket(x: int, q: int = 64) -> int:
    return max(q, -(-x // q) * q)


def padded_chunks(pairs: Sequence[Tuple[str, str]], chunk: int, device):
    """The pair list cut into chunks of `chunk` pairs, La and Lb padded
    to multiples of 64 as JAX's overlap_scores_batch pads them, padding
    bytes 0: yields (A [N, La] uint8, B [N, Lb] uint8, la [N] int64,
    lb [N] int64, N)."""
    for i in range(0, len(pairs), chunk):
        batch = pairs[i : i + chunk]
        nb = len(batch)
        La = _bucket(max(len(a) for a, _ in batch))
        Lb = _bucket(max(len(b) for _, b in batch))
        A = np.zeros((nb, La), dtype=np.uint8)
        B = np.zeros((nb, Lb), dtype=np.uint8)
        la = np.zeros(nb, dtype=np.int64)
        lb = np.zeros(nb, dtype=np.int64)
        for n, (a, b) in enumerate(batch):
            ea, eb = _enc(a), _enc(b)
            A[n, : len(ea)] = ea
            B[n, : len(eb)] = eb
            la[n] = len(ea)
            lb[n] = len(eb)
        yield tuple(torch.from_numpy(x).to(device) for x in (A, B, la, lb)) \
            + (nb,)


def overlap_scores_plain(A, B, la, lb, table=None, max_elems: int = 1 << 22):
    """The [N, La] score matrix of _overlap_scores_device in torch, f32:
    scores[n, s] = sum over j < min(lb, la - s) of TABLE[A[n, s+j],
    B[n, j]], TABLE the byte table keelime._COMBINED unless `table` (f32,
    indexed by A's and B's values) is given. Starts are taken in groups
    so that the gathered [N, starts, Lb] block stays within max_elems
    elements."""
    N, La = A.shape
    Lb = B.shape[1]
    dev = A.device
    if table is None:
        table = torch.from_numpy(_COMBINED.astype(np.float32)).to(dev)
    j = torch.arange(Lb, device=dev)
    valid_b = j[None, :] < lb[:, None]  # [N, Lb]
    ai, bi = A.long(), B.long()
    out = torch.zeros((N, La), dtype=torch.float32, device=dev)
    step = max(1, min(La, max_elems // max(1, N * Lb)))
    for s0 in range(0, La, step):
        s = torch.arange(s0, min(La, s0 + step), device=dev)
        ia = s[:, None] + j[None, :]  # [S, Lb]
        in_a = ia[None] < la[:, None, None]  # [N, S, Lb]
        ag = ai[:, ia.clamp(max=La - 1)]  # [N, S, Lb]
        pair = table[ag, bi[:, None, :]]
        m = valid_b[:, None, :] & in_a
        out[:, s] = torch.where(m, pair, 0.0).sum(dim=2)
    return out


def winner(S, la, lb, min_olen: int, min_score: float):
    """JAX's winner rule (keelime_device.py:107-124) on a score matrix
    S [N, La]: among starts with olen >= min_olen, score >= min_score
    and start <= la - min_olen, the longest olen, ties by score.
    Returns (length [N] int64, score [N] f64), (0, 0.0) where none
    qualifies."""
    S = S.double()  # min_score compares in f64, as JAX's host rule does
    La = S.shape[1]
    starts = torch.arange(La, device=S.device)
    olen = torch.minimum(lb[:, None], la[:, None] - starts[None, :])
    ok = ((olen >= min_olen) & (S >= min_score)
          & (starts[None, :] <= (la[:, None] - min_olen)))
    best_len = torch.where(ok, olen, -1).max(dim=1).values
    at_best = ok & (olen == best_len[:, None])
    sc = torch.where(at_best, S, -torch.inf).max(dim=1).values
    has = best_len >= 0
    return (torch.where(has, best_len, 0),
            torch.where(has, sc, torch.zeros_like(sc)))


def _padded_codes(codes, seq_off, idx):
    """([N, L] the codes of the sequences idx, L = their longest length
    bucketed to a multiple of 64, padded with the zero code; their
    lengths [N] int64)."""
    start = seq_off[idx.long()]
    ln = seq_off[idx.long() + 1] - start
    j = torch.arange(_bucket(int(ln.max())), device=codes.device)
    padded = torch.nn.functional.pad(codes, (0, 1), value=OTHER)
    mat = padded[(start[:, None] + j[None, :]).clamp(max=len(codes))]
    return torch.where(j[None, :] < ln[:, None], mat, OTHER), ln


def plain_indexed(codes, seq_off, ai, bi, min_olen: int, min_score: float,
                  chunk: int = 4096):
    """Plain PyTorch version of the scan on a code table (seq_codes'
    output): (len [n] int64, score [n] f64) of the pairs (ai[i], bi[i]),
    by JAX's score matrix (overlap_scores_plain over the 16-code table)
    and winner rule, `chunk` pairs at a time, on codes' device."""
    half = _tables(codes.device)["half"]
    lens, scores = [], []
    for c0 in range(0, len(ai), chunk):
        A, la = _padded_codes(codes, seq_off, ai[c0 : c0 + chunk])
        B, lb = _padded_codes(codes, seq_off, bi[c0 : c0 + chunk])
        ln, sc = winner(overlap_scores_plain(A, B, la, lb, table=half), la,
                        lb, min_olen, min_score)
        lens.append(ln)
        scores.append(sc)
    if not lens:
        return (torch.empty(0, dtype=torch.int64, device=codes.device),
                torch.empty(0, dtype=torch.float64, device=codes.device))
    return torch.cat(lens), torch.cat(scores)


def _plain_class(seq_buf, seq_off, ai, bi, ks, min_olen, min_score,
                 out_len, out_score):
    ln, sc = plain_indexed(seq_codes(seq_buf), seq_off, ai[ks.long()],
                           bi[ks.long()], min_olen, min_score)
    out_len[ks.long()] = ln
    out_score[ks.long()] = sc


def plain_warp_scan(seq_buf, seq_off, ai, bi, order, n_short, min_olen,
                    min_score, out_len, out_score, n_long=None,
                    longest=None):
    """warp_scan's plain version: plain_indexed on order[:n_short] (the
    hints unused)."""
    _plain_class(seq_buf, seq_off, ai, bi, order[: int(n_short)], min_olen,
                 min_score, out_len, out_score)


def plain_block_scan(seq_buf, seq_off, ai, bi, order, n_short, min_olen,
                     min_score, out_len, out_score, n_long=None,
                     longest=None):
    """block_scan's plain version: plain_indexed on order[n_short:] (the
    hints unused)."""
    _plain_class(seq_buf, seq_off, ai, bi, order[int(n_short):], min_olen,
                 min_score, out_len, out_score)


def overlap_scores_batch(pairs: Sequence[Tuple[str, str]], min_olen: int,
                         min_score: float, chunk: int = 4096,
                         device="cpu") -> List[Tuple[int, float]]:
    """Plain PyTorch version of JAX's overlap_scores_batch: reference-
    exact (length, score) for every (a, b) pair, scored in chunks of
    `chunk` pairs on `device` (keelime_device.py:65-126)."""
    out: List[Tuple[int, float]] = []
    for A, B, la, lb, nb in padded_chunks(pairs, chunk, device):
        ln, sc = winner(overlap_scores_plain(A, B, la, lb), la, lb,
                        min_olen, min_score)
        out.extend(zip(ln[:nb].cpu().tolist(), sc[:nb].cpu().tolist()))
    return out
