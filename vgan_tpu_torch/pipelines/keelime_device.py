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

* `overlap_best_batch(pairs, min_olen, min_score, device)` is what
  keelime calls. On a CUDA device it packs the pairs once and launches
  `overlap_best_kernel` (csrc/keelime.cu); on the CPU it runs the
  threaded native scan (cpp/overlapbest.cpp), as the JAX package does
  in production.
* `overlap_best_packed` is the tensor-level wrapper both routes share.
  It counts `LAUNCHES["overlap_best"]` where it launches the kernel.
* `overlap_scores_batch(pairs, min_olen, min_score, chunk, device)` is
  the plain PyTorch version of JAX's `overlap_scores_batch`: the
  [N, La] score matrix as `_overlap_scores_device` builds it, and its
  winner rule. It is the oracle of the tests and of the smoke test on
  the card, never on the CLI's path.

Every score is a multiple of 0.5 (the table holds halves only), so the
kernel's int32 sums of the doubled table, the native scan's and the f32
sums of the plain version are all exact: the three agree bit for bit.
"""
from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .keelime import _ALPHABET, _COMBINED, _enc

LAUNCHES: Dict[str, int] = {"overlap_best": 0}
"""Kernel launches since the last reset_launches()."""


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


def pack_pairs(pairs: Sequence[Tuple[str, str]]):
    """The pair list as the native scan and the kernel take it: (abuf
    uint8, aoff [n+1] int64, bbuf uint8, boff [n+1] int64), the latin-1
    bytes of all a's (b's) back to back and their offsets."""
    n = len(pairs)
    aoff = np.zeros(n + 1, dtype=np.int64)
    boff = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(a) for a, _ in pairs], out=aoff[1:])
    np.cumsum([len(b) for _, b in pairs], out=boff[1:])
    abuf = _enc("".join(a for a, _ in pairs)).copy()  # writable, for torch
    bbuf = _enc("".join(b for _, b in pairs)).copy()
    return abuf, aoff, bbuf, boff


# ------------------------------------------------------------ the scan
def _check_packed(abuf, aoff, bbuf, boff) -> torch.device:
    dev = abuf.device
    for t in (aoff, bbuf, boff):
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and "
                             f"{t.device}")
    if abuf.dtype != torch.uint8 or bbuf.dtype != torch.uint8:
        raise ValueError("overlap_best_packed: abuf and bbuf must be uint8")
    if aoff.dtype != torch.int64 or boff.dtype != torch.int64 \
            or aoff.dim() != 1 or aoff.shape != boff.shape:
        raise ValueError("overlap_best_packed: aoff and boff must be int64 "
                         "[n + 1]")
    return dev


def overlap_best_packed(abuf, aoff, bbuf, boff, min_olen: int,
                        min_score: float):
    """(out_len [n] int64, out_score [n] f64) of every packed pair (see
    pack_pairs), on the inputs' device.

    CUDA tensors launch overlap_best_kernel (csrc/keelime.cu) on the
    current stream; a failed build or launch raises. CPU tensors run
    the threaded native scan (cpp/overlapbest.cpp) on the same packed
    arrays: this is the port's one CPU route that is the native library
    and not the plain torch version (overlap_scores_batch), because the
    native scan is what keelime runs on the host in production."""
    dev = _check_packed(abuf, aoff, bbuf, boff)
    n = aoff.shape[0] - 1
    # both routes write every element
    out_len = torch.empty(n, dtype=torch.int64, device=dev)
    out_score = torch.empty(n, dtype=torch.float64, device=dev)
    if n == 0:
        return out_len, out_score
    if dev.type == "cpu":
        from . import keelime

        lib = keelime._ovb_lib()  # also builds keelime._COMBINED2_I16
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i16p = ctypes.POINTER(ctypes.c_int16)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)

        def p(t, typ):
            return ctypes.cast(t.data_ptr(), typ)

        lib.overlap_best_batch(
            p(abuf.contiguous(), u8p), p(aoff.contiguous(), i64p),
            p(bbuf.contiguous(), u8p), p(boff.contiguous(), i64p),
            n, keelime._COMBINED2_I16.ctypes.data_as(i16p), min_olen,
            float(min_score),
            p(out_len, i64p), p(out_score, f64p),
            min(8, os.cpu_count() or 1),
        )
        return out_len, out_score
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from .._native import keelime_lib

    lut, t2 = _device_tables(dev)
    a, ao = abuf.contiguous(), aoff.contiguous()
    b, bo = bbuf.contiguous(), boff.contiguous()
    lib = keelime_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.overlap_best_launch(
            a.data_ptr(), ao.data_ptr(), b.data_ptr(), bo.data_ptr(), n,
            lut.data_ptr(), t2.data_ptr(), int(min_olen), float(min_score),
            out_len.data_ptr(), out_score.data_ptr(),
            ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(f"overlap_best kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["overlap_best"] += 1
    return out_len, out_score


_TABLE_CACHE: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _device_tables(dev: torch.device):
    """code_tables() on `dev`, uploaded once a device."""
    tabs = _TABLE_CACHE.get(dev)
    if tabs is None:
        lut, t2 = code_tables()
        tabs = (torch.from_numpy(lut).to(dev),
                torch.from_numpy(t2.reshape(-1)).to(dev))
        _TABLE_CACHE[dev] = tabs
    return tabs


def overlap_best_batch(pairs: Sequence[Tuple[str, str]], min_olen: int,
                       min_score: float, device) -> List[Tuple[int, float]]:
    """Reference-exact (length, score) for every (a, b) pair: on a CUDA
    device the pairs are packed once, uploaded and scanned by
    overlap_best_kernel; on the CPU by the threaded native scan (the
    JAX package's production route). Nothing falls back."""
    if not pairs:
        return []
    dev = torch.device(device)
    packed = [torch.from_numpy(x).to(dev) for x in pack_pairs(pairs)]
    out_len, out_score = overlap_best_packed(*packed, min_olen, min_score)
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


def overlap_scores_plain(A, B, la, lb, max_elems: int = 1 << 22):
    """The [N, La] score matrix of _overlap_scores_device in torch, f32:
    scores[n, s] = sum over j < min(lb, la - s) of TABLE[A[n, s+j],
    B[n, j]]. Starts are taken in groups so that the gathered
    [N, starts, Lb] block stays within max_elems elements."""
    N, La = A.shape
    Lb = B.shape[1]
    dev = A.device
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
