"""keelime's long-pair overlap scan (overlap_best_kernel in
vgan_tpu_torch/csrc/keelime.cu: one thread-block cluster of G CTAs a
pair, the overlap positions split across the cluster), on the CPU:

* long_cluster_size, the host's choice of G, on injected residency
  functions (the card's cudaOccupancyMaxActiveClusters): the merge
  calls' 4, 12, 80 and 400 long pairs, short long pairs, a card that
  holds no cluster of 16; and long_clusters, the grid.
* plain_cluster_scan, a numpy model of the kernel's decomposition (G
  position chunks of at least MIN_CHUNK, rounds of S starts, the partial
  sums added across the chunks in int32, the full block's max over its
  rounds, the tail's first qualifying start of the first round with
  one), equal to the native scan (overlap_best_indexed on the CPU) and to
  the JAX package (its per-pair scorer keelime.overlap_score everywhere,
  its device batch overlap_scores_batch where the pairs are short enough
  for its [starts, 256, Lb] buffers) for G in {1, 2, 3, 8, 16} and S in
  {32, 128}, on tests/_torch_world.py's long cases.

The model is used only here; the kernel itself is held against
plain_block_scan and the native scan on the card (tests/test_torch_cuda.py).
"""
import functools

import numpy as np
import pytest
import torch

import _torch_world as world
from vgan_tpu.pipelines import keelime as jax_kl
from vgan_tpu.pipelines import keelime_device as jax_kd
from vgan_tpu_torch.pipelines import keelime_device as port_kd

torch.set_num_threads(1)

LUT, T2 = port_kd.code_tables()
JAX_BATCH_MAX_BP = 1200  # longer pairs: JAX's batch buffers pass 2 GB


@functools.lru_cache(maxsize=None)
def _cases():
    return world.long_overlap_cases(LUT, T2)


CASES = ["a257", "lb_gt_la", "tail_round2", "early_late_chunks",
         "full_near_miss", "no_winner", "la_lt_min_olen",
         "outside_alphabet", "mitogenome"]


def plain_cluster_scan(pairs, min_olen, min_score, G, S):
    """(length, score) of each pair (a, b) as overlap_best_kernel
    decomposes its scan: the span L = min(la, lb') (lb' = la + 1 where b
    is longer) cut into g = max(1, min(G, L // MIN_CHUNK)) chunks of
    ceil(L / g) positions rounded up to a multiple of 4; rounds of S
    starts, each chunk's int32 partial sums of the doubled table added
    up; the full-length block's max over all its rounds, else the first
    qualifying start of the first tail round that has one."""
    out = []
    for a, b in pairs:
        ca = LUT[np.frombuffer(a.encode("latin-1"), np.uint8)]
        cb = LUT[np.frombuffer(b.encode("latin-1"), np.uint8)]
        la = len(ca)
        if la < min_olen or len(cb) == 0:
            out.append((0, 0.0))
            continue
        lb = la + 1 if len(cb) > la else len(cb)
        L = min(la, lb)
        g = max(1, min(G, L // port_kd.MIN_CHUNK))
        C = (-(-L // g) + 3) // 4 * 4
        chunks = [(min(r * C, L), min((r + 1) * C, L)) for r in range(G)]
        pad_a = np.concatenate([ca, np.full(S + L, port_kd.OTHER,
                                            np.uint8)])
        pad_b = np.concatenate([cb[:L], np.full(S, port_kd.OTHER,
                                                np.uint8)])

        def round_sums(s0, end):
            """[S] int32: each start's sum over positions < end, chunk
            by chunk."""
            s = s0 + np.arange(S)
            tot = np.zeros(S, np.int32)
            for j0, j1 in chunks:
                j = np.arange(j0, max(j0, min(j1, end)))
                part = T2[pad_a[s[:, None] + j[None, :]], pad_b[j][None, :]]
                tot += part.sum(axis=1, dtype=np.int64).astype(np.int32)
            return tot

        n_full = la - lb + 1
        res = None
        if n_full > 0 and lb >= min_olen:
            best2 = None
            for s0 in range(0, n_full, S):
                tot = round_sums(s0, lb)[: n_full - s0]
                m = int(tot.max())
                best2 = m if best2 is None else max(best2, m)
            if best2 * 0.5 >= min_score:
                res = (lb, best2 * 0.5)
        if res is None:
            hi = la - min_olen + 1
            for s0 in range(max(n_full, 0), hi, S):
                tot = round_sums(s0, la - s0)[: hi - s0]
                ok = np.flatnonzero(tot * 0.5 >= min_score)
                if ok.size:
                    t = int(ok[0])
                    res = (la - (s0 + t), float(tot[t]) * 0.5)
                    break
        out.append(res or (0, 0.0))
    return out


@functools.lru_cache(maxsize=None)
def _want(case):
    """JAX's answers for a case: its per-pair scorer, held equal to its
    device batch where the pairs are short enough."""
    pairs, min_olen, min_score = _cases()[case]
    want = [jax_kl.overlap_score(a, b, min_olen, min_score)
            for a, b in pairs]
    if max(len(x) for p in pairs for x in p) <= JAX_BATCH_MAX_BP:
        assert jax_kd.overlap_scores_batch(pairs, min_olen, min_score,
                                           chunk=64) == want
    return want


@functools.lru_cache(maxsize=None)
def _native(case):
    pairs, min_olen, min_score = _cases()[case]
    ids = {}
    ai = np.array([ids.setdefault(a, len(ids)) for a, _ in pairs], np.int32)
    bi = np.array([ids.setdefault(b, len(ids)) for _, b in pairs], np.int32)
    buf, off = port_kd.intern(list(ids))
    ln, sc = port_kd.overlap_best_indexed(
        *(torch.from_numpy(x) for x in (buf, off, ai, bi)), min_olen,
        min_score)
    return list(zip(ln.tolist(), sc.tolist()))


@pytest.mark.parametrize("S", [32, 128])
@pytest.mark.parametrize("G", [1, 2, 3, 8, 16])
@pytest.mark.parametrize("case", CASES)
def test_cluster_decomposition_equals_native_and_jax(case, G, S):
    pairs, min_olen, min_score = _cases()[case]
    assert all(len(a) > port_kd.L_WARP for a, _ in pairs)
    got = plain_cluster_scan(pairs, min_olen, min_score, G, S)
    assert got == _native(case) == _want(case)


def test_cases_hold_what_they_plant():
    """The winners the cases are built for: a tail winner in the second
    round of 128 starts (s = 200, 128, 129 from t0 = 1), the first of two
    qualifiers in one round (s = 10 scored in late chunks, s = 30 in
    early ones), the full block's miss beside its hit, no winner, and the
    mitogenome pairs' winners at s = 0, 150 and 120."""
    want = {case: _want(case) for case in CASES}
    assert [ln for ln, _ in want["tail_round2"]] == [1000, 1072, 1071]
    assert [ln for ln, _ in want["early_late_chunks"]] == [1990, 1970]
    assert want["full_near_miss"] == [(0, 0.0), (401, 1203.0)]
    assert want["no_winner"] == [(0, 0.0)] * 3
    assert want["la_lt_min_olen"] == [(0, 0.0)] * 2
    assert want["outside_alphabet"][0][0] == 600
    assert [ln for ln, _ in want["mitogenome"]] == [16569, 15850, 16280]


def _resident(table):
    return lambda G: table[G]


# an H100's 132 SMs; clusters resident at once by size
H100 = {1: 264, 2: 132, 4: 64, 8: 32, 16: 16}


@pytest.mark.parametrize("n_long,longest,resident,want", [
    (4, 16569, H100, 16),        # the smallest mitogenome merge call
    (8, 16569, H100, 16),        # 8 x 16 = 128 SMs
    (12, 16569, H100, 8),        # 12 x 16 > 132
    (20, 5222, H100, 4),
    (80, 2316, H100, 1),         # the largest merge batch's long class
    (400, 2316, H100, 1),        # more pairs than SMs: blocks queue
    (4, 300, H100, 1),           # short: one chunk of >= 256 positions
    (4, 1100, H100, 4),          # 4 chunks of 275
    (4, 4095, H100, 8),          # 16 x 256 > 4,095
    (4, None, H100, 16),         # length not known
    (4, 16569, {**H100, 16: 0}, 8),   # no cluster of 16 fits
    (12, 16569, {**H100, 8: 11}, 4),  # 11 clusters of 8 at once
    (0, 16569, H100, 1),         # no long pair
])
def test_long_cluster_size(n_long, longest, resident, want):
    got = port_kd.long_cluster_size(n_long, longest, 132,
                                    _resident(resident))
    assert got == want
    assert got in port_kd.CLUSTER_SIZES


def test_long_cluster_size_asks_the_card_last():
    """resident() is asked only for sizes the SM count and the length
    allow, largest first."""
    asked = []

    def resident(G):
        asked.append(G)
        return 0

    assert port_kd.long_cluster_size(12, 16569, 132, resident) == 1
    assert asked == [8, 4, 2]


@pytest.mark.parametrize("n_long,G,resident,want", [
    (4, 16, 16, 4), (80, 1, 264, 80), (400, 1, 264, 264), (0, 8, 32, 1),
    (3, 16, 0, 1)])
def test_long_clusters(n_long, G, resident, want):
    assert port_kd.long_clusters(n_long, G, lambda g: resident) == want


def test_min_chunk_is_the_kernels():
    import os
    import re

    src = open(os.path.join(os.path.dirname(port_kd.__file__), os.pardir,
                            "csrc", "keelime.cu")).read()
    m = re.search(r"constexpr int kMinChunk = (\d+);", src)
    assert m and int(m.group(1)) == port_kd.MIN_CHUNK


def test_pair_table_scores_two_cells():
    """pair_table(t2)[(a0 | a1 << 4) | (b0 | b1 << 4) << 8] = t2[a0, b0]
    + t2[a1, b1], the table the kernels look up twice for four cells."""
    ptab = port_kd.pair_table(T2)
    assert ptab.dtype == np.int8 and ptab.shape == (1 << 16,)
    rng = np.random.default_rng(3)
    a0, a1, b0, b1 = rng.integers(0, 16, (4, 500))
    k = a0 | a1 << 4 | (b0 | b1 << 4) << 8
    assert np.array_equal(ptab[k], T2[a0, b0] + T2[a1, b1])
