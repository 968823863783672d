"""Port's Smith-Waterman scorers (vgan_tpu_torch/mapper/sw.py) against
the JAX package's (vgan_tpu/mapper/sw_pallas.py), on the CPU.

The port's wrappers run their plain torch versions for CPU tensors; the
JAX side runs the Pallas kernel in interpret mode and the XLA twin, as
tests/test_sw_pallas.py does. Every score is a small integer, so
scores and both content hashes must agree bit for bit.
"""
import numpy as np
import pytest
import torch

from vgan_tpu.mapper import sw_pallas
from vgan_tpu_torch.mapper import sw

torch.set_num_threads(1)


def _make_batch(rng, B=16, R=64, W=128):
    """tests/test_sw_pallas.py:_make_batch: reads planted in their
    windows with 5% substitutions."""
    read = np.full((B, R), 255, dtype=np.int32)
    win = np.full((B, W), 255, dtype=np.int32)
    rlen = rng.integers(20, R, size=B).astype(np.int32)
    wlen = rng.integers(60, W, size=B).astype(np.int32)
    for b in range(B):
        w = rng.integers(0, 4, size=wlen[b])
        win[b, : wlen[b]] = w
        start = (rng.integers(0, max(1, wlen[b] - rlen[b]))
                 if wlen[b] > rlen[b] else 0)
        r = w[start : start + rlen[b]].copy()
        if len(r) < rlen[b]:
            r = np.concatenate([r, rng.integers(0, 4, size=rlen[b] - len(r))])
        mut = rng.random(rlen[b]) < 0.05
        r[mut] = rng.integers(0, 4, size=int(mut.sum()))
        read[b, : rlen[b]] = r
    return read, win, rlen, wlen


def _edge_batch(rng, B=24, R=40, W=72):
    """N (code 4) bases on both sides, rlen == R, rlen == 0, zero-length
    windows and windows longer than the read."""
    read, win, rlen, wlen = _make_batch(rng, B, R, W)
    read[read < 4] = np.where(rng.random(read[read < 4].shape) < 0.1, 4,
                              read[read < 4])
    win[win < 4] = np.where(rng.random(win[win < 4].shape) < 0.1, 4,
                            win[win < 4])
    full = rng.integers(0, 4, size=(4, R)).astype(np.int32)
    read[:4] = full
    rlen[:4] = R
    win[:4, :R] = full
    wlen[:4] = R
    wlen[4:8] = 0
    rlen[8:10] = 0
    return read, win, rlen, wlen


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


def _port_scores(read, win, rlen, wlen):
    return sw.sw_scores(*(torch.from_numpy(a) for a in (read, win, rlen, wlen)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sw_scores_bit_equal_to_pallas_and_xla(seed):
    read, win, rlen, wlen = _make_batch(np.random.default_rng(seed))
    got = _bits(_port_scores(read, win, rlen, wlen).numpy())
    pallas = _bits(sw_pallas.sw_scores(read, win, rlen, wlen, interpret=True))
    xla = _bits(sw_pallas.sw_scores_xla(read, win, rlen, wlen))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, xla)


@pytest.mark.parametrize("seed", [3, 4])
def test_sw_scores_edge_cases_bit_equal(seed):
    read, win, rlen, wlen = _edge_batch(np.random.default_rng(seed))
    got = _bits(_port_scores(read, win, rlen, wlen).numpy())
    pallas = _bits(sw_pallas.sw_scores(read, win, rlen, wlen, interpret=True))
    xla = _bits(sw_pallas.sw_scores_xla(read, win, rlen, wlen))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, xla)
    # the planted full-length exact matches score L + both bonuses
    assert (got[:4].view(np.float32) == read.shape[1] + 10).all()
    assert (got[4:8].view(np.float32) == 0).all()


# a 1,024-row read bucket over 1,152 columns (past the 807-row limit of
# a thread-per-pair kernel), and a window width that is no multiple of 32
@pytest.mark.parametrize("B,R,W,seed", [(8, 1024, 1152, 6),
                                        (16, 64, 200, 7)])
def test_sw_scores_plain_bit_equal_to_xla_and_reference(B, R, W, seed):
    read, win, rlen, wlen = _make_batch(np.random.default_rng(seed), B, R, W)
    got = _bits(sw.sw_scores_plain(
        *(torch.from_numpy(a) for a in (read, win, rlen, wlen))).numpy())
    xla = _bits(sw_pallas.sw_scores_xla(read, win, rlen, wlen))
    ref = _bits(sw_pallas.sw_scores_reference(read, win, rlen, wlen))
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, ref)


def _random_pool_batch(rng, aux_dtype, n_reads=40, Rmax=64, Wmax=128,
                       n_cand=150, pad_to=256):
    gap = max(100, Rmax + 36)  # pool offset between planted reads
    pool = rng.integers(0, 5, size=max(5000, gap * n_reads + Wmax))
    pool = pool.astype(np.uint8)
    reads_mat = np.full((64, Rmax), 255, dtype=np.uint8)
    read_lens = np.zeros(64, dtype=np.int32)
    read_lens[:n_reads] = rng.integers(20, Rmax + 1, size=n_reads)
    for i in range(n_reads):
        reads_mat[i, : read_lens[i]] = rng.integers(
            0, 5, size=read_lens[i])
    # plant a few reads (and their reverse complements) in the pool
    comp = np.array([3, 2, 1, 0, 4], dtype=np.uint8)
    for i in range(0, n_reads, 3):
        L = read_lens[i]
        seg = reads_mat[i, :L] if i % 2 else comp[reads_mat[i, :L]][::-1]
        off = gap * i
        pool[off : off + L] = seg
    aux = np.zeros((4, pad_to), dtype=aux_dtype)
    c_read = rng.integers(0, n_reads, size=n_cand)
    aux[0, :n_cand] = c_read
    aux[1, :n_cand] = np.where(
        rng.random(n_cand) < 0.3, gap * c_read - 5,
        rng.integers(0, len(pool) - Wmax, size=n_cand))
    aux[1, :n_cand] = np.clip(aux[1, :n_cand], 0, None)
    aux[2, :n_cand] = rng.integers(1, Wmax + 1, size=n_cand)
    aux[3, :n_cand] = rng.integers(0, 2, size=n_cand)
    return pool, reads_mat, read_lens, aux, Wmax


# both aux dtypes at euka's widths, and 1,024-row reads (the card's
# kernel sweeps them in four bands) on fewer candidate rows
@pytest.mark.parametrize("aux_dtype,Rmax,Wmax,n_cand,pad_to", [
    pytest.param(np.int32, 64, 128, 150, 256, id="int32"),
    pytest.param(np.int64, 64, 128, 150, 256, id="int64"),
    pytest.param(np.int32, 1024, 1088, 20, 32, id="int32-Rmax1024")])
def test_gather_score_hash_bit_equal_to_jax(aux_dtype, Rmax, Wmax, n_cand,
                                            pad_to):
    """Scores and both hashes, over both strands, padding rows (wlen 0)
    and both aux dtypes."""
    pool, reads_mat, read_lens, aux, Wmax = _random_pool_batch(
        np.random.default_rng(11), aux_dtype, Rmax=Rmax, Wmax=Wmax,
        n_cand=n_cand, pad_to=pad_to)
    want = np.asarray(sw_pallas.gather_score_hash(
        pool, reads_mat, read_lens, aux, Wmax))
    scores, h1, h2 = sw.gather_score_hash(
        torch.from_numpy(pool), torch.from_numpy(reads_mat),
        torch.from_numpy(read_lens), torch.from_numpy(aux), Wmax)
    np.testing.assert_array_equal(_bits(scores.numpy()), want[0])
    np.testing.assert_array_equal(h1.numpy(), want[1])
    np.testing.assert_array_equal(h2.numpy(), want[2])
    # the planted reads score a full-length exact hit on their strand
    assert float(scores.max()) >= float(read_lens.min()) + 10
    # padding rows: score 0, the hash of an all-255 window
    assert (scores.numpy()[n_cand:] == 0).all()
    assert len(set(h1.numpy()[n_cand:].tolist())) == 1


def test_cpu_wrappers_run_plain_and_count_no_launch():
    read, win, rlen, wlen = _make_batch(np.random.default_rng(5))
    sw.reset_launches()
    got = _port_scores(read, win, rlen, wlen)
    want = sw.sw_scores_plain(*(torch.from_numpy(a)
                                for a in (read, win, rlen, wlen)))
    assert torch.equal(got, want)
    assert sw.LAUNCHES == {"sw_scores": 0, "gather_score_hash": 0}


def test_wrappers_reject_mixed_or_unsupported_devices():
    t = torch.zeros((2, 4), dtype=torch.int32)
    lens = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        sw.sw_scores(t, t.to("meta"), lens, lens)
    with pytest.raises(ValueError):
        sw.sw_scores(*(x.to("meta") for x in (t, t, lens, lens)))
