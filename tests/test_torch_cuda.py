"""CUDA kernels of the port (csrc/sw.cu) against their plain torch
versions, and the device paths of the mapper, the euka scorer and the
abundance MCMC against the same code on the CPU, on the card. Marked
`cuda`: they skip where torch.cuda.is_available() is false. This file imports neither jax nor
vgan_tpu, so it also runs where jax is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import os
import sys

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", torch.cuda.current_device())


def _planted(rng, B, R, W):
    """Reads planted in their windows with 3% substitutions; random
    lengths (0 included), with rlen == 0 and wlen == 0 forced."""
    win = rng.integers(0, 5, size=(B, W)).astype(np.int32)
    wlen = rng.integers(0, W + 1, size=B).astype(np.int32)
    read = np.full((B, R), 255, dtype=np.int32)
    rlen = rng.integers(0, R + 1, size=B).astype(np.int32)
    rlen[0] = 0
    wlen[min(1, B - 1)] = 0
    win[np.arange(W)[None, :] >= wlen[:, None]] = 255
    for b in range(B):
        s = int(rng.integers(0, max(1, wlen[b] - rlen[b] + 1)))
        seg = win[b, s : s + rlen[b]].copy()
        seg[seg == 255] = 4
        seg[rng.random(len(seg)) < 0.03] = 1
        read[b, : len(seg)] = seg
    return read, win, rlen, wlen


# every rows-per-lane bucket (R = 32 ... 256), several bands (288, 300,
# 1,024: past the 807-row shared-memory limit of a thread-per-pair
# design), fewer pairs than a block's 8 warps, a batch that is not a
# multiple of 8, and window widths that are not multiples of 32
@pytest.mark.parametrize("B,R,W", [
    (16, 64, 128), (1000, 128, 192), (64, 300, 400), (5, 32, 64),
    (37, 96, 200), (300, 256, 320), (45, 288, 320), (12, 1024, 1152),
])
def test_sw_scores_kernel_equals_plain(dev, B, R, W):
    from vgan_tpu_torch.mapper import sw

    args = [torch.from_numpy(a).to(dev)
            for a in _planted(np.random.default_rng(B + R), B, R, W)]
    sw.reset_launches()
    got = sw.sw_scores(*args)
    torch.cuda.synchronize()
    assert sw.LAUNCHES["sw_scores"] == 1
    assert torch.equal(got, sw.sw_scores_plain(*args))


# (aux dtype, rows M, live rows, Rmax, Wmax): both aux dtypes at the
# mapper's widths, M below one block and not a multiple of 8, Wmax 200,
# several bands at Rmax 288 and 1,024; windows run past the pool's end
@pytest.mark.parametrize("aux_dtype,M,m,Rmax,Wmax", [
    pytest.param(np.int32, 4096, 3500, 128, 256, id="int32"),
    pytest.param(np.int64, 4096, 3500, 128, 256, id="int64"),
    (np.int32, 5, 5, 32, 64), (np.int64, 1003, 900, 96, 200),
    (np.int32, 300, 280, 288, 320), (np.int32, 64, 60, 1024, 1152),
])
def test_gather_score_hash_kernel_equals_plain(dev, aux_dtype, M, m, Rmax,
                                               Wmax):
    from vgan_tpu_torch.mapper import sw

    rng = np.random.default_rng(3)
    P, n_reads = 200_000, 512
    pool = rng.integers(0, 5, size=P).astype(np.uint8)
    reads_mat = np.full((n_reads, Rmax), 255, dtype=np.uint8)
    read_lens = rng.integers(0, Rmax + 1, size=n_reads).astype(np.int32)
    for i in range(n_reads):
        reads_mat[i, : read_lens[i]] = rng.integers(0, 5, size=read_lens[i])
    aux = np.zeros((4, M), dtype=aux_dtype)
    aux[0, :m] = rng.integers(0, n_reads, size=m)
    aux[1, :m] = rng.integers(0, P - 100, size=m)
    aux[1, : m // 8] = P - rng.integers(1, Wmax, size=m // 8)  # past P
    aux[2, :m] = rng.integers(1, Wmax + 1, size=m)
    aux[3, :m] = rng.integers(0, 2, size=m)
    for i in range(0, m, 5):  # plant reads: some rows score high
        L = int(read_lens[aux[0, i]])
        aux[1, i] = int(rng.integers(0, P - Rmax - 100))
        aux[2, i] = min(Wmax, L + 40)
        seg = reads_mat[aux[0, i], :L]
        pool[aux[1, i] + 20 : aux[1, i] + 20 + L] = (
            np.where(seg < 4, 3 - seg, seg)[::-1] if aux[3, i] else seg)
    args = [torch.from_numpy(a).to(dev)
            for a in (pool, reads_mat, read_lens, aux)]
    sw.reset_launches()
    got = sw.gather_score_hash(*args, Wmax)
    torch.cuda.synchronize()
    assert sw.LAUNCHES["gather_score_hash"] == 1
    want = sw.gather_score_hash_plain(*args, Wmax)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g, w)


# 100-bp reads in three chunks, and 1,000-bp reads (a 1,024-row read
# bucket, four bands of rows)
@pytest.mark.parametrize("read_len,n_reads,launches", [(100, 300, 3),
                                                       (1000, 12, 1)])
def test_mapper_on_card_equals_cpu(dev, tmp_path, read_len, n_reads,
                                   launches):
    import _torch_world as world
    from vgan_tpu_torch.graph import synth
    from vgan_tpu_torch.mapper import sw
    from vgan_tpu_torch.mapper.giraffe import BatchedMapper

    graph, _db, _fq, reads = world.build(synth, tmp_path)
    if read_len != 100:
        reads = synth.sample_reads(graph, world.HAP, n_reads,
                                   read_len=read_len, seed=1)
    sw.reset_launches()
    on_card = BatchedMapper(graph, k=31, w=11, device=dev).map_reads_table(
        reads, chunk=128)
    assert sw.LAUNCHES["gather_score_hash"] == launches
    assert (on_card.score[:n_reads] > read_len * 0.9).all()
    on_cpu = BatchedMapper(graph, k=31, w=11, device="cpu").map_reads_table(
        reads, chunk=128)
    for f in ("score", "identity", "mq", "nmap", "m_node", "m_off", "e_from",
              "e_to"):
        np.testing.assert_array_equal(getattr(on_card, f),
                                      getattr(on_cpu, f), err_msg=f)
    assert on_card.eseq == on_cpu.eseq


def _euka_world(tmp_path):
    import _torch_world as world
    from vgan_tpu_torch.graph import synth
    from vgan_tpu_torch.graph.packed import PackedGraph

    graph, ranges = world.build_euka_graph(synth, PackedGraph)
    _d, d5, d3 = world.write_euka_db(
        tmp_path, graph, ranges, 2, [0.03, 0.05, 0.07],
        world.euka_bins(ranges))
    reads = world.write_mixture_fastq(synth, graph, tmp_path / "r.fq",
                                      [(0, 140), (1, 40), (2, 20)], 2)
    return graph, d5, d3, reads


def test_euka_mapper_on_card_equals_cpu(dev, tmp_path, monkeypatch):
    """euka's 64-bp reads (a 64-row read bucket): each gather_score_hash
    call of the card's mapping equal to the plain version on its inputs,
    and the card's table equal to the CPU's field for field."""
    import _torch_world as world
    from vgan_tpu_torch.graph import synth
    from vgan_tpu_torch.graph.packed import PackedGraph
    from vgan_tpu_torch.mapper import sw
    from vgan_tpu_torch.mapper.giraffe import BatchedMapper

    graph, _ranges = world.build_euka_graph(synth, PackedGraph)
    reads = world.write_mixture_fastq(synth, graph, tmp_path / "r.fq",
                                      [(0, 140), (1, 40), (2, 20)], 2,
                                      read_len=64)
    kernel, calls = sw.gather_score_hash, []

    def keeping(*args):
        out = kernel(*args)
        calls.append((args, out))
        return out

    monkeypatch.setattr(sw, "gather_score_hash", keeping)
    on_card = BatchedMapper(graph, k=20, w=10, device=dev).map_reads_table(
        reads, chunk=64)
    monkeypatch.setattr(sw, "gather_score_hash", kernel)
    torch.cuda.synchronize()
    assert len(calls) == 4
    for args, got in calls:
        assert args[1].shape[1] == 64
        for g, w in zip(got, sw.gather_score_hash_plain(*args)):
            assert g.dtype == w.dtype
            assert torch.equal(g, w)
    on_cpu = BatchedMapper(graph, k=20, w=10, device="cpu").map_reads_table(
        reads, chunk=64)
    for f in ("score", "identity", "mq", "nmap", "m_node", "m_off", "e_from",
              "e_to"):
        np.testing.assert_array_equal(getattr(on_card, f),
                                      getattr(on_cpu, f), err_msg=f)
    assert on_card.eseq == on_cpu.eseq


def test_euka_scorer_on_card_equals_cpu(dev, tmp_path):
    """il/nl of the per-base scorer to rtol 1e-12; counts and detected
    taxa equal (the tolerance of chip_smoke.py's euka phase)."""
    from vgan_tpu_torch.mapper import sw
    from vgan_tpu_torch.mapper.giraffe import BatchedMapper
    from vgan_tpu_torch.models.damage import DamageModel
    from vgan_tpu_torch.pipelines import euka as ek

    graph, d5, d3, reads = _euka_world(tmp_path)
    clades = ek.load_clade_info(str(tmp_path / "euka_db.clade"))
    chunks = ek.load_clade_chunks(str(tmp_path / "euka_db.bins"))
    sw.reset_launches()
    table = BatchedMapper(graph, k=20, w=10, device=dev).map_reads_table(
        reads)
    assert sw.LAUNCHES["gather_score_hash"] >= 1
    dm = DamageModel.from_profiles(d5, d3)
    res = {}
    for d in (dev, "cpu"):
        sc = ek.EukaScorer(graph, clades, chunks, damage=dm, device=d)
        res[str(d)] = sc.score_table(table, min_bins=4)
    card, cpu = res[str(dev)], res["cpu"]
    np.testing.assert_array_equal(card.counts, cpu.counts)
    assert card.detected == cpu.detected == [0, 1, 2]
    for a, b in zip(card.clade_like, cpu.clade_like):
        np.testing.assert_allclose(a, b, rtol=1e-12)


def test_euka_score_batch_on_card_equals_cpu(dev):
    from vgan_tpu_torch.models.damage import DamageModel
    from vgan_tpu_torch.pipelines import euka as ek

    rng = np.random.default_rng(4)
    B, L = 4096, 96
    g = rng.integers(0, 8, size=(B, L)).astype(np.int32)
    r = np.where(rng.random((B, L)) < 0.7, g,
                 rng.integers(0, 8, size=(B, L))).astype(np.int32)
    arrays = (g, r, rng.integers(0, 121, size=(B, L)).astype(np.int32),
              rng.integers(-30, 1100, size=(B, L)).astype(np.int32),
              rng.integers(1, 1001, size=B).astype(np.int32),
              rng.random(B) * 0.2,
              np.arange(L)[None, :] < rng.integers(0, L + 1, size=B)[:, None])
    dm = DamageModel.none()
    dm.sub5p[:5, 1, 1] -= 0.3
    dm.sub5p[:5, 1, 3] += 0.3
    out = {}
    for d in (dev, torch.device("cpu")):
        s5, s3 = dm.tables(d)
        out[d.type] = ek.score_batch(
            *(torch.from_numpy(a).to(d) for a in arrays), s5, s3,
            torch.from_numpy(ek.phred.qscore_vec()).to(d),
            torch.from_numpy(ek.BASE_FREQ_LOG).to(d),
            torch.from_numpy(ek.T_T_RATIO).to(d))
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-12)


def test_run_mcmc_on_card_equals_cpu(dev):
    """One draw_noise for both: the recorded trace to rtol 1e-12."""
    from vgan_tpu_torch.infer.abundance_mcmc import run_mcmc

    n = np.array([5600, 2000, 400])
    slog = np.array([5600 * np.log(0.95), 2000 * np.log(0.9),
                     400 * np.log(0.85)])
    init = np.array([0.7, 0.25, 0.05])
    kw = dict(n_iter=3000, burnin=100, seed=5)
    card = run_mcmc(n, slog, init, device=dev, **kw)
    cpu = run_mcmc(n, slog, init, device="cpu", **kw)
    np.testing.assert_allclose(card.samples, cpu.samples, rtol=1e-12)
    np.testing.assert_allclose(card.estimate, cpu.estimate, rtol=1e-12)
