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


def _planted(rng, B, R, W, L):
    win = rng.integers(0, 5, size=(B, W)).astype(np.int32)
    wlen = rng.integers(0, W + 1, size=B).astype(np.int32)
    win[np.arange(W)[None, :] >= wlen[:, None]] = 255
    read = np.full((B, R), 255, dtype=np.int32)
    rlen = rng.integers(0, R + 1, size=B).astype(np.int32)
    for b in range(B):
        s = int(rng.integers(0, max(1, wlen[b] - rlen[b] + 1)))
        seg = win[b, s : s + rlen[b]].copy()
        seg[seg == 255] = 4
        seg[rng.random(len(seg)) < 0.03] = 1
        read[b, : len(seg)] = seg
    return read, win, rlen, wlen


@pytest.mark.parametrize("B,R,W", [(16, 64, 128), (1000, 128, 192),
                                   (64, 300, 400)])
def test_sw_scores_kernel_equals_plain(dev, B, R, W):
    from vgan_tpu_torch.mapper import sw

    args = [torch.from_numpy(a).to(dev)
            for a in _planted(np.random.default_rng(B), B, R, W, 100)]
    sw.reset_launches()
    got = sw.sw_scores(*args)
    torch.cuda.synchronize()
    assert sw.LAUNCHES["sw_scores"] == 1
    assert torch.equal(got, sw.sw_scores_plain(*args))


@pytest.mark.parametrize("aux_dtype", [np.int32, np.int64])
def test_gather_score_hash_kernel_equals_plain(dev, aux_dtype):
    from vgan_tpu_torch.mapper import sw

    rng = np.random.default_rng(3)
    pool = rng.integers(0, 5, size=200_000).astype(np.uint8)
    reads_mat = np.full((512, 128), 255, dtype=np.uint8)
    read_lens = rng.integers(0, 129, size=512).astype(np.int32)
    for i in range(512):
        reads_mat[i, : read_lens[i]] = rng.integers(0, 5, size=read_lens[i])
    M, m = 4096, 3500
    aux = np.zeros((4, M), dtype=aux_dtype)
    aux[0, :m] = rng.integers(0, 512, size=m)
    aux[1, :m] = rng.integers(0, len(pool) - 100, size=m)
    aux[2, :m] = rng.integers(1, 257, size=m)  # some run past the pool end
    aux[3, :m] = rng.integers(0, 2, size=m)
    args = [torch.from_numpy(a).to(dev)
            for a in (pool, reads_mat, read_lens, aux)]
    sw.reset_launches()
    got = sw.gather_score_hash(*args, 256)
    torch.cuda.synchronize()
    assert sw.LAUNCHES["gather_score_hash"] == 1
    want = sw.gather_score_hash_plain(*args, 256)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g, w)


def test_mapper_on_card_equals_cpu(dev, tmp_path):
    import _torch_world as world
    from vgan_tpu_torch.graph import synth
    from vgan_tpu_torch.mapper import sw
    from vgan_tpu_torch.mapper.giraffe import BatchedMapper

    graph, _db, _fq, reads = world.build(synth, tmp_path)
    sw.reset_launches()
    on_card = BatchedMapper(graph, k=31, w=11, device=dev).map_reads_table(
        reads, chunk=128)
    assert sw.LAUNCHES["gather_score_hash"] == 3
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
