"""CUDA kernels of the port (csrc/sw.cu, csrc/tree_mcmc.cu,
csrc/keelime.cu, csrc/abundance_mcmc.cu, csrc/haplocart.cu, csrc/euka.cu)
against their plain torch versions (keelime's also
against the native host scan), and the device paths of the mapper, the
euka scorer, the abundance MCMC, soibean's k-sweep, keelime and `map`
against the same code on the CPU, on the card; and the multi-process and
split paths (two HaploCart ranks on the one card, the split scorer and
chains over [card, card], the HaploCart scorer over dp x tp grids of the
card) against one process on one card; and the bench's sw and
device_step phases on the card (vgan_tpu_torch/bench.py); and the
tracer's spans against the profiler's timeline of the card. Marked
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


EUKA_CASES = ("class_ACGT", "class_N", "class_gap", "class_rare",
              "class_softclip", "mixed", "nan_inf_tables", "negative_codes",
              "no_valid", "odd_L", "out_of_tables", "soft_runs")


def _euka_cases():
    import _torch_world as world
    from vgan_tpu_torch.pipelines import euka as ek

    return world.euka_score_cases(ek.phred.qscore_vec(), ek.BASE_FREQ_LOG,
                                  ek.T_T_RATIO)


def _euka_on(arrays, tables, d):
    return ([torch.from_numpy(a).to(d) for a in arrays],
            [torch.from_numpy(t).to(d) for t in tables])


def _euka_kernel_vs_plain(dev, arrays, tables):
    """score_batch on the card (one launch) against score_batch_plain on
    the card and on the CPU: rtol 1e-12, NaN where NaN. Returns the
    kernel's (il, nl) on the host."""
    from vgan_tpu_torch.pipelines import euka as ek

    rows, consts = _euka_on(arrays, tables, dev)
    ek.reset_launches()
    got = ek.score_batch(*rows, *consts)
    torch.cuda.synchronize()
    assert ek.LAUNCHES["euka_score"] == (1 if arrays[0].shape[0] else 0)
    plain = ek.score_batch_plain(*rows, *consts)
    host = ek.score_batch_plain(*_euka_on(arrays, tables, "cpu")[0],
                                *_euka_on(arrays, tables, "cpu")[1])
    for g, p, h in zip(got, plain, host):
        assert g.dtype == torch.float64 and g.shape == (arrays[0].shape[0],)
        torch.testing.assert_close(g, p, rtol=1e-12, atol=0, equal_nan=True)
        torch.testing.assert_close(g.cpu(), h, rtol=1e-12, atol=0,
                                   equal_nan=True)
    return tuple(x.cpu() for x in got)


@pytest.mark.parametrize("case", EUKA_CASES)
def test_euka_score_kernel_equals_plain(dev, case):
    """euka_score_kernel on every case of _torch_world.euka_score_cases
    (each column class alone, softclip runs across tiles, rows with no
    valid column, L = 77, indices outside their tables, negative codes,
    NaN and inf in the damage tables)."""
    cases = _euka_cases()
    assert sorted(cases) == sorted(EUKA_CASES)
    _euka_kernel_vs_plain(dev, *cases[case])


@pytest.mark.parametrize("B", [0, 1])
def test_euka_score_kernel_tiny_batches(dev, B):
    arrays, tables = _euka_cases()["mixed"]
    il, nl = _euka_kernel_vs_plain(dev, tuple(a[:B] for a in arrays),
                                   tables)
    assert il.shape == nl.shape == (B,)


def test_euka_score_kernel_1024_column_rows(dev):
    """Rows of 1,024 columns (a 1,000-bp read's bucket): 32 tiles a row,
    softclip runs across many of them."""
    import _torch_world as world
    from vgan_tpu_torch.pipelines import euka as ek

    rng = np.random.default_rng(7)
    d = world._euka_rows(rng, 48, 1024)
    d["r"][::3, 100:700] = 6
    d["valid"][1::3, 300:900] = False
    arrays, tables = world._euka_case(d, world.euka_damage_tables(rng) + [
        ek.phred.qscore_vec(), ek.BASE_FREQ_LOG, ek.T_T_RATIO])
    _euka_kernel_vs_plain(dev, arrays, tables)


def test_euka_score_kernel_row_bits_same_in_any_batch(dev):
    """A row's (il, nl) bits do not depend on the batch around it: the
    mixed case's rows alone, shuffled among other rows, and padded with
    invalid columns to a longer L."""
    from vgan_tpu_torch.pipelines import euka as ek

    cases = _euka_cases()
    arrays, tables = cases["mixed"]
    other, _t = cases["soft_runs"]
    base = _euka_kernel_vs_plain(dev, arrays, tables)
    B, L = arrays[0].shape
    Lo = other[0].shape[1]
    # the mixed rows padded to the other case's L with invalid columns,
    # interleaved with its rows in a shuffled order
    padded = []
    for a, o in zip(arrays, other):
        if a.ndim == 2:
            pad = np.zeros((B, Lo - L), a.dtype)
            a = np.concatenate([a, pad], axis=1)
        padded.append(np.concatenate([a, o]))
    perm = np.random.default_rng(3).permutation(len(padded[0]))
    mixed = tuple(np.ascontiguousarray(a[perm]) for a in padded)
    got = _euka_kernel_vs_plain(dev, mixed, tables)
    where = np.argsort(perm)[:B]  # the mixed rows' places after the shuffle
    for g, b in zip(got, base):
        assert torch.equal(g[torch.from_numpy(where)], b)


@pytest.mark.parametrize("opt", ["-O0", "-O1", "-O2", "-O3"])
def test_euka_score_kernel_same_at_every_ptxas_level(dev, monkeypatch, opt):
    """csrc/euka.cu built with ptxas at another optimisation level than
    the library's (-O3): on every case equal to the plain version and to
    the library's build, both to rtol 1e-12 (libdevice's log and exp may
    round their last bit otherwise when ptxas fuses less)."""
    from vgan_tpu_torch import _native

    cases = _euka_cases()
    want = {k: _euka_kernel_vs_plain(dev, *v) for k, v in cases.items()}
    lib = _native.euka_build(f"vgan_euka_ptxas{opt}", ["-Xptxas", opt])
    monkeypatch.setitem(_native._loaded, "euka", lib)
    assert _native.euka_lib() is lib
    for k, v in cases.items():
        got = _euka_kernel_vs_plain(dev, *v)
        for g, w in zip(got, want[k]):
            torch.testing.assert_close(g, w, rtol=1e-12, atol=0,
                                       equal_nan=True)


# csrc/euka.cu's builds for tests and measurement: every CTA reading the
# tables through L1, scalar code loads, both (the results must not change)
EUKA_PATH_FLAGS = (("-DVGAN_EUKA_TABLES_L1",), ("-DVGAN_EUKA_SCALAR_LOADS",),
                   ("-DVGAN_EUKA_TABLES_L1", "-DVGAN_EUKA_SCALAR_LOADS"))
_EUKA_BUILDS = {}


def _euka_build(flags):
    """csrc/euka.cu built with the extra nvcc `flags` (once a process)."""
    from vgan_tpu_torch import _native

    if flags not in _EUKA_BUILDS:
        _EUKA_BUILDS[flags] = _native.euka_build("vgan_euka_path",
                                                 list(flags))
    return _EUKA_BUILDS[flags]


def _score_with(lib, *args):
    """score_batch(*args) launching the kernel of the library `lib`."""
    from vgan_tpu_torch import _native
    from vgan_tpu_torch.pipelines import euka as ek

    saved = _native._loaded.get("euka")
    _native._loaded["euka"] = lib
    try:
        return ek.score_batch(*args)
    finally:
        if saved is None:
            _native._loaded.pop("euka")
        else:
            _native._loaded["euka"] = saved


def _same_bits(got, want, what):
    for g, w in zip(got, want):
        assert torch.equal(g.isnan(), w.isnan()), what
        assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(w)), what


@pytest.mark.parametrize("case", EUKA_CASES)
def test_euka_score_kernel_every_path_same_bits(dev, case):
    """Each case through every path of the kernel (staged or L1 tables,
    16-byte or scalar loads, each forced by a build): the bits of the
    default build, which equals the plain version."""
    arrays, tables = _euka_cases()[case]
    want = _euka_kernel_vs_plain(dev, arrays, tables)
    rows, consts = _euka_on(arrays, tables, dev)
    for flags in EUKA_PATH_FLAGS:
        _same_bits(_score_with(_euka_build(flags), *rows, *consts).cpu(),
                   want, flags)


@pytest.mark.parametrize("reverse", [False, True])
def test_euka_score_kernel_1000bp_batch_staged_rounds(dev, reverse):
    """chip_smoke's synthetic 1,000-bp batch (B = 2,048, L = 1,024), of
    forward reads and with half of them reverse: equal to plain, the same
    bits as the build that reads the tables through L1 in every CTA; the
    phase-clock build counts every CTA staged, in one round for the
    forward reads, and some CTAs in two rounds for both orientations."""
    import ctypes

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    from vgan_tpu_torch import _native
    from vgan_tpu_torch.pipelines import euka as ek
    from vgan_tpu_torch.euka_ab import damage_tables

    args = cs.synthetic_euka_args(damage_tables(dev), cs.EUKA_LONG_B,
                                  cs.EUKA_LONG_L)
    if reverse:
        args = cs.both_orientations(args)
    got = ek.score_batch(*args)
    want = ek.score_batch_plain(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=0, equal_nan=True)
    _same_bits(_score_with(_euka_build(EUKA_PATH_FLAGS[0]), *args), got,
               "tables through L1")
    clocks = _native.euka_clocks_lib()
    out = (ctypes.c_ulonglong * 20)()
    torch.cuda.synchronize()
    assert clocks.euka_phase_clocks(out) == 0
    _same_bits(_score_with(clocks, *args), got, "phase clocks")
    torch.cuda.synchronize()
    assert clocks.euka_phase_clocks(out) == 0
    ctas, staged, two = out[8], out[10], out[19]
    print(f"reverse={reverse}: {ctas} CTAs, {staged} staged, {two} in two "
          f"rounds")
    assert ctas > 0 and staged == ctas
    assert (two > 0) if reverse else (two == 0)


def _euka_long_case(rng, B, L):
    """_torch_world's scorer rows of B x L with softclip runs and invalid
    stretches, and random damage tables."""
    import _torch_world as world
    from vgan_tpu_torch.pipelines import euka as ek

    d = world._euka_rows(rng, B, L)
    if L > 8:
        d["r"][::3, L // 8:L // 2] = 6
        d["valid"][1::3, L // 4:(3 * L) // 4] = False
    return world._euka_case(d, world.euka_damage_tables(rng) + [
        ek.phred.qscore_vec(), ek.BASE_FREQ_LOG, ek.T_T_RATIO])


@pytest.mark.parametrize("L", [64, 1024])
def test_euka_score_kernel_row_same_bits_alone_and_anywhere_in_4096(dev, L):
    """One row alone, and at the start, in the middle and at the end of a
    B = 4,096 batch: the same bits each time (the batch against plain)."""
    rng = np.random.default_rng(L)
    arrays, tables = _euka_long_case(rng, 4096, L)
    one = tuple(a[:1] for a in arrays)
    alone = _euka_kernel_vs_plain(dev, one, tables)
    for pos in (0, 2048, 4095):
        batch = tuple(np.ascontiguousarray(np.concatenate(
            [a[1:pos + 1], a[:1], a[pos + 1:]])) for a in arrays)
        got = _euka_kernel_vs_plain(dev, batch, tables)
        for g, w in zip(got, alone):
            assert torch.equal(g[pos:pos + 1], w), pos


def _unaligned(a, d):
    """a on the card as a contiguous tensor whose data starts one element
    past a 16-byte boundary."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=d)
    out = buf[1:1 + t.numel()].view(a.shape)
    out.copy_(t.to(d))
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


@pytest.mark.parametrize("L", [1, 3, 77, 1023, 1025, 2100])
def test_euka_score_kernel_odd_and_unaligned_rows(dev, L):
    """Odd L and rows whose tensors start off a 16-byte boundary, with and
    without the 16-byte path (forced off by a build, or taken where
    L % 4 == 0 and the tensors are aligned): equal to plain, the same bits
    each way."""
    from vgan_tpu_torch.pipelines import euka as ek

    rng = np.random.default_rng(L + 5)
    arrays, tables = _euka_long_case(rng, 37, L)
    want = _euka_kernel_vs_plain(dev, arrays, tables)
    rows, consts = _euka_on(arrays, tables, dev)
    shifted = [_unaligned(a, dev) if a.ndim == 2 else r
               for a, r in zip(arrays, rows)]
    scalar = _euka_build(EUKA_PATH_FLAGS[1])
    for args, lib in ((rows, scalar), (shifted, None), (shifted, scalar)):
        got = (ek.score_batch(*args, *consts) if lib is None else
               _score_with(lib, *args, *consts)).cpu()
        for g, w in zip(got, want):
            assert torch.equal(g, w), lib


def test_euka_score_kernel_65536_rows(dev):
    """B = 65,536 x L = 64 (many waves of CTAs) against plain."""
    rng = np.random.default_rng(65536)
    arrays, tables = _euka_long_case(rng, 65536, 64)
    il, nl = _euka_kernel_vs_plain(dev, arrays, tables)
    assert il.shape == (65536,) and torch.isfinite(il).all()


def test_euka_score_config_registers_and_occupancy(dev):
    """The launch shape at euka's calls and at the 1,000-bp batch, the
    kernel's registers a thread, its spill bytes and its CTAs an SM
    (printed; pytest -s): at least two CTAs an SM, every row's columns
    covered, the staged rows a multiple of 4."""
    import ctypes

    from vgan_tpu_torch import _native

    lib = _native.euka_lib()
    for B, L in ((4096, 64), (2048, 1024), (65536, 64)):
        out = (ctypes.c_int * 11)()
        assert lib.euka_score_config(B, L, out) == 0
        G, nc, S, P, R, ctas, per_sm, regs, local, smem, cap = list(out)
        print(f"B={B} L={L}: G={G} nc={nc} S={S} P={P} rows a CTA {R}, "
              f"{ctas} CTAs, {per_sm} CTAs an SM, {regs} registers a "
              f"thread, {local} local bytes, {smem} shared bytes a CTA, "
              f"{cap} staged table rows")
        assert G * nc * S > 0 and nc * S >= L and per_sm >= 2
        assert cap > 0 and cap % 4 == 0 and regs <= 80


@pytest.mark.parametrize("opt", ["-O3", "-O0"])
def test_ptxas_select_repro_min_max_form_right(dev, tmp_path, opt):
    """csrc/ptxas_select_repro.cu built with nvcc -O3, ptxas at `opt`, and
    run: the min / max clamp, the form csrc/euka.cu's clamp_index takes,
    comes out right (exit code 0), whatever the nested-ternary form gives
    (its lines are printed)."""
    import subprocess

    from vgan_tpu_torch import _native

    nvcc = _native._find_tool("nvcc", [os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")])
    exe = str(tmp_path / "repro")
    src = os.path.join(os.path.dirname(_native.EUKA_SRC),
                       "ptxas_select_repro.cu")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-Xptxas", opt, "-o", exe, src], check=True, timeout=300)
    r = subprocess.run([exe], capture_output=True, text=True, timeout=60)
    print(r.stdout)
    assert r.returncode == 0, r.stdout
    assert "min/max clamp: right" in r.stdout


def test_euka_score_kernel_stays_inside_its_buffers(dev):
    """Canaries in place of a sanitizer (compute-sanitizer refuses the
    card's machine): every input is a view into a larger buffer whose
    rows before and after hold codes, qualities and lengths that would
    change any sum read from them, and the outputs are views with NaN
    guards on both sides. The kernel's sums equal the plain version on
    the exact rows and every guard keeps its bits."""
    import ctypes

    from vgan_tpu_torch import _native
    from vgan_tpu_torch.pipelines import euka as ek

    arrays, tables = _euka_cases()["soft_runs"]
    B, L = arrays[0].shape
    pad = 3

    def framed(a, fill):
        out = np.full((B + 2 * pad,) + a.shape[1:], fill, a.dtype)
        out[pad:pad + B] = a
        return torch.from_numpy(out).to(dev)

    fills = (4, 4, 99, 500, 7, 0.9, True)  # N codes, q 99, far damage rows
    big = [framed(a, f) for a, f in zip(arrays, fills)]
    rows = [x[pad:pad + B] for x in big]
    consts = [torch.from_numpy(t).to(dev) for t in tables]
    out = torch.full((2, B + 2 * pad), float("nan"), dtype=torch.float64,
                     device=dev)
    before = out.clone()
    lib = _native.euka_lib()
    P = lambda x: ctypes.c_void_p(x.data_ptr())  # noqa: E731
    rc = lib.euka_score_launch(
        *[P(x) for x in rows[:6]], P(rows[6].view(torch.uint8)),
        P(consts[0]), P(consts[1]), consts[0].shape[0], P(consts[2]),
        consts[2].numel(), P(consts[3]), consts[3].numel(), P(consts[4]),
        B, L, P(out[0, pad:]), P(out[1, pad:]),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    torch.cuda.synchronize()
    assert rc == 0
    want = ek.score_batch_plain(*rows, *consts)
    for k in range(2):
        torch.testing.assert_close(out[k, pad:pad + B], want[k], rtol=1e-12,
                                   atol=0)
        for guard in (slice(0, pad), slice(pad + B, None)):
            assert torch.equal(out[k, guard].isnan(), before[k, guard].isnan())


def test_euka_score_kernel_failed_build_raises(dev, monkeypatch, tmp_path):
    """A failed nvcc build of csrc/euka.cu raises from score_batch on
    CUDA tensors: nothing falls back to the plain version."""
    from vgan_tpu_torch import _native
    from vgan_tpu_torch.pipelines import euka as ek

    arrays, tables = _euka_cases()["mixed"]
    rows, consts = _euka_on(arrays, tables, dev)
    monkeypatch.setattr(_native, "_loaded", {})
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_native, "_find_tool", lambda name, fb: "/bin/false")
    ek.reset_launches()
    with pytest.raises(RuntimeError, match="building vgan_euka failed"):
        ek.score_batch(*rows, *consts)
    assert ek.LAUNCHES["euka_score"] == 0


def test_run_mcmc_on_card_equals_cpu(dev):
    """One draw_noise for both: the recorded trace to rtol 1e-12, the
    card's chain one abundance_mcmc_segment_kernel launch."""
    from vgan_tpu_torch.infer import abundance_mcmc as am

    n = np.array([5600, 2000, 400])
    slog = np.array([5600 * np.log(0.95), 2000 * np.log(0.9),
                     400 * np.log(0.85)])
    init = np.array([0.7, 0.25, 0.05])
    kw = dict(n_iter=3000, burnin=100, seed=5)
    am.reset_launches()
    card = am.run_mcmc(n, slog, init, device=dev, **kw)
    assert am.LAUNCHES["abundance_mcmc_segment"] == 1
    cpu = am.run_mcmc(n, slog, init, device="cpu", **kw)
    np.testing.assert_allclose(card.samples, cpu.samples, rtol=1e-12)
    np.testing.assert_allclose(card.estimate, cpu.estimate, rtol=1e-12)


# -------------------------------------------------- abundance chain kernel
def _chain(dev, T, S, seed, n=None, init=None, const=-40.0):
    """A chain's inputs on the card: (current, cur_ll, z, u, alpha,
    n_reads, const_ll), noise from draw_noise."""
    from vgan_tpu_torch.infer import abundance_mcmc as am

    rng = np.random.default_rng(seed)
    if n is None:
        n = rng.integers(0, 400, size=T).astype(np.float64)
    if init is None:
        init = rng.gamma(1.0, size=T)
        init = init / init.sum()
    z, u = am.draw_noise(S, T, seed)
    f = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float64,  # noqa
                                  device=dev)
    return (f(init), f(am.START_LL), z.to(dev), u.to(dev), 0.1, f(n),
            f(const))


def _kernel_vs_plain(args):
    """The kernel once and the plain version on the same inputs on the
    card: proposals, state and likelihood to rtol 1e-12 (exp, log and the
    sums' order differ in the last bit); returns both."""
    from vgan_tpu_torch.infer import abundance_mcmc as am

    am.reset_launches()
    got = am.run_segment(*args)
    torch.cuda.synchronize()
    assert am.LAUNCHES["abundance_mcmc_segment"] == 1
    want = am.run_segment_plain(*args)
    for a, b in ((got[1], want[1]), (got[0][0], want[0][0]),
                 (got[0][1], want[0][1])):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=0,
                                   equal_nan=True)
    return got, want


@pytest.mark.parametrize("S", [1, 9899])
@pytest.mark.parametrize("T", [2, 3, 33, 334])
def test_abundance_kernel_equals_plain(dev, T, S):
    (_carry, props), _want = _kernel_vs_plain(_chain(dev, T, S,
                                                     seed=T + S))
    assert props.shape == (S, T) and bool(torch.isfinite(props).all())
    torch.testing.assert_close(props.sum(1), torch.ones_like(props[:, 0]),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", ["neg_inf_const", "nan_ratio"])
def test_abundance_kernel_edge_chains(dev, case):
    """const_ll = -inf and a taxon with no reads and no share (prop 0
    there, 0 * log(0) = NaN): every proposal rejects, as in the plain
    version (CUDA's fmin(1, NaN) would accept)."""
    from vgan_tpu_torch.infer import abundance_mcmc as am

    if case == "neg_inf_const":
        args = _chain(dev, 3, 2000, 1, n=[40.0, 10.0, 5.0],
                      init=[0.5, 0.3, 0.2], const=-np.inf)
    else:
        args = _chain(dev, 3, 2000, 2, n=[60.0, 0.0, 25.0],
                      init=[0.6, 0.0, 0.4], const=-3.0)
    (state, ll), _props = _kernel_vs_plain(args)[0]
    assert float(ll) == am.START_LL
    assert torch.equal(state, args[0])


def test_abundance_checkpointed_segments_equal_one_segment(dev, tmp_path):
    """Segments of 700 steps (one launch each) give the one-segment run's
    trace bit for bit: the carry is the last accepted proposal itself."""
    from vgan_tpu_torch.infer import abundance_mcmc as am

    n = np.array([300, 100, 50, 0])
    slog = np.array([300 * np.log(0.95), 100 * np.log(0.9),
                     50 * np.log(0.85), 0.0])
    init = np.array([0.4, 0.3, 0.2, 0.1])
    kw = dict(n_iter=5000, burnin=100, seed=9, device=dev)
    am.reset_launches()
    one = am.run_mcmc(n, slog, init, **kw)
    seg = am.run_mcmc_checkpointed(n, slog, init, checkpoint_every=700,
                                   checkpoint_path=str(tmp_path / "ab"),
                                   **kw)
    assert am.LAUNCHES["abundance_mcmc_segment"] == 1 + 7
    np.testing.assert_array_equal(seg.samples, one.samples)


def _window_chain(dev, T, S, kind, seed):
    """A `low`-acceptance chain (thousands of reads a taxon, started at
    the posterior's mode) or a `high` one (a handful of reads a taxon)."""
    rng = np.random.default_rng(seed)
    if kind == "low":
        n = rng.integers(2000, 8000, size=T).astype(np.float64)
        return _chain(dev, T, S, seed, n=n, init=n / n.sum(), const=-5.0 * T)
    n = rng.integers(0, 5, size=T).astype(np.float64)
    return _chain(dev, T, S, seed, n=n, init=np.full(T, 1.0 / T),
                  const=-5.0 * T)


def _accepts(args, props):
    from vgan_tpu_torch.infer import abundance_mcmc as am

    return am.accepted_steps(props, args[3], args[5], args[6], args[1])[0]


@pytest.mark.parametrize("kind", ["low", "high"])
@pytest.mark.parametrize("S", [1, 31, 33, 9899])
@pytest.mark.parametrize("T", [1, 2, 3, 8, 9, 33, 334, 1024])
def test_abundance_window_kernel_equals_plain(dev, T, S, kind):
    """The window kernel at its own choice of window against
    run_segment_plain (rtol 1e-12, _kernel_vs_plain), with the same
    accepted steps, on low- and high-acceptance chains."""
    args = _window_chain(dev, T, S, kind, seed=T + S)
    (_carry, props), (_pcarry, pprops) = _kernel_vs_plain(args)
    assert _accepts(args, props) == _accepts(args, pprops)


@pytest.mark.parametrize("kind", ["low", "high"])
@pytest.mark.parametrize("T", [1, 3, 16, 334])
def test_abundance_window_kernel_every_warps_same_bits(dev, T, kind):
    """Every window the kernel can take (1..8 consumer warps) gives the
    same bits: a step's arithmetic depends only on the state and its own
    noise."""
    from vgan_tpu_torch.infer import abundance_mcmc as am

    args = _window_chain(dev, T, 2000, kind, seed=T)
    (s0, l0), p0 = am.run_segment(*args)
    for w in range(1, 9):
        (s, ll), p = am.run_segment(*args, warps=w)
        assert torch.equal(p, p0) and torch.equal(s, s0)
        assert torch.equal(ll, l0)
    with pytest.raises(ValueError):
        am.run_segment(*args, warps=9)


@pytest.mark.parametrize("warps", [0, 1, 3, 8])
@pytest.mark.parametrize("T", [3, 33])
def test_abundance_segments_ending_mid_window_equal_one_segment(dev, T,
                                                                warps):
    """Segments whose ends fall inside the kernel's windows (cut at
    d / 2 + 1, d + 3, 3 d + 1 ...), the carry passed on as the
    checkpointed runner passes it, give the one-launch run's bits."""
    from vgan_tpu_torch.infer import abundance_mcmc as am

    current, cur_ll, z, u, alpha, n, const = _window_chain(dev, T, 3000,
                                                           "low", seed=4)
    d = am.window(T, warps)
    (ws, wl), whole = am.run_segment(current, cur_ll, z, u, alpha, n, const,
                                     warps=warps)
    cuts = sorted({0, d // 2 + 1, d + 3, 3 * d + 1, 7 * d + 5, 1001, 3000})
    carry, parts = (current, cur_ll), []
    for a, b in zip(cuts[:-1], cuts[1:]):
        carry, part = am.run_segment(*carry, z[a:b], u[a:b], alpha, n, const,
                                     warps=warps)
        parts.append(part)
    assert torch.equal(torch.cat(parts), whole)
    assert torch.equal(carry[0], ws) and torch.equal(carry[1], wl)


# -------------------------------------------- HaploCart likelihood kernel
def _card_packed(dev, M, S, seed):
    """pack_batch's buffer built on the card: random rows with codes >= 4,
    q and mq past 99, pang past the tables and below 0, node ids outside
    [0, n_nodes), and the last eighth padding rows (g = r = 255,
    take = b = 0)."""
    from vgan_tpu_torch.models import mutation

    gen = torch.Generator(device=dev).manual_seed(seed)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev)

    def rf(shape):
        return torch.rand(shape, generator=gen, device=dev,
                          dtype=torch.float64)

    live = M - M // 8
    take = ri(0, S + 1, (M,)).to(torch.int32)
    take[live:] = 0
    v = torch.arange(S, device=dev)[None, :] < take[:, None]
    g = ri(0, 4, (M, S))
    odd = rf((M, S))
    g = torch.where(odd < 0.03, 4, torch.where(odd < 0.05,
                                               ri(5, 255, (M, S)), g))
    r = torch.where(rf((M, S)) < 0.9, g, ri(0, 256, (M, S)))
    q = ri(0, 256, (M, S))
    codes = [torch.where(v, x, fill).to(torch.uint8)
             for x, fill in ((g, 255), (r, 255), (q, 0))]
    mq = ri(0, 256, (M,)).to(torch.uint8)
    use_bep = (rf((M,)) < 0.2).to(torch.uint8)
    pang = ri(1, mutation.PANGENOME_LEN, (M,))
    pang[rf((M,)) < 0.03] = mutation.PANGENOME_LEN + 7
    neg = rf((M,)) < 0.03  # -1 reads the last entry; below -PAN, entry 0
    pang[neg] = -ri(1, 2 * mutation.PANGENOME_LEN, (M,))[neg]
    node = ri(0, HC_NODES, (M,))
    node[rf((M,)) < 0.02] = HC_NODES + 3
    node[rf((M,)) < 0.02] = -1
    b = -rf((M,)) * 300.0
    for x in (mq, use_bep, pang, node, b):
        x[live:] = 0
    head = torch.cat([x.reshape(-1) for x in codes] + [mq, use_bep])
    pad = torch.zeros((-head.numel()) % 8, dtype=torch.uint8, device=dev)
    i32 = torch.cat([pang, node, take]).to(torch.int32).view(torch.uint8)
    return torch.cat([head, pad, i32, b.view(torch.uint8)])


HC_NODES = 2672  # the smoke's HaploCart graph


@pytest.mark.parametrize("form", ["packed", "batch"])
@pytest.mark.parametrize("consensus", [False, True])
@pytest.mark.parametrize("M,S", [(256, 8), (16384, 8), (131072, 8),
                                 (256, 128), (16384, 128), (131072, 128),
                                 (256, 1024), (16384, 1024),
                                 (131072, 1024)])
def test_hc_node_scores_kernel_equals_plain(dev, M, S, consensus, form):
    """One launch against node_scores_plain on the card: sum(b) to rtol
    1e-12; c to 1e-12 of the sum of |A - b| over each node's rows (the
    f64 atomics add a node's rows in another order, and a node whose
    rows differ in sign cancels)."""
    from vgan_tpu_torch.pipelines import haplocart_device as hd

    t = hd.make_tables(np.ones((HC_NODES, 16)), dev)
    views = hd.unpack(_card_packed(dev, M, S, seed=M + S), M, S)
    batch = views if form == "packed" else hd.packed_batch(views, consensus)
    hd.reset_launches()
    c, total_b = hd.node_scores(batch, t, 1e-4, consensus)
    torch.cuda.synchronize()
    assert hd.LAUNCHES["hc_node_scores"] == 1
    pc, pb = hd.node_scores_plain(batch, t, 1e-4, consensus)
    plain = hd.packed_batch(views, consensus)
    d = hd.mapping_scores(plain, t, 1e-4, consensus) - plain.b
    node = plain.node.long()
    keep = (node >= 0) & (node < HC_NODES)
    mag = torch.zeros(HC_NODES, dtype=torch.float64, device=dev)
    mag.index_add_(0, node[keep], d[keep].abs())
    finite = torch.isfinite(pc)
    assert torch.equal(finite, torch.isfinite(c))
    assert torch.equal(c[~finite], pc[~finite])
    assert bool(((c - pc).abs()[finite] <= 1e-12 * mag[finite]).all())
    torch.testing.assert_close(total_b, pb, rtol=1e-12, atol=0)


def _assert_node_scores(views, batch, t, consensus):
    """node_scores on `batch` (the views or their HcBatch) against
    node_scores_plain: c to 1e-12 of each node's sum of |A - b|, sum(b)
    to rtol 1e-12."""
    from vgan_tpu_torch.pipelines import haplocart_device as hd

    hd.reset_launches()
    c, total_b = hd.node_scores(batch, t, 1e-4, consensus)
    torch.cuda.synchronize()
    assert hd.LAUNCHES["hc_node_scores"] == 1
    pc, pb = hd.node_scores_plain(batch, t, 1e-4, consensus)
    plain = hd.packed_batch(views, consensus)
    d = hd.mapping_scores(plain, t, 1e-4, consensus) - plain.b
    node = plain.node.long()
    keep = (node >= 0) & (node < pc.shape[0])
    mag = torch.zeros_like(pc).index_add_(0, node[keep], d[keep].abs())
    finite = torch.isfinite(pc)
    assert torch.equal(finite, torch.isfinite(c))
    assert torch.equal(c[~finite], pc[~finite])
    assert bool(((c - pc).abs()[finite] <= 1e-12 * mag[finite]).all())
    torch.testing.assert_close(total_b, pb, rtol=1e-12, atol=0)
    return c


@pytest.mark.parametrize("S", [8, 5])
@pytest.mark.parametrize("offset", list(range(16)))
def test_hc_node_scores_kernel_every_buffer_offset(dev, offset, S):
    """unpack's code views at every byte offset they can take mod 16:
    the buffer at a 16- or 8-byte boundary and M = 16,384 + 2 k rows
    (unpack's int32 and f64 views need both: an 8-byte boundary and an
    even M), so that with S = 5 the r and q columns (at M S and 2 M S)
    and mq and use_bep start at every even offset; both modes, packed
    views and their HcBatch."""
    from vgan_tpu_torch.pipelines import haplocart_device as hd

    M = 16384 + 2 * (offset // 2)
    t = hd.make_tables(np.ones((HC_NODES, 16)), dev)
    raw = _card_packed(dev, M, S, seed=offset + S)
    base = 8 * (offset % 2)
    buf = torch.empty(raw.numel() + 16, dtype=torch.uint8,
                      device=dev)[base:base + raw.numel()]
    buf.copy_(raw)
    views = hd.unpack(buf, M, S)
    assert views.g.data_ptr() % 16 == base
    assert views.r.data_ptr() % 16 == (base + M * S) % 16
    for consensus in (False, True):
        _assert_node_scores(views, views, t, consensus)
        _assert_node_scores(views, hd.packed_batch(views, consensus), t,
                            consensus)


@pytest.mark.parametrize("order", ["sorted", "shuffled", "single_hot",
                                   "out_of_range"])
def test_hc_node_scores_kernel_node_orders(dev, order):
    """Node ids sorted (runs of one node), shuffled, all one node (every
    row's atomic on one address) and all outside [0, n_nodes) (c stays
    0), at HaploCart's flush shape (M = 65,536, S = 8)."""
    from vgan_tpu_torch.pipelines import haplocart_device as hd

    M, S = 65536, 8
    t = hd.make_tables(np.ones((HC_NODES, 16)), dev)
    buf = _card_packed(dev, M, S, seed=11)
    views = hd.unpack(buf, M, S)
    gen = torch.Generator(device=dev).manual_seed(3)
    if order == "sorted":
        ids = torch.sort(views.node).values
    elif order == "shuffled":
        ids = views.node[torch.randperm(M, generator=gen, device=dev)]
    elif order == "single_hot":
        ids = torch.full((M,), 17, dtype=torch.int32, device=dev)
    else:
        ids = torch.randint(HC_NODES, 2 * HC_NODES, (M,), generator=gen,
                            device=dev).to(torch.int32)
        ids[::2] = -ids[::2]
    views.node.copy_(ids)
    c = _assert_node_scores(views, views, t, False)
    if order == "out_of_range":
        assert not bool(c.any())
    if order == "single_hot":
        assert int((c != 0).sum()) == 1


def test_hc_final_vec_run_to_run(dev):
    """score_packed twice on one buffer (the flush's shape, M = 16,384,
    S = 8): final_vec within rtol 1e-12 and the same argmax, though the
    f64 atomics add in another order each run; and within rtol 1e-12 of
    the plain chain."""
    from vgan_tpu_torch import entry
    from vgan_tpu_torch.pipelines import haplocart_device as hd

    t = hd.make_tables(entry.synth_support(HC_NODES, 5179), dev)
    buf = _card_packed(dev, 16384, 8, seed=3)
    runs = [hd.score_packed(buf, t, 1e-4, 16384, 8) for _ in range(3)]
    plain_c, plain_b = hd.node_scores_plain(hd.unpack(buf, 16384, 8), t,
                                            1e-4, False)
    plain = plain_b + plain_c @ t.support
    for got in runs[1:] + [plain]:
        torch.testing.assert_close(got, runs[0], rtol=1e-12, atol=0)
        assert int(got.argmax()) == int(runs[0].argmax())


# ------------------------------------------------------------- tree MCMC
# a three-child root, a polytomy and leaves at three depths: the walk
# meets leaf and root bounces, parent and sibling moves
TREE_NEWICK = ("((A:0.2,B:0.25,C:0.1)N1:0.3,((D:0.22,E:0.18)N2:0.28,"
               "G:0.4)N3:0.1,F:0.05)R;")
TREE_FREQS = dict(A=0.3, C=0.2, G=0.22, T=0.28, R=0.52, Y=0.48, M=1.0)
# kernel vs plain: node ids exact; f64 exp/log/normcdfinv of CUDA's math
# library and another order of the sums over reads and counts differ in
# the last bits only
TREE_RTOL = 1e-10


def _tree_inputs(tree, R, counts_scale, seed=5):
    rng = np.random.default_rng(seed)
    N = tree.n_nodes
    leaves = np.nonzero(tree.n_children == 0)[0]
    path_map = np.full((R, N), -40.0)
    path_map[: R // 2, leaves[0]] = -20.0
    path_map[R // 2:, leaves[-1]] = -22.0
    path_map += rng.uniform(-0.5, 0.5, size=(R, N))
    counts25 = rng.integers(0, 4, size=(R, N, 25)) * counts_scale
    return path_map, counts25


def _assert_segments_equal(got, want):
    (gc, gr), (wc, wr) = got, want
    for g, w in ((gc[0], wc[0]), (gr[0], wr[0])):
        assert torch.equal(g.cpu(), w.cpu())
    for g, w in list(zip(gc[1:], wc[1:])) + list(zip(gr[1:], wr[1:])):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=TREE_RTOL, atol=0)


# counts held as uint8, int16 and f64 (the kernel's three count types);
# R = 700 and 1,500: not multiples of the 512-thread block
@pytest.mark.parametrize("counts_scale,R,dtype", [
    (1, 700, torch.uint8), (100, 1500, torch.int16),
    (0.5, 700, torch.float64),
])
def test_tree_mcmc_kernel_equals_plain(dev, counts_scale, R, dtype):
    """k = 1..3 rows padded to Kmax = 3 with a mask, 60 burn-in steps of
    20 hops (iteration 0 included) then 140 steps of 8 hops from the
    carry: the kernel against the plain version on the card and on the
    CPU, one noise draw for all."""
    from vgan_tpu_torch.infer import tree_mcmc as tm
    from vgan_tpu_torch.utils.newick import parse_newick

    tree = parse_newick(TREE_NEWICK)
    path_map, counts25 = _tree_inputs(tree, R, counts_scale)
    data = tm.prepare(tree, path_map, counts25, TREE_FREQS, 0.05, dev)
    assert data.counts25_t.dtype == dtype
    cpu = tm.prepare(tree, path_map, counts25, TREE_FREQS, 0.05, "cpu")
    B, K = 6, 3
    rng = np.random.default_rng(1)
    mask = np.zeros((B, K), bool)
    for b in range(B):
        mask[b, : b % 3 + 1] = True
    nodes = np.where(mask, rng.integers(0, tree.n_nodes, size=(B, K)), 0)
    theta = np.where(mask, rng.random((B, K)) + 0.1, 0.0)
    theta /= theta.sum(1, keepdims=True)
    sd = torch.from_numpy(tm.sd_schedule(199, 60, tree.n_nodes))
    # (the kernel, the plain version on the card, the plain version on
    # the CPU): each its own carry
    runs = {"kernel": (tm.run_segment, data),
            "plain": (tm.run_segment_plain, data),
            "cpu": (tm.run_segment, cpu)}
    carry = {name: (torch.from_numpy(nodes.astype(np.int32)),
                    torch.full((B, K), 0.5, dtype=torch.float64),
                    torch.from_numpy(theta),
                    torch.full((B,), -2000.0, dtype=torch.float64))
             for name in runs}
    carry = {name: tuple(x.to(runs[name][1].device) for x in c)
             for name, c in carry.items()}
    tm.reset_launches()
    for i0, i1, hops in ((0, 60, 20), (60, 200, 8)):
        noise = tm.draw_noise(list(range(B)), i0, i1, K, hops, "cpu")
        out = {}
        for name, (fn, dd) in runs.items():
            on = dd.device
            out[name] = fn(
                *carry[name], torch.from_numpy(mask).to(on),
                torch.arange(i0, i1, device=on), sd[i0:i1].to(on),
                tm.Noise(*(x.to(on) for x in noise)), dd.path_map_t,
                dd.counts25_t, dd.tree, dd.con, dd.freq)
            carry[name] = out[name][0]
        torch.cuda.synchronize()
        _assert_segments_equal(out["kernel"], out["plain"])
        _assert_segments_equal(out["kernel"], out["cpu"])
    assert tm.LAUNCHES["tree_mcmc_segment"] == 2
    rec_ll = out["kernel"][1][3].cpu().numpy()
    acc = np.diff(rec_ll, axis=1) != 0
    assert 0 < acc.mean() < 1


def test_tree_mcmc_kernel_large_tree(dev):
    """A complete binary tree of 4,096 leaves (8,191 nodes, the root 0,
    node i's children 2i + 1 and 2i + 2): the tree tables exceed the
    kernel's shared-memory share and are read from device memory."""
    _large_tree_case(dev, None)


def test_tree_mcmc_kernel_large_tree_cluster8(dev):
    """The same tree with clusters of 8 CTAs a row (5 reads a CTA)."""
    _large_tree_case(dev, 8)


def _large_tree_case(dev, cluster):
    from vgan_tpu_torch.infer import tree_mcmc as tm
    from vgan_tpu_torch.utils.newick import Tree

    N = 8191
    idx = np.arange(N)
    inner = idx < N // 2
    children = np.full((N, 2), -1, dtype=np.int32)
    children[inner, 0] = 2 * idx[inner] + 1
    children[inner, 1] = 2 * idx[inner] + 2
    tree = Tree(names=[f"n{i}" for i in idx],
                parent=np.where(idx > 0, (idx - 1) // 2, -1).astype(np.int32),
                dist=np.where(idx > 0, 0.05 + 0.001 * (idx % 50), 0.0),
                children=children,
                n_children=np.where(inner, 2, 0).astype(np.int32), root=0)
    path_map, counts25 = _tree_inputs(tree, 40, 1)
    data = tm.prepare(tree, path_map, counts25, TREE_FREQS, 0.05, dev)
    B, K, S = 4, 2, 80
    nodes = torch.tensor([[0, 5], [100, 8000], [4000, 1], [8190, 3]],
                         dtype=torch.int32, device=dev)
    carry = (nodes, torch.full((B, K), 0.5, dtype=torch.float64, device=dev),
             torch.full((B, K), 0.5, dtype=torch.float64, device=dev),
             torch.full((B,), -900.0, dtype=torch.float64, device=dev))
    sd = torch.full((S,), 3.0, dtype=torch.float64, device=dev)
    noise = tm.draw_noise([1, 2, 3, 4], 0, S, K, 32, dev)
    args = (torch.ones((B, K), dtype=torch.bool, device=dev),
            torch.arange(S, device=dev), sd, noise, data.path_map_t,
            data.counts25_t, data.tree, data.con, data.freq)
    got = tm.run_segment(*(x.clone() for x in carry), *args,
                         cluster=cluster)
    want = tm.run_segment_plain(*carry, *args)
    torch.cuda.synchronize()
    _assert_segments_equal(got, want)


def _tree_rows(tree, B, K, seed=1):
    """B rows of k = 1..K sources (row b has b % K + 1) padded to K:
    mask, starting nodes and proportions as numpy."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((B, K), bool)
    for b in range(B):
        mask[b, : b % K + 1] = True
    nodes = np.where(mask, rng.integers(0, tree.n_nodes, size=(B, K)), 0)
    theta = np.where(mask, rng.random((B, K)) + 0.1, 0.0)
    theta /= theta.sum(1, keepdims=True)
    return mask, nodes.astype(np.int32), theta


# 30 burn-in steps of 20 hops (iteration 0 included), then 50 of 8
TREE_PLAN = ((0, 30, 20), (30, 80, 8))


def _tree_kernel_vs_plain(dev, tree, data, B, K, cluster, plan=TREE_PLAN):
    """The kernel (`cluster` CTAs a row; None: the wrapper's choice) and
    the plain version on the card over the segments of `plan` [(i0, i1,
    hops)], each from its own carry, with one noise draw; each segment's
    outputs held equal. Returns the kernel's outputs of every segment."""
    from vgan_tpu_torch.infer import tree_mcmc as tm

    mask, nodes, theta = _tree_rows(tree, B, K)
    sd = torch.from_numpy(tm.sd_schedule(plan[-1][1] - 1, plan[0][1],
                                         tree.n_nodes)).to(dev)
    start = (torch.from_numpy(nodes).to(dev),
             torch.full((B, K), 0.5, dtype=torch.float64, device=dev),
             torch.from_numpy(theta).to(dev),
             torch.full((B,), -2000.0, dtype=torch.float64, device=dev))
    carry = {"kernel": start, "plain": tuple(x.clone() for x in start)}
    mask_t = torch.from_numpy(mask).to(dev)
    got = []
    for i0, i1, hops in plan:
        noise = tm.draw_noise(list(range(B)), i0, i1, K, hops, "cpu")
        args = (mask_t, torch.arange(i0, i1, device=dev), sd[i0:i1],
                tm.Noise(*(x.to(dev) for x in noise)), data.path_map_t,
                data.counts25_t, data.tree, data.con, data.freq)
        out = {"kernel": tm.run_segment(*carry["kernel"], *args,
                                        cluster=cluster),
               "plain": tm.run_segment_plain(*carry["plain"], *args)}
        torch.cuda.synchronize()
        _assert_segments_equal(out["kernel"], out["plain"])
        carry = {n: o[0] for n, o in out.items()}
        got.append(out["kernel"])
    return got


TREE_COUNTS = {"uint8": (1, torch.uint8), "int16": (100, torch.int16),
               "f64": (0.5, torch.float64)}


# every cluster size the kernel takes, each count type; R = 700 and
# 1,500 split unevenly over the CTAs of a row
@pytest.mark.parametrize("G", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("counts,R", [("uint8", 700), ("int16", 1500),
                                      ("f64", 700)])
def test_tree_mcmc_kernel_cluster_equals_plain(dev, G, counts, R):
    """k = 1..3 rows (B = 6) at a forced cluster size against the plain
    version: node ids exact, floats to TREE_RTOL."""
    from vgan_tpu_torch.infer import tree_mcmc as tm
    from vgan_tpu_torch.utils.newick import parse_newick

    scale, dtype = TREE_COUNTS[counts]
    tree = parse_newick(TREE_NEWICK)
    data = tm.prepare(tree, *_tree_inputs(tree, R, scale), TREE_FREQS, 0.05,
                      dev)
    assert data.counts25_t.dtype == dtype
    tm.reset_launches()
    _tree_kernel_vs_plain(dev, tree, data, 6, 3, G)
    assert tm.LAUNCHES["tree_mcmc_segment"] == len(TREE_PLAN)


# fewer reads than CTAs (some own none), and a count that no size divides
@pytest.mark.parametrize("G,R", [(8, 5), (16, 5), (16, 12), (4, 37),
                                 (8, 37), (16, 37)])
def test_tree_mcmc_kernel_few_reads(dev, G, R):
    from vgan_tpu_torch.infer import tree_mcmc as tm
    from vgan_tpu_torch.utils.newick import parse_newick

    tree = parse_newick(TREE_NEWICK)
    data = tm.prepare(tree, *_tree_inputs(tree, R, 1), TREE_FREQS, 0.05,
                      dev)
    _tree_kernel_vs_plain(dev, tree, data, 6, 3, G)


def test_tree_mcmc_kernel_cluster_choice(dev):
    """The wrapper's own choice: one row (the checkpointed runner's batch)
    gets the largest cluster that fits, 16 CTAs on an H100; 40 rows a
    small one, all resident on distinct SMs; both equal the plain
    version."""
    from vgan_tpu_torch.infer import tree_mcmc as tm
    from vgan_tpu_torch.utils.newick import parse_newick

    tree = parse_newick(TREE_NEWICK)
    data = tm.prepare(tree, *_tree_inputs(tree, 700, 1), TREE_FREQS, 0.05,
                      dev)
    N, Cc = data.tree.children.shape
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    one = tm.card_cluster_size(dev, 1, 3, N, Cc, torch.uint8)
    many = tm.card_cluster_size(dev, 40, 3, N, Cc, torch.uint8)
    if "H100" in torch.cuda.get_device_name(dev):
        assert one == 16
        assert many == 2
    assert many <= 4 and 40 * many <= n_sm
    for B in (1, 40):
        _tree_kernel_vs_plain(dev, tree, data, B, 3, None)


def test_tree_mcmc_kernel_deterministic(dev):
    """Two launches on the same inputs at G = 8 are bit-equal."""
    from vgan_tpu_torch.infer import tree_mcmc as tm
    from vgan_tpu_torch.utils.newick import parse_newick

    tree = parse_newick(TREE_NEWICK)
    data = tm.prepare(tree, *_tree_inputs(tree, 1500, 1), TREE_FREQS, 0.05,
                      dev)
    B, K, S = 12, 3, 200
    mask, nodes, theta = _tree_rows(tree, B, K)
    noise = tm.draw_noise(list(range(B)), 0, S, K, 20, dev)
    args = (torch.from_numpy(mask).to(dev), torch.arange(S, device=dev),
            torch.from_numpy(tm.sd_schedule(S, 100, tree.n_nodes)[:S]).to(
                dev), noise, data.path_map_t, data.counts25_t, data.tree,
            data.con, data.freq)
    start = (torch.from_numpy(nodes).to(dev),
             torch.full((B, K), 0.5, dtype=torch.float64, device=dev),
             torch.from_numpy(theta).to(dev),
             torch.full((B,), -2000.0, dtype=torch.float64, device=dev))
    a = tm.run_segment(*(x.clone() for x in start), *args, cluster=8)
    b = tm.run_segment(*(x.clone() for x in start), *args, cluster=8)
    torch.cuda.synchronize()
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert torch.equal(x, y)


def test_tree_ksweep_on_card_equals_cpu(dev, monkeypatch):
    """The k-sweep runner (k = 1..3, 2 chains, 5 segments across the
    burn-in boundary) on the card against the CPU, both given the noise
    and initial proportions drawn on the CPU."""
    from vgan_tpu_torch.infer import tree_mcmc as tm
    from vgan_tpu_torch.utils.newick import parse_newick

    draw, theta0 = tm.draw_noise, tm.init_theta
    monkeypatch.setattr(tm, "draw_noise", lambda *a: tm.Noise(
        *(x.to(a[-1]) for x in draw(*a[:-1], "cpu"))))
    monkeypatch.setattr(tm, "init_theta",
                        lambda s, k, d: theta0(s, k, "cpu").to(d))
    tree = parse_newick(TREE_NEWICK)
    path_map, counts25 = _tree_inputs(tree, 300, 1)
    srcs = [np.array([[4], [1]]), np.array([[4, 9], [2, 7]]),
            np.array([[4, 9, 0], [3, 3, 5]])]
    kw = dict(con=0.05, max_iter=600, burn=150, num_paths=tree.n_nodes,
              init_logls=[-900.0, -880.0, -870.0],
              seeds_per_k=[[10, 11], [20, 21], [30, 31]])
    monkeypatch.setattr(tm, "SEGMENT_BYTES", 100 * tm._bytes_per_iter(6, 3,
                                                                      20))
    tm.reset_launches()
    card = tm.run_tree_mcmc_ksweep(tree, path_map, counts25, srcs,
                                   TREE_FREQS, device=dev, **kw)
    assert tm.LAUNCHES["tree_mcmc_segment"] == len(tm.segment_plan(
        601, 150, tree.n_nodes, 6, 3)) >= 5
    cpu = tm.run_tree_mcmc_ksweep(tree, path_map, counts25, srcs,
                                  TREE_FREQS, device="cpu", **kw)
    for g, w in zip(card, cpu):
        np.testing.assert_array_equal(g.node, w.node)
        for f in ("pos", "theta", "loglike"):
            np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                       rtol=TREE_RTOL, atol=0)


# ------------------------------------------------------------ keelime
def _overlap_all_equal(dev, pairs, min_olen, min_score):
    """The card's scan (one launch of the warp kernel on the short pairs,
    and of the block kernel on the long ones where a string is longer than
    L_WARP) against the plain version on the card and the native scan on
    the CPU, exactly."""
    from vgan_tpu_torch.pipelines import keelime_device as kd

    kd.reset_launches()
    got = kd.overlap_best_batch(pairs, min_olen, min_score, dev)
    torch.cuda.synchronize()
    longest = max(len(s) for p in pairs for s in p)
    assert kd.LAUNCHES == {"overlap_warp": 1,
                           "overlap_best": int(longest > kd.L_WARP)}
    assert got == kd.overlap_best_batch(pairs, min_olen, min_score, "cpu")
    assert got == kd.overlap_scores_batch(pairs, min_olen, min_score,
                                          device=dev)
    return got


@pytest.mark.parametrize("case,min_olen,min_score", [
    ("traps", 3, 5.0), ("traps", 1, 33.0), ("traps", 8, 20.0),
    ("traps", 3, 21.5), ("adversarial", 3, 5.0), ("random", 10, 10.0),
    ("random", 1, 10.0),
])
def test_overlap_best_kernel_equals_plain_and_native(dev, case, min_olen,
                                                     min_score):
    """The edge cases of tests/_torch_world.py (case rules, -/N/S, bytes
    outside the alphabet, la < min_olen, lb > la, lb == 0, the
    full-length near miss) and 10^4 random pairs of the whole alphabet
    with planted suffix/prefix overlaps."""
    import _torch_world as world

    if case == "traps":
        pairs = world.overlap_trap_pairs()
    elif case == "adversarial":
        pairs = world.overlap_adversarial_pairs()
    else:
        rng = np.random.default_rng(21)
        alpha = np.array(list(world.KEELIME_ALPHABET + "xZ"))
        pairs = []
        for i in range(10_000):
            a = "".join(rng.choice(alpha, int(rng.integers(0, 130))))
            b = "".join(rng.choice(alpha, int(rng.integers(0, 130))))
            if i % 4 == 0:  # a planted overlap: a's suffix is b's prefix
                k = int(rng.integers(0, len(a) + 1))
                b = a[k:] + b
            pairs.append((a, b))
    got = _overlap_all_equal(dev, pairs, min_olen, min_score)
    if case == "traps" and min_score == 21.5:
        assert got[pairs.index(world.NEAR_MISS)] == (9, 27.0)


def test_overlap_best_kernel_mitogenome_length(dev):
    """Pairs of 16,569 bp: a full-length match, a suffix/prefix overlap
    of 16,280 bp, a pair that scans the whole tail block, and one shorter
    pair beside them."""
    rng = np.random.default_rng(5)
    seq = "".join(rng.choice(np.array(list("ACGT")), 16569))
    pairs = [(seq, seq), (seq[:16400], seq[120:]), (seq, seq[::-1][:4000]),
             ("ACGT" * 16, "GT" + "ACGT" * 10)]
    got = _overlap_all_equal(dev, pairs, 40, 60.0)
    assert got[0] == (16569, 3 * 16569.0) and got[1][0] == 16280


def _overlap_pairs(case):
    """(pairs, min_olen, min_score) of the per-kernel card tests."""
    import _torch_world as world
    from vgan_tpu_torch.pipelines import keelime_device as kd

    rng = np.random.default_rng(31)
    acgt = np.array(list("ACGT"))
    L = kd.L_WARP
    if case == "reads64":  # find_overlaps' shape: 64-bp x 64-bp
        reads = ["".join(rng.choice(acgt, 64)) for _ in range(200)]
        pairs = [(reads[i], reads[j])
                 for i, j in rng.integers(0, 200, (20_000, 2))]
        pairs += [(r[k:] + r[:k], r) for r in reads[:50]
                  for k in (0, 1, 13, 40)]
        return pairs, 10, 10.0
    if case == "traps":
        return (world.overlap_trap_pairs()
                + world.overlap_adversarial_pairs(), 3, 5.0)
    if case == "l_warp_edges":
        core = "".join(rng.choice(acgt, L + 200))
        pairs = []
        for la in (L - 1, L, L + 1):
            for lb in (la, la - 31, la - 32, 40, L + 9):
                k = int(rng.integers(0, la))
                pairs.append((core[:la], (core[k:la] + core)[:lb]))
        return pairs, 1, 10.0
    if case == "la_lt_lb":
        return ([("ACGT" * 5, "ACGT" * 40), ("ACG", "ACGTACGT"),
                 ("ACGTAC", "ACGTACGTAC"), ("A" * 300, "A" * 2000),
                 ("A" * (L + 3), "A" * (L + 40))], 5, 1.0)
    if case == "mitogenome":
        seq = "".join(rng.choice(acgt, 16569))
        return ([(seq, seq), (seq[:16400], seq[120:]),
                 (seq, seq[::-1][:4000]), ("ACGT" * 16, "GT" + "ACGT" * 10)],
                40, 60.0)
    if case == "mixed":  # both classes, shuffled
        pairs = []
        for i in range(600):
            la = int(rng.choice([64, 200, L - 1, L, L + 1, 1500, 2300]))
            a = "".join(rng.choice(acgt, la))
            lb = int(rng.integers(1, 2400))
            k = int(rng.integers(0, la))
            b = (a[k:] + "".join(rng.choice(acgt, lb)))[:lb]
            pairs.append((a, b))
        return [pairs[i] for i in rng.permutation(len(pairs))], 1, 10.0
    raise ValueError(case)


@pytest.mark.parametrize("case", ["reads64", "traps", "l_warp_edges",
                                  "la_lt_lb", "mitogenome", "mixed"])
def test_overlap_kernels_each_equal_plain_and_native(dev, case):
    """overlap_warp_kernel and overlap_best_kernel, each alone on its
    class of the split, against their plain versions on the card (pairs
    of the other class left untouched); the whole indexed scan against
    the native scan on the CPU; and two launches of it bit-equal."""
    from vgan_tpu_torch.pipelines import keelime_device as kd

    pairs, min_olen, min_score = _overlap_pairs(case)
    ids = {}
    ai = np.array([ids.setdefault(a, len(ids)) for a, _ in pairs], np.int32)
    bi = np.array([ids.setdefault(b, len(ids)) for _, b in pairs], np.int32)
    host = [torch.from_numpy(x) for x in kd.intern(list(ids)) + (ai, bi)]
    buf, off, ai_d, bi_d = (t.to(dev) for t in host)
    kd.reset_launches()
    la = off[ai_d.long() + 1] - off[ai_d.long()]
    order, n_short = kd.split_by_length(la)
    n = len(pairs)
    for scan, plain in ((kd.warp_scan, kd.plain_warp_scan),
                        (kd.block_scan, kd.plain_block_scan)):
        outs = []
        for fn in (scan, plain):
            out = (torch.full((n,), -7, dtype=torch.int64, device=dev),
                   torch.full((n,), -7.0, dtype=torch.float64, device=dev))
            fn(buf, off, ai_d, bi_d, order, n_short, min_olen, min_score,
               *out)
            outs.append(out)
        torch.cuda.synchronize()
        assert torch.equal(outs[0][0], outs[1][0])
        assert torch.equal(outs[0][1], outs[1][1])
    assert kd.LAUNCHES == {"overlap_warp": 1, "overlap_best": 1}
    got = [kd.overlap_best_indexed(buf, off, ai_d, bi_d, min_olen,
                                   min_score) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(got[0][0], got[1][0])
    assert torch.equal(got[0][1], got[1][1])
    native = kd.overlap_best_indexed(*host, min_olen, min_score)
    assert torch.equal(got[0][0].cpu(), native[0])
    assert torch.equal(got[0][1].cpu(), native[1])
    if case in ("l_warp_edges", "mixed"):
        la_h = la.cpu().numpy()
        assert (la_h <= kd.L_WARP).any() and (la_h > kd.L_WARP).any()


def _as_pairs(out):
    return list(zip(out[0].cpu().tolist(), out[1].cpu().tolist()))


def _long_class(dev, pairs):
    """(host tensors, card tensors, order, n_short) of a pair list's
    table, split by a's length on the card."""
    from vgan_tpu_torch.pipelines import keelime_device as kd

    ids = {}
    ai = np.array([ids.setdefault(a, len(ids)) for a, _ in pairs], np.int32)
    bi = np.array([ids.setdefault(b, len(ids)) for _, b in pairs], np.int32)
    host = [torch.from_numpy(x) for x in kd.intern(list(ids)) + (ai, bi)]
    card = [t.to(dev) for t in host]
    order, n_short = kd.split_by_length(card[1][card[2].long() + 1]
                                        - card[1][card[2].long()])
    return host, card, order, n_short


@pytest.mark.parametrize("G", [1, 2, 4, 8, 16])
def test_overlap_best_kernel_every_cluster_size(dev, G):
    """overlap_best_kernel forced to clusters of G CTAs on
    tests/_torch_world.py's long cases (a of 257 bp, b longer than a, tail
    winners in the second round of starts, qualifiers scored in late and
    early position chunks, a full block that just misses, no winner, la <
    min_olen, bytes outside the alphabet, 16,569-bp pairs), all of them
    in one call and each case alone: equal to plain_block_scan on the card
    and to the native scan on the CPU, bit for bit."""
    import _torch_world as world
    from vgan_tpu_torch.pipelines import keelime_device as kd

    cases = world.long_overlap_cases(*kd.code_tables())
    for name, (pairs, min_olen, min_score) in cases.items():
        host, card, order, n_short = _long_class(dev, pairs)
        n = len(pairs)
        assert int(n_short) == 0
        outs = [(torch.full((n,), -7, dtype=torch.int64, device=dev),
                 torch.full((n,), -7.0, dtype=torch.float64, device=dev))
                for _ in range(2)]
        kd.reset_launches()
        assert kd.block_scan(*card, order, n_short, min_olen, min_score,
                             *outs[0], n, kd.longest_of(host[1].numpy()),
                             cluster=G) == G
        kd.plain_block_scan(*card, order, n_short, min_olen, min_score,
                            *outs[1])
        torch.cuda.synchronize()
        assert kd.LAUNCHES["overlap_best"] == 1
        native = kd.overlap_best_indexed(*host, min_olen, min_score)
        for k in (0, 1):
            assert torch.equal(outs[0][k], outs[1][k]), name
            assert torch.equal(outs[0][k].cpu(), native[k]), name


def test_overlap_best_kernel_chosen_cluster_size(dev):
    """The chooser on this card: every G it picks is a size the card
    holds that many clusters of at once; on an H100 (132 SMs) the merge
    calls' 4 and 12 mitogenome pairs get clusters of 16 and 8, the 80
    long pairs of the largest merge batch plain blocks; the kernel at the
    chosen G equals the native scan on the 16,569-bp case."""
    import _torch_world as world
    from vgan_tpu_torch.pipelines import keelime_device as kd

    index = dev.index
    n_sm = torch.cuda.get_device_properties(index).multi_processor_count
    for n_long, longest in ((4, 16569), (12, 16569), (80, 2316),
                            (20, 5222)):
        G = kd.card_long_cluster_size(dev, n_long, longest)
        assert G in kd.CLUSTER_SIZES
        assert G == 1 or (n_long * G <= n_sm
                          and kd._resident(index, G) >= n_long)
    if n_sm == 132:
        assert kd.card_long_cluster_size(dev, 4, 16569) == 16
        assert kd.card_long_cluster_size(dev, 12, 16569) == 8
        assert kd.card_long_cluster_size(dev, 80, 2316) == 1
    pairs, min_olen, min_score = world.long_overlap_cases(
        *kd.code_tables())["mitogenome"]
    host, card, order, n_short = _long_class(dev, pairs)
    out = (torch.empty(len(pairs), dtype=torch.int64, device=dev),
           torch.empty(len(pairs), dtype=torch.float64, device=dev))
    G = kd.block_scan(*card, order, n_short, min_olen, min_score, *out)
    assert G == kd.card_long_cluster_size(dev, len(pairs), 16569)
    native = kd.overlap_best_indexed(*host, min_olen, min_score)
    assert torch.equal(out[0].cpu(), native[0])
    assert torch.equal(out[1].cpu(), native[1])


def test_overlap_best_kernel_refused_cluster_raises(dev):
    """A cluster of 32 CTAs, past the card's largest: the launch (or the
    residency query before it) raises, nothing is counted, the outputs
    stay untouched, and no smaller cluster runs in its place; the refusal
    leaves no error behind for the next launches of both kernels."""
    import _torch_world as world
    from vgan_tpu_torch.pipelines import keelime_device as kd

    pairs, min_olen, min_score = world.long_overlap_cases(
        *kd.code_tables())["a257"]
    _, card, order, n_short = _long_class(dev, pairs)
    out = (torch.full((len(pairs),), -7, dtype=torch.int64, device=dev),
           torch.full((len(pairs),), -7.0, dtype=torch.float64, device=dev))
    kd.reset_launches()
    with pytest.raises(RuntimeError, match="CUDA error"):
        kd.block_scan(*card, order, n_short, min_olen, min_score, *out,
                      cluster=32)
    torch.cuda.synchronize()
    assert kd.LAUNCHES["overlap_best"] == 0
    assert (out[0] == -7).all() and (out[1] == -7.0).all()
    kd.warp_scan(*card, order, n_short, min_olen, min_score, *out)
    kd.block_scan(*card, order, n_short, min_olen, min_score, *out,
                  cluster=2)
    torch.cuda.synchronize()
    assert kd.LAUNCHES == {"overlap_warp": 1, "overlap_best": 1}
    assert _as_pairs(out) == kd.overlap_best_batch(pairs, min_olen,
                                                   min_score, "cpu")


def _keelime_world(tmp_path):
    import _torch_world as world
    from vgan_tpu_torch.graph import synth

    graph, _ = synth.build_haplotype_graph(
        world.backbone(3000, 3), n_haplotypes=4, n_variants=16, seed=3)
    db = tmp_path / "db"
    db.mkdir()
    graph.save(str(db / "graph.npz"))
    fq = str(tmp_path / "r.fq")
    world.write_fastq(fq, synth.sample_reads(graph, 1, 600, read_len=64,
                                             seed=0))
    d5, d3 = world.write_damage_profiles(tmp_path)
    return str(db), fq, d5, d3


def test_keelime_cli_on_card_equals_cpu(dev, tmp_path, monkeypatch):
    """`keelime --device cuda` writes the four outputs of `--device cpu`
    (the .gz files decompressed), both batched scans through the
    kernels."""
    import gzip

    from vgan_tpu_torch import cli
    from vgan_tpu_torch.mapper import sw
    from vgan_tpu_torch.pipelines import keelime_device as kd

    db, fq, d5, d3 = _keelime_world(tmp_path)
    indexed, longest = kd.overlap_best_indexed, []

    def keeping(seq_buf, seq_off, ai, bi, min_olen, min_score, top,
                *hints):
        if ai.numel():  # an empty call launches nothing
            longest.append(top)
        return indexed(seq_buf, seq_off, ai, bi, min_olen, min_score, top,
                       *hints)

    monkeypatch.setattr(kd, "overlap_best_indexed", keeping)
    outs = {}
    for name in ("cuda", "cpu"):
        longest.clear()
        kd.reset_launches()
        sw.reset_launches()
        prefix = str(tmp_path / f"{name}_")
        assert cli.main(["keelime", "--dbdir", db, "--dbprefix", "graph.npz",
                         "-fq1", fq, "-o", prefix, "-p", "hap1", "--deam5p",
                         d5, "--deam3p", d3, "--device",
                         str(dev) if name == "cuda" else "cpu"]) == 0
        if name == "cuda":
            # find_overlaps and at least one merge pass, each a launch of
            # the warp kernel, and of the block kernel where the call's
            # table holds a sequence longer than L_WARP
            assert kd.LAUNCHES["overlap_warp"] == len(longest) >= 2
            assert kd.LAUNCHES["overlap_best"] == sum(
                x > kd.L_WARP for x in longest)
            assert sw.LAUNCHES["gather_score_hash"] >= 1
        else:
            assert max(kd.LAUNCHES.values()) == 0
        outs[name] = {}
        for f in ("Contig.fa.gz", "Consensus.fa.gz", "ProbabilityMatrix.tsv",
                  "CountMatrix.tsv"):
            with open(prefix + f, "rb") as fh:
                data = fh.read()
            outs[name][f] = gzip.decompress(data) if f.endswith(".gz") \
                else data
    assert outs["cuda"] == outs["cpu"]


def test_map_cli_on_card_equals_cpu(dev, tmp_path):
    from vgan_tpu_torch import cli
    from vgan_tpu_torch.io import gam

    db, fq, _d5, _d3 = _keelime_world(tmp_path)
    recs = {}
    for name in ("cuda", "cpu"):
        out = str(tmp_path / f"{name}.gam")
        assert cli.main(["map", "--db", os.path.join(db, "graph.npz"),
                         "-fq1", fq, "-o", out, "--device",
                         str(dev) if name == "cuda" else "cpu"]) == 0
        recs[name] = [gam.encode_alignment(a) for a in gam.read_gam(out)]
    assert len(recs["cuda"]) == 600 and recs["cuda"] == recs["cpu"]


def test_haplocart_two_ranks_on_one_card(dev, tmp_path):
    """`haplocart --nproc 2` as two processes on the one card (gloo
    carries the accumulator; each rank scores on cuda:0): each rank
    launches the SW kernel, and host 0's final_vec equals the sum over
    the two halves of the single-process scorer on the card, each half
    mapped, sorted and deduplicated alone (rtol 1e-10)."""
    import json

    import _torch_world as world
    from test_torch_parallel_procs import run_ranks
    from vgan_tpu_torch import _native
    from vgan_tpu_torch.graph import synth
    from vgan_tpu_torch.parallel.multihost import shard_bounds
    from vgan_tpu_torch.pipelines import haplocart as hc
    from vgan_tpu_torch.pipelines import haplocart_device as hd
    from vgan_tpu_torch.pipelines import haplocart_runner as runner

    _native.host_lib()
    _native.sw_lib()  # built once here, so the ranks only load them
    _native.haplocart_lib()
    _g, db_dir, fq, reads = world.build(synth, tmp_path, n_bp=3000,
                                        n_haps=16, n_variants=40,
                                        n_reads=600)
    vec_path = str(tmp_path / "vec.npy")
    logs = run_ranks([vec_path, "haplocart", "--db", db_dir, "-fq1", fq,
                      "-o", "multi.tsv", "--device", "cuda"], tmp_path,
                     script=os.path.join(os.path.dirname(
                         os.path.abspath(__file__)), "_torch_rank.py"))
    ranks = [json.loads(line[5:]) for log in logs
             for line in log.splitlines() if line.startswith("RANK ")]
    assert sorted(r["rank"] for r in ranks) == [0, 1]
    assert all(r["launches"]["gather_score_hash"] >= 1 for r in ranks)
    assert all(r["launches"]["hc_node_scores"] == 1 for r in ranks)
    db = runner.load_db(db_dir, dev)
    mapper = runner.Mapper(db.graph, k=31, w=11, device=dev)
    want = 0.0
    for pid in range(2):
        lo, hi = shard_bounds(len(reads), pid, 2)
        alns = [a for a in mapper.map_reads(reads[lo:hi]) if a.identity != 0]
        alns = hc.remove_duplicates(runner.gamsort(alns))
        want = want + hd.score_alignments_device(db, alns)
    got = np.load(vec_path)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    pred = (tmp_path / "multi.tsv").read_text().splitlines()[1].split("\t")[1]
    assert pred == hc.predict(db, want) == "hap5"


def test_split_scorers_on_repeated_card_equal_one_card(dev, tmp_path):
    """The mesh's HaploCart scorer (rows split, parts summed on the first
    device) and soibean's chain split over [card, card] against one card:
    final_vec to rtol 1e-12, chain node ids exactly and floats to rtol
    1e-10 (each half runs at its own cluster size)."""
    from vgan_tpu_torch import entry
    from vgan_tpu_torch.infer import tree_mcmc as tm
    from vgan_tpu_torch.parallel import mesh
    from vgan_tpu_torch.pipelines import haplocart_device as hd
    from vgan_tpu_torch.pipelines.soibean import make_freqs
    from vgan_tpu_torch.utils.newick import parse_newick

    tables = hd.make_tables(entry.synth_support(2000, 1000), dev)
    batch = entry.synth_batch(3001, dev, n_nodes=2000)
    hd.reset_launches()
    got = mesh.score_batch_split(batch, [[tables], [tables]])
    assert hd.LAUNCHES["hc_node_scores"] == 2  # one a part
    one = hd.score_batch(batch, tables)
    torch.testing.assert_close(got, one, rtol=1e-12, atol=0)
    # dp x tp grids on the card repeated: one launch a device of the
    # grid, the 1,000 paths split over tp columns (999 paths: padded,
    # then cut)
    for grid, n_paths in (([[dev, dev]], 1000), ([[dev, dev], [dev, dev]],
                                                 1000),
                          ([[dev, dev], [dev, dev]], 999)):
        t = hd.make_tables(entry.synth_support(2000, n_paths), dev)
        hd.reset_launches()
        tp = mesh.score_batch_split(batch, mesh.shard_tables(t, grid))
        assert hd.LAUNCHES["hc_node_scores"] == sum(map(len, grid))
        assert tp.shape == (2 * -(-n_paths // 2),)
        want = one if n_paths == 1000 else hd.score_batch(batch, t)
        torch.testing.assert_close(tp[:n_paths], want, rtol=1e-12, atol=0)
        assert int(tp[:n_paths].argmax()) == int(want.argmax())
    tree = parse_newick("((a:0.1,b:0.2)n1:0.3,(c:0.15,d:0.25)n2:0.2)root;")
    R, P = 300, tree.n_nodes
    rng = np.random.default_rng(2)
    path_map = -np.abs(rng.normal(size=(R, P))) * 5
    counts25 = rng.integers(0, 3, size=(R, P, 25)).astype(np.float64)
    srcs = [rng.integers(0, P, size=(4, k)).astype(np.int32) for k in (1, 2)]
    kw = dict(freqs=make_freqs(0.3, 0.2, 0.2, 0.3), con=0.01, max_iter=500,
              burn=100, num_paths=P, init_logls=[-900.0, -950.0],
              seeds_per_k=[np.arange(4), np.arange(4, 8)], device=dev)
    tm.reset_launches()
    split = tm.run_tree_mcmc_ksweep(tree, path_map, counts25, srcs,
                                    devices=[dev, dev], **kw)
    assert tm.LAUNCHES["tree_mcmc_segment"] >= 4  # two segments a half
    one = tm.run_tree_mcmc_ksweep(tree, path_map, counts25, srcs, **kw)
    for a, b in zip(split, one):
        np.testing.assert_array_equal(a.node, b.node)
        for f in ("pos", "theta", "loglike"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       rtol=1e-10)


@pytest.mark.parametrize("phase,flags", [("sw", ()),
                                         ("device_step",
                                          ("device_argmax_agrees",))])
def test_bench_phase_on_the_card(dev, phase, flags, monkeypatch, capsys):
    """`bench --phase sw|device_step --device cuda` at bench.py's smoke
    sizes: exit 0, the line names the card, its agreement flag true and
    every metric finite and above 0."""
    import json

    from vgan_tpu_torch import bench

    monkeypatch.setenv("BENCH_SMOKE", "1")
    assert bench.main(["--phase", phase, "--device", str(dev)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["card"].startswith(torch.cuda.get_device_name(dev))
    for k in flags:
        assert out[k] is True
    for k, v in out.items():
        if k not in flags + ("card", "worlds", "host_cpus"):
            vals = v if isinstance(v, list) else [v]
            assert all(np.isfinite(x) and x > 0 for x in vals), (k, v)


def test_bench_sw_scores_equal_plain_at_its_shape(dev):
    """The sw phase at bench.py's full shape (B=4,096, R=128, W=256):
    every launch is sw_scores_kernel's, and its last scores equal
    sw_scores_plain exactly."""
    from vgan_tpu_torch import bench
    from vgan_tpu_torch.mapper import sw

    sizes = bench.Sizes.of(False)
    b = bench.Bench(dev, sizes)
    sw.reset_launches()
    fields = bench.phase_sw(b)
    assert sw.LAUNCHES["sw_scores"] == 1 + 3 * sizes.sw_reps
    args, out = b.sw_call
    assert [tuple(a.shape) for a in args[:2]] == [(4096, 128), (4096, 256)]
    assert torch.equal(out, sw.sw_scores_plain(*args))
    assert 0 < fields["sw_bound_share"] < 1


def test_profiler_spans_hold_their_kernels_on_the_card(dev):
    """Under the benchmark's profile(activities=[CUDA]) a PROFILER that
    is not enabled records (the session's flag is set), and a kernel
    launched and synchronized inside a span lies inside the span on the
    profiler's timeline (both on time.time_ns's epoch clock)."""
    from torch.autograd import profiler as autograd_profiler
    from torch.profiler import ProfilerActivity, profile

    from vgan_tpu_torch.utils import profiling

    prof = profiling.Profiler(enabled=False)
    x = torch.randn(2048, 2048, device=dev)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        flags = (autograd_profiler._is_profiler_enabled,
                 torch._C._autograd._profiler_enabled())
        with prof.span("card.matmul"):
            x @ x
            torch.cuda.synchronize(dev)
    print(f"profiler flags under profile([CUDA]): {flags}")
    assert flags == (True, True)
    (s,) = prof.records()
    kernels = [e for e in p.profiler.kineto_results.events()
               if str(e.device_type()).endswith("CUDA")]
    assert kernels
    for e in kernels:
        assert s.start_ns <= e.start_ns(), (s, e.name())
        assert e.start_ns() + e.duration_ns() <= s.end_ns, (s, e.name())
