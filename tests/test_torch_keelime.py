"""keelime in the port (vgan_tpu_torch: pipelines/keelime.py,
pipelines/keelime_device.py, cli `keelime`, on the CPU) against the JAX
package's, on a reference-free world: a seeded random backbone with
four haplotypes (graph/synth.py), 64-bp reads of haplotype 1, and the
C>T / G>A damage profiles of tests/_torch_world.py.

* The overlap scans: the port's plain version (overlap_scores_batch)
  and its CPU route (overlap_best_batch: the native scan) against JAX's
  device batch (keelime_device.overlap_scores_batch) and JAX's per-pair
  scorer (keelime.overlap_score), exactly: every score is a multiple of
  0.5, summed exactly by all of them.
* The stages: analyse_gam_table (Frag fields exact, probs to rtol
  1e-12), find_overlaps (equal overlap map and DAG), assemble +
  consensus in the three modes with and without damage profiles (equal
  contigs, consensus and matrices).
* The CLI with damage profiles: the four outputs equal to
  `vgan_tpu.cli keelime`'s (the .gz files decompressed) for single-end
  FASTQ, paired FASTQs and a GAM."""
import gzip

import numpy as np
import pytest
import torch

import _torch_world as world
from vgan_tpu import cli as jax_cli
from vgan_tpu.graph.packed import PackedGraph as JaxGraph
from vgan_tpu.io import fastx as jax_fastx
from vgan_tpu.io import gam as jax_gam
from vgan_tpu.mapper.giraffe import BatchedMapper as JaxMapper
from vgan_tpu.models.damage import DamageModel as JaxDamage
from vgan_tpu.pipelines import keelime as jax_kl
from vgan_tpu.pipelines import keelime_device as jax_kd
from vgan_tpu_torch import cli as port_cli
from vgan_tpu_torch.graph import synth as port_synth
from vgan_tpu_torch.io import fastx as port_fastx
from vgan_tpu_torch.mapper.giraffe import BatchedMapper as PortMapper
from vgan_tpu_torch.models.damage import DamageModel as PortDamage
from vgan_tpu_torch.pipelines import keelime as port_kl
from vgan_tpu_torch.pipelines import keelime_device as port_kd

torch.set_num_threads(1)

N_BP, N_HAPS, N_VARIANTS, HAP, N_READS, READ_LEN = 2000, 4, 12, 1, 400, 64
OUTPUTS = ("Contig.fa.gz", "Consensus.fa.gz", "ProbabilityMatrix.tsv",
           "CountMatrix.tsv")


@pytest.fixture(scope="module")
def kw(tmp_path_factory):
    out = tmp_path_factory.mktemp("keelime")
    graph, _ = port_synth.build_haplotype_graph(
        world.backbone(N_BP, 3), n_haplotypes=N_HAPS, n_variants=N_VARIANTS,
        seed=3)
    db = out / "db"
    db.mkdir()
    graph.save(str(db / "graph.npz"))
    reads = port_synth.sample_reads(graph, HAP, N_READS, read_len=READ_LEN,
                                    seed=0)
    fq = str(out / "r.fq")
    world.write_fastq(fq, reads)
    d5, d3 = world.write_damage_profiles(out)
    p1, p2, il = (str(out / n) for n in ("p1.fq", "p2.fq", "pil.fq"))
    world.write_pairs(graph, p1, p2, il, HAP, 150, frag_len=150, seed=1)
    jgraph = JaxGraph.load(str(db / "graph.npz"))
    jtable = JaxMapper(jgraph, k=20, w=10).map_reads_table(
        jax_fastx.read_fastq(fq))
    gam = str(out / "r.gam")
    jax_gam.write_gam(gam, jtable.to_alignments())
    ptable = PortMapper(graph, k=20, w=10, device="cpu").map_reads_table(
        port_fastx.read_fastq(fq))
    return dict(out=out, db=str(db), graph=graph, jgraph=jgraph, fq=fq,
                d5=d5, d3=d3, p1=p1, p2=p2, gam=gam, jtable=jtable,
                ptable=ptable)


# ------------------------------------------------------------ overlap scans
@pytest.mark.parametrize("case,min_olen,min_score", [
    ("adversarial", 3, 5.0), ("adversarial", 10, 10.0),
    ("traps", 3, 5.0), ("traps", 1, 33.0), ("traps", 8, 20.0),
    ("traps", 3, 21.5),
])
def test_overlap_scans_equal_to_jax(case, min_olen, min_score):
    pairs = (world.overlap_adversarial_pairs() if case == "adversarial"
             else world.overlap_trap_pairs())
    want = [jax_kl.overlap_score(a, b, min_olen, min_score)
            for a, b in pairs]
    assert jax_kd.overlap_scores_batch(pairs, min_olen, min_score,
                                       chunk=32) == want
    assert port_kd.overlap_scores_batch(pairs, min_olen, min_score,
                                        chunk=32) == want
    assert port_kd.overlap_best_batch(pairs, min_olen, min_score,
                                      "cpu") == want
    assert [port_kl.overlap_score(a, b, min_olen, min_score)
            for a, b in pairs] == want
    assert [port_kl._overlap_score_numpy(a, b, min_olen, min_score)
            for a, b in pairs] == want


def test_full_block_near_miss_falls_through_to_tail():
    a, b = world.NEAR_MISS
    assert port_kd.overlap_best_batch([(a, b)], 3, 21.0, "cpu") == [
        (len(b), 21.0)]
    for got in (port_kd.overlap_best_batch([(a, b)], 3, 21.5, "cpu"),
                port_kd.overlap_scores_batch([(a, b)], 3, 21.5),
                [jax_kl.overlap_score(a, b, 3, 21.5)]):
        assert got == [(9, 27.0)]


def test_overlap_scans_at_mitogenome_length():
    """Pairs of 16,569 bp: a full-length match, a shifted suffix/prefix
    overlap, and a pair that scans the whole tail block. JAX's device
    batch would hold [La, N, Lb] at once here, so its per-pair scorer is
    the reference."""
    rng = np.random.default_rng(5)
    seq = "".join(rng.choice(np.array(list("ACGT")), 16569))
    pairs = [(seq, seq), (seq[:16400], seq[120:]), (seq, seq[::-1][:4000])]
    want = [jax_kl.overlap_score(a, b, 40, 60.0) for a, b in pairs]
    assert want[0] == (16569, 3 * 16569.0) and want[1][0] == 16280
    assert port_kd.overlap_best_batch(pairs, 40, 60.0, "cpu") == want
    assert port_kd.overlap_scores_batch(pairs[1:2], 40, 60.0) == want[1:2]


@pytest.mark.parametrize("allowed", [0, 1, 2])
def test_window_first_hit_equals_numpy_oracle(allowed):
    """The native RY-window scan (cpp/matchwin.cpp, isSubset /
    findAlignmentPosition) against its numpy oracle and JAX's, on random
    haystacks with planted near-copies of the needle."""
    rng = np.random.default_rng(allowed)
    alpha = np.array(list(world.KEELIME_ALPHABET))
    for _ in range(40):
        hay = "".join(rng.choice(alpha, int(rng.integers(10, 200))))
        n = int(rng.integers(1, min(40, len(hay)) + 1))
        s0 = int(rng.integers(0, len(hay) - n + 1))
        needle = list(hay[s0 : s0 + n])
        for k in rng.integers(0, n, size=int(rng.integers(0, 3))):
            needle[k] = "T"
        h, nd = port_kl._enc(hay), port_kl._enc("".join(needle))
        for thresh in (int(0.98 * n), n - 2, 0):
            mc = port_kl._match_count_windows(h, nd, allowed)
            hits = np.flatnonzero(mc >= thresh)
            want = int(hits[0]) if len(hits) else -1
            assert port_kl._window_first_hit(h, nd, allowed, thresh) == want
            assert jax_kl._window_first_hit(h, nd, allowed, thresh) == want


def test_code_tables_match_combined():
    """The kernel's 16-code table: every byte maps to its alphabet code
    or to the zero code, and the doubled table reproduces _COMBINED."""
    lut, t2 = port_kd.code_tables()
    comb = port_kl._COMBINED
    assert np.array_equal(t2[lut[:, None], lut[None, :]], 2 * comb)
    assert np.array_equal(comb, jax_kl._COMBINED)


# ------------------------------------------------------------ stages
def _frag_key(f):
    return (f.name, f.seq, f.graph_seq, list(f.node_ids), list(f.offsets),
            list(f.coverage), f.counts.tolist(), f.cut)


@pytest.mark.parametrize("damaged", [False, True])
def test_analyse_gam_table_equal_to_jax(kw, damaged):
    jdm = JaxDamage.from_profiles(kw["d5"], kw["d3"]) if damaged else None
    pdm = PortDamage.from_profiles(kw["d5"], kw["d3"]) if damaged else None
    want = jax_kl.analyse_gam_table(kw["jgraph"], kw["jtable"], damage=jdm)
    got = port_kl.analyse_gam_table(kw["graph"], kw["ptable"], damage=pdm)
    assert len(got) == len(want) > 0.9 * N_READS
    assert [_frag_key(f) for f in got] == [_frag_key(f) for f in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.probs, w.probs, rtol=1e-12, atol=0)


def _prepared(kl, graph, frags):
    depths = kl.node_depths(graph, graph.min_id, graph.max_id)
    frags = kl.sort_frags(frags, depths)
    for f in frags:
        f.ry = kl.to_rymer(f.seq)
    return frags, kl.initial_overlap(frags, depths)[0]


@pytest.mark.parametrize("specified_deam", [False, True])
def test_find_overlaps_equal_to_jax(kw, specified_deam):
    jf, jpairs = _prepared(jax_kl, kw["jgraph"], jax_kl.analyse_gam_table(
        kw["jgraph"], kw["jtable"]))
    pf, ppairs = _prepared(port_kl, kw["graph"], port_kl.analyse_gam_table(
        kw["graph"], kw["ptable"]))
    assert all(np.array_equal(a, b) for a, b in zip(jpairs, ppairs))
    jg, jom = jax_kl.find_overlaps(jf, 10, 15, jpairs, specified_deam, 10)
    pg, pom = port_kl.find_overlaps(pf, 10, 15, ppairs, specified_deam, 10,
                                    device="cpu")
    assert len(pom) > 0 and pom == jom
    assert [dict(d) for d in pg.adj] == [dict(d) for d in jg.adj]
    assert pg.in_degree == jg.in_degree


def _contig_key(c):
    return (c.seq, c.ry, c.counts.tolist(), list(c.node_ids), c.cut,
            c.empty.tolist())


@pytest.mark.parametrize("mode", ["normal", "reckless", "strict"])
@pytest.mark.parametrize("damaged", [False, True])
def test_assemble_consensus_equal_to_jax(kw, mode, damaged):
    jdm = JaxDamage.from_profiles(kw["d5"], kw["d3"]) if damaged else None
    pdm = PortDamage.from_profiles(kw["d5"], kw["d3"]) if damaged else None
    jfr = jax_kl.analyse_gam_table(kw["jgraph"], kw["jtable"], damage=jdm)
    pfr = port_kl.analyse_gam_table(kw["graph"], kw["ptable"], damage=pdm)
    want = jax_kl.assemble(kw["jgraph"], jfr, ref_path=HAP, mode=mode,
                           specified_deam=damaged)
    got = port_kl.assemble(kw["graph"], pfr, ref_path=HAP, mode=mode,
                           specified_deam=damaged, device="cpu")
    assert [_contig_key(c) for c in got] == [_contig_key(c) for c in want]
    for g, w in zip(got, want):
        assert np.array_equal(g.scoring, w.scoring)
    jc = jax_kl.consensus(kw["jgraph"], want, ref_path=HAP)
    pc = port_kl.consensus(kw["graph"], got, ref_path=HAP)
    assert pc[0] == jc[0]
    assert len(pc[0]) >= 0.9 * N_BP
    for g, w in zip(pc[1:], jc[1:]):
        assert np.array_equal(g, w)


# ------------------------------------------------------------ the CLI
def _read(path):
    with open(path, "rb") as f:
        data = f.read()
    return gzip.decompress(data) if path.endswith(".gz") else data


@pytest.mark.parametrize("inp", ["single", "paired", "gam"])
def test_keelime_cli_equal_to_jax(kw, inp):
    args = {"single": ["-fq1", kw["fq"]],
            "paired": ["-fq1", kw["p1"], "-fq2", kw["p2"]],
            "gam": ["-g", kw["gam"]]}[inp]
    common = ["keelime", "--dbdir", kw["db"], "--dbprefix", "graph.npz",
              "-p", f"hap{HAP}", "--deam5p", kw["d5"], "--deam3p", kw["d3"]]
    out = kw["out"]
    want = str(out / f"jax_{inp}_")
    got = str(out / f"port_{inp}_")
    assert jax_cli.main(common + args + ["-o", want]) == 0
    assert port_cli.main(common + args + ["-o", got, "--device", "cpu"]) == 0
    for name in OUTPUTS:
        assert _read(got + name) == _read(want + name), name
    assert _read(got + "Consensus.fa.gz").count(b"N") < 0.5 * N_BP
