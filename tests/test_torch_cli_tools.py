"""The port's host tools and its `map` against `vgan_tpu.cli`, on the CPU:

* `duprm` keeps the same alignments as JAX's on tests/test_cli_tools.py's
  duplicate sets;
* `map --device cpu` writes the same alignments as JAX's `map`,
  single-end and paired;
* `build-hc-db` on a seeded backbone with four planted haplotypes and a
  phylotree (tests/test_db_build.py's world) writes byte-equal sidecars
  and an equal graph.npz, and the port's `haplocart --device cpu` on
  that DB writes JAX's TSV and posterior file byte for byte;
* `vcf2fasta` writes JAX's FASTA and messages on
  tests/test_cli_tools.py's VCFs."""
import os

import numpy as np
import pytest
import torch

import _torch_world as world
from vgan_tpu import cli as jax_cli
from vgan_tpu.io import gam as jax_gam
from vgan_tpu.parallel import mesh as jax_mesh
from vgan_tpu_torch import cli as port_cli
from vgan_tpu_torch.graph import synth as port_synth
from vgan_tpu_torch.io import gam as port_gam

torch.set_num_threads(1)


def _aln(name, node, offset, seq="ACGTACGTAC", paired=False, rev=False):
    """tests/test_cli_tools.py's alignment, in the JAX package's types."""
    from vgan_tpu.io.gam import Alignment, Edit, Mapping, Path, Position

    return Alignment(
        name=name, sequence=seq, quality=bytes([30] * len(seq)),
        path=Path(mappings=[Mapping(
            position=Position(node_id=node, offset=offset, is_reverse=rev),
            edits=[Edit(len(seq), len(seq), "")], rank=1)]),
        mapping_quality=60, identity=1.0, read_paired=paired,
    )


def _records(path, gam):
    """Each alignment of a GAM as its own protobuf bytes."""
    return [gam.encode_alignment(a) for a in gam.read_gam(path)]


DUPRM_SETS = {
    "duplicates": [_aln("a", 5, 0), _aln("b", 5, 0), _aln("c", 5, 3),
                   _aln("d", 7, 0), _aln("e", 7, 0)],
    "reverse": [_aln("x", 3, 1, rev=True)],
    "paired": [_aln("p", 4, 2, paired=True), _aln("q", 4, 2, paired=True),
               _aln("r", 4, 2, rev=True), _aln("s", 9, 0)],
}


@pytest.mark.parametrize("case", sorted(DUPRM_SETS))
def test_duprm_equal_to_jax(tmp_path, case):
    src = str(tmp_path / "in.gam")
    jax_gam.write_gam(src, DUPRM_SETS[case])
    want, got = str(tmp_path / "jax.gam"), str(tmp_path / "port.gam")
    assert jax_cli.main(["duprm", src, want]) == 0
    assert port_cli.main(["duprm", src, got]) == 0
    assert _records(got, port_gam) == _records(want, jax_gam)
    if case == "duplicates":
        assert [a.name for a in port_gam.read_gam(got)] == ["a", "c", "d"]


# ------------------------------------------------------------ map
@pytest.fixture(scope="module")
def map_world(tmp_path_factory):
    out = tmp_path_factory.mktemp("map")
    graph, db_dir, fq, _reads = world.build(port_synth, out, n_bp=2500,
                                            n_haps=8, n_variants=20,
                                            n_reads=150)
    p1, p2, il = (str(out / n) for n in ("p1.fq", "p2.fq", "pil.fq"))
    world.write_pairs(graph, p1, p2, il, world.HAP, 40, seed=3)
    return dict(out=out, db=os.path.join(db_dir, "graph.npz"), fq=fq, p1=p1,
                p2=p2)


@pytest.mark.parametrize("inp", ["single", "paired"])
def test_map_equal_to_jax(map_world, inp):
    w = map_world
    reads = (["-fq1", w["fq"]] if inp == "single"
             else ["-fq1", w["p1"], "-fq2", w["p2"]])
    want = str(w["out"] / f"jax_{inp}.gam")
    got = str(w["out"] / f"port_{inp}.gam")
    assert jax_cli.main(["map", "--db", w["db"]] + reads + ["-o", want]) == 0
    assert port_cli.main(["map", "--db", w["db"]] + reads
                         + ["-o", got, "--device", "cpu"]) == 0
    recs = _records(got, port_gam)
    assert recs == _records(want, jax_gam)
    mapped = [a for a in port_gam.read_gam(got) if a.identity != 0]
    assert len(mapped) > 0.9 * len(recs)


# ------------------------------------------------------------ build-hc-db
@pytest.fixture(scope="module")
def hap_world(tmp_path_factory):
    """tests/test_db_build.py's world over a seeded random 2,400-bp
    backbone: haplotypes A, B (8 substitutions each), A1 and A2 (one more
    each), and the phylotree ROOT -> A -> {A1, A2}, ROOT -> B."""
    d = tmp_path_factory.mktemp("hcworld")
    base = world.backbone(2400, 17)
    rng = np.random.default_rng(11)

    def mutate(s, sites):
        s = list(s)
        for pos in sites:
            s[pos] = {"A": "C", "C": "G", "G": "T", "T": "A"}[s[pos]]
        return "".join(s)

    hap_a = mutate(base, list(rng.choice(2200, size=8, replace=False) + 100))
    hap_b = mutate(base, list(rng.choice(2200, size=8, replace=False) + 100))
    haps = {"A": hap_a, "A1": mutate(hap_a, [50]), "A2": mutate(hap_a, [60]),
            "B": hap_b}
    with open(d / "ref.fa", "w") as f:
        f.write(f">refseq\n{base}\n")
    with open(d / "haps.fa", "w") as f:
        for name, s in haps.items():
            f.write(f">{name}\n{s}\n")
    with open(d / "phylo.tsv", "w") as f:
        f.write("A\tROOT\nB\tROOT\nA1\tA\nA2\tA\n")
    rng = np.random.default_rng(5)
    with open(d / "reads.fq", "w") as f:
        for i in range(60):
            start = int(rng.integers(0, len(haps["A1"]) - 90))
            r = haps["A1"][start : start + 90]
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    return d


SIDECARS = ("graph_paths", "path_supports", "parsed_pangenome_mapping",
            "mappability.tsv", "parents.txt", "children.txt")


@pytest.fixture
def single_device_mesh():
    prev = jax_mesh._DEVICE_LIMIT
    jax_mesh.set_device_limit(1)
    try:
        yield
    finally:
        jax_mesh.set_device_limit(prev)


def test_build_hc_db_equal_to_jax_and_haplocart_on_it(hap_world, tmp_path,
                                                      single_device_mesh):
    d = hap_world
    dbs = {}
    for name, cli in (("jax", jax_cli), ("port", port_cli)):
        dbs[name] = tmp_path / f"{name}_db"
        assert cli.main(["build-hc-db", str(d / "ref.fa"), str(d / "haps.fa"),
                         str(dbs[name]), "--phylo", str(d / "phylo.tsv")]) == 0
    for name in SIDECARS:
        assert (dbs["port"] / name).read_bytes() == \
            (dbs["jax"] / name).read_bytes(), name
    with np.load(dbs["jax"] / "graph.npz", allow_pickle=True) as want, \
            np.load(dbs["port"] / "graph.npz", allow_pickle=True) as got:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            assert np.array_equal(got[key], want[key]), key
    out = {}
    for name, cli, extra in (("jax", jax_cli, []),
                             ("port", port_cli, ["--device", "cpu"])):
        tsv, post = tmp_path / f"{name}.tsv", tmp_path / f"{name}_post.txt"
        assert cli.main(["haplocart", "--db", str(dbs[name]), "-fq1",
                         str(d / "reads.fq"), "-o", str(tsv), "-pf",
                         str(post), "-k", "20", "--minw", "10"] + extra) == 0
        out[name] = (tsv.read_bytes(), post.read_bytes())
    assert out["port"] == out["jax"]
    assert b"\tA1\t" in out["port"][0] and b"ROOT" in out["port"][1]


# ------------------------------------------------------------ vcf2fasta
VCFS = {
    "indels": ("chrM\t2\t.\tC\tG\t.\t.\t.\tGT\t1\n"
               "chrM\t5\t.\tA\tATT\t.\t.\t.\tGT\t1\n"
               "chrM\t9\t.\tAC\tA\t.\t.\t.\tGT\t1\n"),
    "heterozygous": "chrM\t2\t.\tC\tG\t.\t.\t.\tGT\t0/1\n",
    "ref_mismatch": "chrM\t2\t.\tT\tG\t.\t.\t.\tGT\t1\n",
    "other_chromosome": "chr1\t2\t.\tC\tG\t.\t.\t.\tGT\t1\n",
    "hom_ref_diploid": "chrM\t3\t.\tG\tT\t.\t.\t.\tGT\t0/0\n",
}


@pytest.mark.parametrize("case", sorted(VCFS))
def test_vcf2fasta_equal_to_jax(tmp_path, capfd, case):
    fa = tmp_path / "ref.fa"
    fa.write_text(">chrM extra description\nACGTACGTACGT\n>other\nTTTT\n")
    vcf = tmp_path / "v.vcf"
    vcf.write_text("##fileformat=VCFv4.2\n"
                   "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\n"
                   + VCFS[case])
    argv = ["vcf2fasta", str(vcf), str(fa), "chrM"]
    capfd.readouterr()
    rc_want = jax_cli.main(argv)
    want = capfd.readouterr()
    rc_got = port_cli.main(argv)
    got = capfd.readouterr()
    assert (rc_got, got.out, got.err) == (rc_want, want.out, want.err)
    if case == "indels":
        assert rc_got == 0 and got.out.startswith(">S1\n")
