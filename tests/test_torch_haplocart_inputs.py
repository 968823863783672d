"""HaploCart's other inputs in the port against the JAX package, on the
CPU: mate pairs (two FASTQs and interleaved), a GAM and consensus FASTA
records give byte-equal TSVs; `map_read_pairs` gives the same
alignments, and the SAFARI (RYmer) index the same alignment table."""
import os

import pytest
import torch

import _torch_world as world
from test_torch_mapper import assert_tables_equal
from vgan_tpu import cli as jax_cli
from vgan_tpu.graph import synth as jax_synth
from vgan_tpu.io import fastx as jax_fastx
from vgan_tpu.io import gam as jax_gam
from vgan_tpu.mapper.giraffe import BatchedMapper as JaxMapper
from vgan_tpu.parallel import mesh as jax_mesh
from vgan_tpu_torch import cli as port_cli
from vgan_tpu_torch.graph.packed import PackedGraph as PortGraph
from vgan_tpu_torch.io import fastx as port_fastx
from vgan_tpu_torch.mapper.giraffe import BatchedMapper as PortMapper

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def hc(tmp_path_factory):
    out = tmp_path_factory.mktemp("hc_inputs")
    # 6 kbp, so the consensus FASTA's 1/100 windows (`src/fa2fq.cpp`)
    # are 60 bp and carry k=31 seeds
    graph, db_dir, fq, _reads = world.build(jax_synth, out, n_bp=6000)
    p1, p2, il = (str(out / n) for n in ("p1.fq", "p2.fq", "pil.fq"))
    world.write_pairs(graph, p1, p2, il, world.HAP, 60, frag_len=250,
                      read_len=100, seed=2)
    jm = JaxMapper(graph, k=31, w=11)
    gam = str(out / "reads.gam")
    jax_gam.write_gam(gam, jm.map_reads(jax_fastx.read_fastq(fq)[:150]))
    fa = str(out / "cons.fa")
    with open(fa, "w") as f:
        for h in (world.HAP, 9):
            f.write(f">cons_hap{h}\n{graph.path_seq(h)}\n")
    pm = PortMapper(PortGraph.load(os.path.join(db_dir, "graph.npz")),
                    k=31, w=11, device="cpu")
    return dict(out=out, db=db_dir, fq=fq, p1=p1, p2=p2, il=il, gam=gam,
                fa=fa, graph=graph, jm=jm, pm=pm)


@pytest.fixture
def single_device_mesh():
    prev = jax_mesh._DEVICE_LIMIT
    jax_mesh.set_device_limit(1)
    try:
        yield
    finally:
        jax_mesh.set_device_limit(prev)


INPUTS = {
    "fq1_fq2": lambda hc: ["-fq1", hc["p1"], "-fq2", hc["p2"]],
    "interleaved": lambda hc: ["-fq1", hc["il"], "-i"],
    "gam": lambda hc: ["-g", hc["gam"]],
    "fasta": lambda hc: ["-f", hc["fa"]],
}


@pytest.mark.parametrize("inp", sorted(INPUTS))
def test_haplocart_tsv_byte_equal(hc, single_device_mesh, inp):
    jtsv = str(hc["out"] / f"jax_{inp}.tsv")
    ptsv = str(hc["out"] / f"port_{inp}.tsv")
    args = ["haplocart", "--db", hc["db"]] + INPUTS[inp](hc)
    assert jax_cli.main(args + ["-o", jtsv]) == 0
    assert port_cli.main(args + ["-o", ptsv, "--device", "cpu"]) == 0
    with open(jtsv, "rb") as f:
        want = f.read()
    with open(ptsv, "rb") as f:
        got = f.read()
    assert got == want
    assert f"\thap{world.HAP}\t".encode() in got
    if inp == "fasta":
        assert got.count(b"\ncons_hap") == 2


def _aln_key(a):
    return (
        a.name, a.score, a.mapping_quality, a.identity, a.read_paired,
        a.fragment_next.name if getattr(a, "fragment_next", None) else None,
        [(m.position.node_id, m.position.offset, m.position.is_reverse,
          m.rank, [(e.from_length, e.to_length, e.sequence) for e in m.edits])
         for m in a.path.mappings],
    )


def test_map_read_pairs_equal_to_jax(hc):
    j1 = jax_fastx.read_fastq(hc["p1"])
    j2 = jax_fastx.read_fastq(hc["p2"])
    want = hc["jm"].map_read_pairs(j1, j2)
    got = hc["pm"].map_read_pairs(port_fastx.read_fastq(hc["p1"]),
                                  port_fastx.read_fastq(hc["p2"]))
    assert len(got) == len(want) == 2 * len(j1)
    assert sum(a.identity != 0 for a in got) > 0.9 * len(got)
    assert [_aln_key(a) for a in got] == [_aln_key(a) for a in want]


def test_safari_table_equal_to_jax(hc):
    reads = jax_fastx.read_fastq(hc["fq"])[:200]
    want = JaxMapper(hc["graph"], k=31, w=11, safari=True).map_reads_table(
        reads, chunk=128)
    got = PortMapper(hc["pm"].graph, k=31, w=11, safari=True,
                     device="cpu").map_reads_table(
        port_fastx.read_fastq(hc["fq"])[:200], chunk=128)
    assert (got.identity != 0).mean() > 0.9
    assert_tables_equal(got, want)


def test_haplocart_gfa_db_byte_equal(hc, single_device_mesh, tmp_path):
    """A DB directory holding graph.gfa and no graph.npz: both packages
    read the GFA, and `haplocart --device cpu` writes JAX's TSV byte for
    byte."""
    db = tmp_path / "gfa_db"
    db.mkdir()
    world.write_gfa(hc["graph"], str(db / "graph.gfa"))
    args = ["haplocart", "--db", str(db), "-fq1", hc["fq"]]
    jtsv, ptsv = str(tmp_path / "jax.tsv"), str(tmp_path / "port.tsv")
    assert jax_cli.main(args + ["-o", jtsv]) == 0
    assert port_cli.main(args + ["-o", ptsv, "--device", "cpu"]) == 0
    with open(jtsv, "rb") as f:
        want = f.read()
    with open(ptsv, "rb") as f:
        got = f.read()
    assert got == want
    assert f"\thap{world.HAP}\t".encode() in got


def test_load_db_routes_gbz(hc, tmp_path, monkeypatch):
    """A DB directory holding only graph.giraffe.gbz (the reference's
    hcfiles layout) goes through io.gbz.load_packed_graph; one holding
    nothing raises JAX's error."""
    from vgan_tpu_torch.io import gbz
    from vgan_tpu_torch.pipelines import haplocart_runner as runner

    graph = PortGraph.load(os.path.join(hc["db"], "graph.npz"))
    seen = []
    monkeypatch.setattr(gbz, "load_packed_graph",
                        lambda p: seen.append(p) or graph)
    db = tmp_path / "gbz_db"
    db.mkdir()
    (db / "graph.giraffe.gbz").write_bytes(b"")
    loaded = runner.load_db(str(db), torch.device("cpu"))
    assert seen == [str(db / "graph.giraffe.gbz")]
    assert loaded.graph is graph
    assert loaded.path_names == list(graph.path_names)
    with pytest.raises(FileNotFoundError,
                       match="no graph.npz/graph.gfa/.gbz in"):
        runner.load_db(str(tmp_path), torch.device("cpu"))
