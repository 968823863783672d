"""`vgan_tpu_torch.cli euka` / `gam2prof` against `vgan_tpu.cli`, on a
3-taxon DB on disk (<prefix>.npz or .gfa + .clade + .bins, damage
profiles): every output file must be byte-equal.

Inputs: single-end FASTQ (streamed columnar path), mate pairs as two
FASTQs and interleaved (map_read_pairs), and a GAM written from the JAX
mapper's alignments. The MCMC comparison feeds the port the JAX
package's noise (tests/test_torch_euka.py:jax_noise)."""
import os

import numpy as np
import pytest
import torch

import _torch_world as world
from test_torch_euka import jax_noise
from vgan_tpu import cli as jax_cli
from vgan_tpu.graph.packed import PackedGraph as JaxGraph
from vgan_tpu.io import fastx as jax_fastx
from vgan_tpu.io import gam as jax_gam
from vgan_tpu.mapper.giraffe import BatchedMapper as JaxMapper
from vgan_tpu.parallel import mesh as jax_mesh
from vgan_tpu_torch import cli as port_cli
from vgan_tpu_torch.graph import synth as port_synth
from vgan_tpu_torch.graph.packed import PackedGraph as PortGraph
from vgan_tpu_torch.infer import abundance_mcmc as port_am

torch.set_num_threads(1)

N_HAPS = 2
MIX = [(0, 140), (1, 40), (2, 20)]
GATES = ["--minBins", "4"]


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    out = tmp_path_factory.mktemp("euka_cli")
    graph, ranges = world.build_euka_graph(port_synth, PortGraph)
    chunks = world.euka_bins(ranges, whole_bin=True)
    dists = [0.03 + 0.02 * t for t in range(3)]
    euka_dir, d5, d3 = world.write_euka_db(out / "db", graph, ranges, N_HAPS,
                                           dists, chunks)
    fq = str(out / "mix.fq")
    world.write_mixture_fastq(port_synth, graph, fq, MIX, N_HAPS)
    p1, p2, il = (str(out / n) for n in ("p1.fq", "p2.fq", "pil.fq"))
    world.write_pairs(graph, p1, p2, il, [0, 2, 4], 30, seed=1)
    # a GAM of the JAX mapper's alignments of the mixture reads
    jgraph = JaxGraph.load(os.path.join(euka_dir, "euka_db.npz"))
    alns = JaxMapper(jgraph, k=20, w=10).map_reads(jax_fastx.read_fastq(fq))
    gam = str(out / "mix.gam")
    jax_gam.write_gam(gam, alns)
    # the same DB with the graph as GFA
    gfa_dir = out / "gfadb"
    gfa_dir.mkdir()
    world.write_gfa(graph, gfa_dir / "euka_db.gfa")
    for ext in (".clade", ".bins"):
        with open(os.path.join(euka_dir, "euka_db" + ext)) as f:
            (gfa_dir / ("euka_db" + ext)).write_text(f.read())
    return dict(out=out, euka_dir=euka_dir, gfa_dir=str(gfa_dir), d5=d5,
                d3=d3, fq=fq, p1=p1, p2=p2, il=il, gam=gam)


@pytest.fixture
def single_device_mesh():
    prev = jax_mesh._DEVICE_LIMIT
    jax_mesh.set_device_limit(1)
    try:
        yield
    finally:
        jax_mesh.set_device_limit(prev)


def _outputs(prefix):
    d, base = os.path.split(prefix)
    files = {}
    for name in sorted(os.listdir(d)):
        if name.startswith(base + "_"):
            with open(os.path.join(d, name), "rb") as f:
                files[name[len(base):]] = f.read()
    return files


def _run_both(db, tag, args):
    jout = str(db["out"] / f"jax_{tag}")
    pout = str(db["out"] / f"port_{tag}")
    assert jax_cli.main(args + ["-o", jout]) == 0
    assert port_cli.main(args + ["-o", pout, "--device", "cpu"]) == 0
    return _outputs(pout), _outputs(jout)


INPUTS = {
    "fq1": lambda db: ["-fq1", db["fq"]],
    "fq1_fq2": lambda db: ["-fq1", db["p1"], "-fq2", db["p2"]],
    "interleaved": lambda db: ["-fq1", db["il"], "-i"],
    "gam": lambda db: ["-g", db["gam"]],
}


@pytest.mark.parametrize("inp", sorted(INPUTS))
def test_euka_cli_byte_equal_no_mcmc(db, single_device_mesh, inp):
    args = (["euka", "--euka_dir", db["euka_dir"], "--deam5p", db["d5"],
             "--deam3p", db["d3"], "--no-mcmc", "--outFrag"] + GATES
            + INPUTS[inp](db))
    got, want = _run_both(db, inp, args)
    assert sorted(got) == sorted(want)
    for suffix in ("_abundance.tsv", "_detected.tsv", "_coverage.tsv",
                   "_inSize.tsv", "_5p.prof", "_3p.prof"):
        assert suffix in got, suffix
    assert any(s.startswith("_Taxon") for s in got)
    for name in want:
        assert got[name] == want[name], name
    assert got["_detected.tsv"].count(b"\tyes\t") >= 3


def test_euka_cli_gfa_db_byte_equal(db, single_device_mesh):
    """The DB's graph given as <prefix>.gfa (PackedGraph.from_gfa)."""
    args = ["euka", "--euka_dir", db["gfa_dir"], "--no-mcmc", "-fq1",
            db["fq"]] + GATES
    got, want = _run_both(db, "gfa", args)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


def test_euka_cli_mcmc_byte_equal(db, single_device_mesh, monkeypatch):
    monkeypatch.setattr(port_am, "draw_noise", jax_noise)
    args = ["euka", "--euka_dir", db["euka_dir"], "-fq1", db["fq"],
            "--iter", "300", "--burnin", "10"] + GATES
    got, want = _run_both(db, "mcmc", args)
    for name in ("_abundance.tsv", "_detected.tsv"):
        assert got[name] == want[name], name
    header = got["_abundance.tsv"].splitlines()[0]
    assert b"95%_confidence_interval_higher_bound" in header


def test_gam2prof_byte_equal(db):
    args = ["gam2prof", "--euka_dir", db["euka_dir"], "-g", db["gam"]]
    jout = str(db["out"] / "jax_g2p")
    pout = str(db["out"] / "port_g2p")
    assert jax_cli.main(args + ["-o", jout]) == 0
    assert port_cli.main(args + ["-o", pout]) == 0
    got, want = _outputs(pout), _outputs(jout)
    assert sorted(got) == sorted(want)
    assert {"_Taxon0.prof", "_Taxon0.all"} <= set(got)
    for name in want:
        assert got[name] == want[name], name


def test_euka_cuda_without_card_raises(db, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(db["out"] / "nocard")
    with pytest.raises(RuntimeError, match="cuda"):
        # the default device is cuda: never a silent CPU run
        port_cli.main(["euka", "--euka_dir", db["euka_dir"], "-fq1",
                       db["fq"], "-o", out])
    assert not _outputs(out)


@pytest.mark.parametrize("ext", [".vg", ".og", ".gbz", ".gg", ".xg"])
def test_unported_graph_formats_raise(tmp_path, ext):
    """The formats the port once refused now reach their loaders: a
    corrupt <prefix>.<ext> raises the loader's own error, as in
    vgan_tpu.cli."""
    (tmp_path / ("euka_db" + ext)).write_bytes(b"\0")
    errors = []
    for mod in (port_cli, jax_cli):
        with pytest.raises(Exception) as e:
            mod._load_graph(str(tmp_path / "euka_db"))
        errors.append((type(e.value).__name__, str(e.value)))
    assert errors[0] == errors[1]
    assert errors[0][0] != "NotImplementedError"


def test_load_graph_resolves_like_jax(db):
    """<prefix>.npz first, then <prefix>.gfa, then graph.npz beside it."""
    for prefix in (os.path.join(db["euka_dir"], "euka_db"),
                   os.path.join(db["gfa_dir"], "euka_db")):
        got = port_cli._load_graph(prefix)
        want = jax_cli._load_graph(prefix)
        np.testing.assert_array_equal(got.node_seq_pool, want.node_seq_pool)
        np.testing.assert_array_equal(got.edge_to, want.edge_to)
        assert got.path_names == want.path_names
