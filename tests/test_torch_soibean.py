"""soibean in the port (vgan_tpu_torch: pipelines/soibean.py,
pipelines/soibean_runner.py, cli `soibean`, on the CPU) against the JAX
package's, on a reference-free world: a seeded random 8-leaf tree, one
path per tree node over a seeded random backbone with variants along the
branches (tests/_torch_world.py), and reads of two leaves.

The chains get the JAX package's noise and initial proportions
(tests/test_torch_tree_mcmc.py:jax_noise / jax_theta). The statistics
and the estimate tables (.6g) must be byte-equal. The traces and the
diagnostics print f64 values at 14 significant digits or in full, and
XLA's f64 exp, log1p, erfc, ndtr and ndtri on the CPU differ from
PyTorch's (and libm's) in the last bit for a share of inputs, so the
samplers agree to rtol 1e-12 and not bit for bit: those files must be
equal token for token, every number to rtol 1e-12."""
import gzip
import os

import numpy as np
import pytest
import torch

import _torch_world as world
from test_torch_tree_mcmc import jax_noise, jax_theta
from vgan_tpu import cli as jax_cli
from vgan_tpu.graph.packed import PackedGraph as JaxGraph
from vgan_tpu.io import fastx as jax_fastx
from vgan_tpu.io import gam as jax_gam
from vgan_tpu.mapper.giraffe import BatchedMapper as JaxMapper
from vgan_tpu.parallel import mesh as jax_mesh
from vgan_tpu.pipelines import soibean as jax_sb
from vgan_tpu.pipelines import soibean_runner as jax_runner
from vgan_tpu.utils.newick import parse_newick as jax_parse
from vgan_tpu_torch import cli as port_cli
from vgan_tpu_torch.graph import synth as port_synth
from vgan_tpu_torch.infer import tree_mcmc as port_tm
from vgan_tpu_torch.io import fastx as port_fastx
from vgan_tpu_torch.mapper.giraffe import BatchedMapper as PortMapper
from vgan_tpu_torch.pipelines import soibean as port_sb
from vgan_tpu_torch.pipelines import soibean_runner as port_runner
from vgan_tpu_torch.utils.newick import parse_newick

torch.set_num_threads(1)

PREFIX = "fam"
BASE_FREQS = (0.3, 0.2, 0.22, 0.28)
ITERS = ["--iter", "300", "--burnin", "60", "--chains", "2"]


@pytest.fixture(scope="module")
def sb_world(tmp_path_factory):
    out = tmp_path_factory.mktemp("soibean")
    tw = world.random_tree(8, 3)
    graph, private = world.build_tree_graph(port_synth, tw, 3000, 40, seed=2)
    db = world.write_soibean_db(out / "db", PREFIX, graph, tw[0], BASE_FREQS)
    leaves = sorted((n for n in private if n.startswith("L")),
                    key=lambda n: -private[n])[:2]
    fq = str(out / "r.fq")
    world.write_source_fastq(port_synth, graph, fq,
                             [(leaves[0], 150), (leaves[1], 60)])
    # a GAM of the JAX mapper's alignments of the same reads
    jgraph = JaxGraph.load(os.path.join(db, PREFIX + ".npz"))
    alns = JaxMapper(jgraph, k=20, w=10).map_reads(jax_fastx.read_fastq(fq))
    gam = str(out / "r.gam")
    jax_gam.write_gam(gam, alns)
    return dict(out=out, db=db, fq=fq, gam=gam, newick=tw[0], leaves=leaves,
                graph=graph, jgraph=jgraph)


@pytest.fixture
def jax_streams(monkeypatch):
    """The port's chains draw the JAX package's noise and starting
    proportions; JAX runs its chains on one device."""
    monkeypatch.setattr(port_tm, "draw_noise", jax_noise)
    monkeypatch.setattr(port_tm, "init_theta", jax_theta)
    prev = jax_mesh._DEVICE_LIMIT
    jax_mesh.set_device_limit(1)
    yield
    jax_mesh.set_device_limit(prev)


def _stats(w):
    """(port stats, JAX stats) of the reads, each mapped and analysed by
    its own package's columnar path."""
    port_reads = port_fastx.read_fastq(w["fq"])
    table = PortMapper(w["graph"], k=20, w=10,
                       device="cpu").map_reads_table(port_reads)
    got = port_sb.analyse_table(w["graph"], table)
    jtable = JaxMapper(w["jgraph"], k=20, w=10).map_reads_table(
        jax_fastx.read_fastq(w["fq"]))
    want = jax_sb.analyse_table(w["jgraph"], jtable)
    return got, want


def _read(path):
    with open(path, "rb") as f:
        data = f.read()
    return gzip.decompress(data) if path.endswith(".mcmc") else data


def _outputs(prefix):
    d, base = os.path.split(prefix)
    return {name[len(base):]: _read(os.path.join(d, name))
            for name in sorted(os.listdir(d)) if name.startswith(base)}


def _assert_tokens_close(got: bytes, want: bytes, name: str) -> int:
    """Same lines and tab-separated tokens; a token that differs must be
    a number within rtol 1e-12 of the other. Returns how many differ."""
    g_lines, w_lines = got.decode().split("\n"), want.decode().split("\n")
    assert len(g_lines) == len(w_lines), name
    n = 0
    for lg, lw in zip(g_lines, w_lines):
        tg, tw = lg.split("\t"), lw.split("\t")
        assert len(tg) == len(tw), (name, lg, lw)
        for a, b in zip(tg, tw):
            if a != b:
                n += 1
                assert float(a) == pytest.approx(float(b), rel=1e-12,
                                                 abs=0), (name, lg, lw)
    return n


def _assert_outputs_match(got, want):
    """The five file kinds: the .6g estimate tables byte-equal, the
    traces and diagnostics token-equal with numbers to rtol 1e-12."""
    assert sorted(got) == sorted(want)
    kinds = {"Result", "Trace", "ProportionEstimates", "BranchEstimate",
             "Diagnostics"}
    assert {k for k in kinds if any(n.startswith(k) for n in got)} == kinds
    for name in want:
        if name.startswith(("ProportionEstimates", "BranchEstimate")):
            assert got[name] == want[name], name
        else:
            _assert_tokens_close(got[name], want[name], name)


# ------------------------------------------------------------- pieces
def test_analyse_signature_and_initial_ll_equal_jax(sb_world):
    got, want = _stats(sb_world)
    assert got.names == want.names
    for f in ("path_map", "counts25", "most_prob_unique"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    names = sb_world["graph"].path_names
    tree = parse_newick(sb_world["newick"])
    sig = port_sb.signature_nodes(got, names, tree.name_to_index())
    assert sig == jax_sb.signature_nodes(want, names, tree.name_to_index())
    # the two planted leaves lead the signature paths
    assert sig[1][:2] == sb_world["leaves"]
    for k in (1, 2, 3):
        idx = [names.index(p) for p in sig[1][:k]]
        assert port_sb.initial_log_like(got, idx) == \
            jax_sb.initial_log_like(want, idx)


def test_run_soibean_inference_equals_jax(sb_world, jax_streams, tmp_path):
    """The k-sweep (k = 1, 2; two chains) through run_soibean_inference:
    summaries and the five file kinds."""
    got_stats, want_stats = _stats(sb_world)
    names = sb_world["graph"].path_names
    freqs = port_sb.make_freqs(*BASE_FREQS)
    kw = dict(n_iter=300, burnin=60, chains=2)
    got = port_runner.run_soibean_inference(
        parse_newick(sb_world["newick"]), got_stats, names, freqs,
        str(tmp_path / "p_"), device="cpu", **kw)
    want = jax_runner.run_soibean_inference(
        jax_parse(sb_world["newick"]), want_stats, names, freqs,
        str(tmp_path / "j_"), **kw)
    assert sorted(got) == sorted(want) == [1, 2]
    for k in want:
        for g, w in zip(got[k], want[k]):
            assert g.source_names == w.source_names
            for f in ("theta_mean", "theta_var", "pos_mean", "pos_var"):
                np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                           rtol=1e-12, err_msg=f)
            assert g.est_lines == w.est_lines
            assert g.branch_lines == w.branch_lines
    _assert_outputs_match(_outputs(str(tmp_path / "p_")),
                          _outputs(str(tmp_path / "j_")))


# ------------------------------------------------------------- the CLI
def _run_both(w, tag, args, side_args=lambda side: []):
    jout = str(w["out"] / f"jax_{tag}_")
    pout = str(w["out"] / f"port_{tag}_")
    base = ["soibean", "--soibean_dir", w["db"], "--dbprefix", PREFIX]
    assert jax_cli.main(base + args + side_args("jax") + ["-o", jout]) == 0
    assert port_cli.main(base + args + side_args("port")
                         + ["-o", pout, "--device", "cpu"]) == 0
    return _outputs(pout), _outputs(jout)


@pytest.mark.parametrize("inp", ["fq1", "gam"])
def test_soibean_cli_equals_jax(sb_world, jax_streams, inp):
    args = (["-fq1", sb_world["fq"]] if inp == "fq1"
            else ["-g", sb_world["gam"]]) + ITERS
    got, want = _run_both(sb_world, inp, args)
    _assert_outputs_match(got, want)


def test_soibean_cli_no_mcmc_alignment_detail_byte_equal(sb_world):
    """--no-mcmc stops after the statistics; with --alignment-detail the
    row-at-a-time writer leaves its per-read TSV."""
    got, want = _run_both(sb_world, "nomcmc",
                          ["-fq1", sb_world["fq"], "--no-mcmc",
                           "--alignment-detail"])
    assert sorted(got) == sorted(want) and got
    for name in want:
        assert got[name] == want[name], name


def test_soibean_cli_checkpoint_equals_jax(sb_world, jax_streams):
    """--checkpoint runs each chain through the resumable runner and
    leaves its snapshots; outputs as without it."""
    # k = 1, a 50-step burn-in segment and two of 100 steps: two
    # compiled segment shapes on the JAX side
    args = ["-fq1", sb_world["fq"], "-k", "1", "--iter", "249", "--burnin",
            "49", "--chains", "2", "--checkpoint-every", "100"]
    got, want = _run_both(
        sb_world, "ckpt", args,
        lambda side: ["--checkpoint", str(sb_world["out"] / f"{side}_ck")])
    _assert_outputs_match(got, want)
    snaps = sorted(f for f in os.listdir(sb_world["out"])
                   if f.startswith("port_ck.k1."))
    assert snaps == ["port_ck.k1.c0.npz", "port_ck.k1.c1.npz"]
    z = np.load(str(sb_world["out"] / snaps[0]))
    assert str(z["format"]) == port_tm.CHECKPOINT_FORMAT


def test_soibean_cuda_without_card_raises(sb_world, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "nocard_")
    with pytest.raises(RuntimeError, match="cuda"):
        # the default device is cuda: never a silent CPU run
        port_cli.main(["soibean", "--soibean_dir", sb_world["db"],
                       "--dbprefix", PREFIX, "-fq1", sb_world["fq"],
                       "-o", out])
    assert not os.listdir(tmp_path)
