"""The port's bench (vgan_tpu_torch/bench.py) against the JAX package's
bench.py, on the CPU: its reference-free worlds against the graphs
vgan_tpu.graph.synth builds from the same backbone and arguments, array
for array; its DB builder, tree and SW and device-step phases against
bench.py's and vgan_tpu's functions on the same inputs (f64 scores to
rtol 1e-12, SW scores exact); the output line's names against
bench.py's FIELD_ORDER; a failing phase and a missing card.
"""
import io
import json
import os
import sys
from contextlib import redirect_stdout
from dataclasses import replace

import numpy as np
import pytest
import torch

import _torch_world as world
import bench as jax_bench
from vgan_tpu.graph import synth as jax_synth
from vgan_tpu.mapper import sw_pallas
from vgan_tpu.pipelines import haplocart_device as jax_hcd
from vgan_tpu_torch import bench, cli
from vgan_tpu_torch.mapper import sw

torch.set_num_threads(1)

RTOL = 1e-12
DROPPED = ("sw_vpu_fraction", "backend")
ADDED = ["sw_bound_share", "card", "host_cpus", "worlds"]
SMOKE = bench.Sizes.of(True)

GRAPH_ARRAYS = ("node_seq_pool", "node_off", "edge_from", "edge_from_rev",
                "edge_to", "edge_to_rev", "path_support")


def _assert_same_graph(got, want):
    assert got.min_id == want.min_id
    for name in GRAPH_ARRAYS:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    assert got.path_names == want.path_names
    for a, b in zip(got.path_steps_node + got.path_steps_rev,
                    want.path_steps_node + want.path_steps_rev,
                    strict=True):
        np.testing.assert_array_equal(a, b)


def _jax_soibean_graph():
    """bench.py:525-539 over the port's backbone."""
    names = ["speciesA", "speciesB", "speciesC", "speciesD"]
    graph, _ = jax_synth.build_haplotype_graph(
        bench.backbone()[:4000], n_haplotypes=4, n_variants=40, seed=11,
        hap_names=names)
    for proxy in ["speciesA", "speciesC", "speciesA"]:
        j = graph.path_names.index(proxy)
        graph.path_steps_node.append(graph.path_steps_node[j])
        graph.path_steps_rev.append(graph.path_steps_rev[j])
    graph.path_names.extend(["N1", "N2", "N3"])
    support = np.zeros((graph.n_nodes, len(graph.path_names)), dtype=bool)
    for j, sn in enumerate(graph.path_steps_node):
        support[sn, j] = True
    graph.path_support = support
    return graph


# (port world, bench.py's arguments to build_haplotype_graph)
WORLDS = {
    "toy": (bench.toy_graph, dict(n_bp=16569, n_haplotypes=32,
                                  n_variants=120, seed=3)),
    "realdb_smoke": (lambda: bench.realdb_graph(SMOKE.realdb_haps),
                     dict(n_bp=16569, n_haplotypes=64, n_variants=600,
                          seed=3)),
    "multihost": (bench.multihost_graph, dict(n_bp=6000, n_haplotypes=8,
                                              n_variants=60, seed=3)),
}


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_world_equals_jax_synth(name):
    make, kw = WORLDS[name]
    kw = dict(kw)
    ref = bench.backbone()[:kw.pop("n_bp")]
    want, _ = jax_synth.build_haplotype_graph(ref, **kw)
    _assert_same_graph(make(), want)


def test_soibean_world_equals_jax_synth():
    _assert_same_graph(bench.soibean_graph(), _jax_soibean_graph())


def test_backbone_is_chip_smokes():
    """The rCRS stand-in: 16,569 seeded random bases
    (np.random.default_rng(0)), which chip_smoke.py's world is built
    on too."""
    codes = np.random.default_rng(0).integers(0, 4, size=16569)
    want = np.frombuffer(b"ACGT", np.uint8)[codes].tobytes().decode()
    assert bench.backbone() == want
    assert bench.backbone(4000) == want[:4000]


def test_db_from_graph_equals_bench_py():
    graph = bench.multihost_graph()
    want = jax_bench._db_from_graph(graph)
    got = bench._db_from_graph(graph, "cpu")
    assert got.path_names == want.path_names
    np.testing.assert_array_equal(got.pangenome_base, want.pangenome_base)
    np.testing.assert_array_equal(got.mappabilities, want.mappabilities)
    np.testing.assert_array_equal(got.match_prob, want.match_prob)
    assert got.device == torch.device("cpu")


@pytest.mark.parametrize("n_leaves,seed", [(8, 3), (128, 7)])
def test_random_tree_is_the_test_worlds(n_leaves, seed):
    """The test worlds' tree is the bench's, a rooted binary tree of
    n_leaves leaves with branch lengths in [0.01, 0.3], and the same
    tree again from the same seed."""
    assert world.random_tree is bench.random_tree
    newick, children, length, root = bench.random_tree(n_leaves, seed)
    assert bench.random_tree(n_leaves, seed)[0] == newick
    assert len(children) == n_leaves - 1
    assert all(len(kids) == 2 for kids in children.values())
    assert root not in length and len(length) == 2 * n_leaves - 2
    assert all(0.01 <= v <= 0.3 for v in length.values())
    leaves = set(length) - set(children)
    assert leaves == {f"L{i}" for i in range(n_leaves)}


def test_bench_takes_a_built_realdb_world():
    """A real-DB world given to Bench (graph and its k=31, w=11 mapper)
    is the one its phases use; one of another size or k/w is refused."""
    from vgan_tpu_torch.mapper.giraffe import BatchedMapper

    graph = bench.realdb_graph(SMOKE.realdb_haps)
    mapper = BatchedMapper(graph, k=31, w=11, device="cpu")
    b = bench.Bench("cpu", SMOKE, realdb=(graph, mapper))
    db, got, reads, n = b.realdb()
    assert got is mapper and db.graph is graph and n == SMOKE.realdb_haps
    assert len(reads) == 2 * SMOKE.n_reads_real
    other = BatchedMapper(graph, k=20, w=10, index=None, device="cpu")
    with pytest.raises(RuntimeError, match="real-DB world"):
        bench.Bench("cpu", SMOKE, realdb=(graph, other))
    with pytest.raises(RuntimeError, match="real-DB world"):
        bench.Bench("cpu", replace(SMOKE, realdb_haps=65),
                    realdb=(graph, mapper))


def test_run_names_the_running_phase(monkeypatch):
    """Bench.phase is the name of the phase that runs, None outside."""
    seen = {}

    def probe(name):
        def phase(b):
            seen[name] = b.phase
            return {}
        return phase

    for name in ("sw", "keelime"):
        monkeypatch.setitem(bench.PHASES, name, probe(name))
    b = bench.Bench("cpu", SMOKE)
    assert bench.run(b, ["keelime", "sw"]) == {}
    assert seen == {"sw": "sw", "keelime": "keelime"} and b.phase is None


def test_soibean_tree_has_255_nodes():
    from vgan_tpu_torch.utils.newick import parse_newick

    tree = parse_newick(bench.random_tree(bench.SOIBEAN_LEAVES,
                                          bench.SOIBEAN_TREE_SEED)[0])
    assert tree.n_nodes == 255
    assert int((tree.n_children == 0).sum()) == 128


def test_device_step_scores_equal_jax_f64():
    """entry.synth_support / synth_batch through haplocart_device in the
    port and in the JAX package, both on f64 tables (bench.py's own run
    takes JAX's f32 default), at a cut support matrix."""
    import jax.numpy as jnp

    n_nodes, n_paths = 512, 640
    b = bench.Bench("cpu", replace(SMOKE, n_reads_dev=256))
    rps, runs, cpu_rps, agree, got = bench.bench_device_step(
        b, n_nodes=n_nodes, n_paths=n_paths)
    tables = jax_hcd.make_tables(
        jax_hcd.synth_support(n_nodes=n_nodes, n_paths=n_paths),
        jnp.float64)
    batch = jax_hcd.synth_batch(256, n_nodes=n_nodes, dtype=jnp.float64)
    want = np.asarray(jax_hcd.score_batch(batch, tables))
    assert got.shape == (n_paths,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert agree and rps > 0 and cpu_rps > 0 and len(runs) == 3


def test_sw_phase_scores_equal_jax_and_plain():
    """The sw phase's inputs and last scores at bench.py's smoke shape:
    equal to sw_scores_plain and to JAX's sw_scores_xla, which bench.py
    times."""
    b = bench.Bench("cpu", SMOKE)
    fields = bench.phase_sw(b)
    args, got = b.sw_call
    assert [tuple(a.shape) for a in args] == [(256, 64), (256, 64), (256,),
                                              (256,)]
    assert torch.equal(got, sw.sw_scores_plain(*args))
    want = np.asarray(sw_pallas.sw_scores_xla(*[a.numpy() for a in args]))
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(fields) == {"sw_kernel_gcups", "sw_bound_share",
                           "sw_kernel_gcups_runs_s"}
    assert len(fields["sw_kernel_gcups_runs_s"]) == 3


def test_sw_bound_at_bench_shape():
    """5 ALU operations a cell over 132 SMs x 64 lanes x 1.98 GHz:
    134,217,728 cells take at least 0.0401 ms."""
    from vgan_tpu_torch.utils.roofline import sw_bound_ms

    B, R, W = bench.Sizes.of(False).sw_shape
    ms, by = sw_bound_ms(B * R * W, 0, 4 * (B * R + B * W + 3 * B))
    assert B * R * W == 134_217_728 and by == "operations"
    assert ms == pytest.approx(0.0401, abs=5e-5)


def test_field_order_is_bench_pys_less_two():
    assert bench.FIELD_ORDER == [f for f in jax_bench.FIELD_ORDER
                                 if f not in DROPPED]
    assert set(bench.BEST_OF_FIELDS) <= set(bench.FIELD_ORDER)


def test_result_names_and_order():
    """Every field present: FIELD_ORDER's names in order, then the
    additions, then a runs list for each best-of-N field."""
    fields = {k: 1.0 for k in bench.FIELD_ORDER}
    fields["sw_bound_share"] = 0.5
    fields.update({f"{k}_runs_s": [1.0] for k in bench.BEST_OF_FIELDS})
    out = bench.result(fields, bench.Bench("cpu", SMOKE))
    assert list(out) == ([f for f in jax_bench.FIELD_ORDER
                          if f not in DROPPED] + ADDED
                         + [f"{k}_runs_s" for k in bench.BEST_OF_FIELDS])
    assert out["card"] == "cpu" and out["host_cpus"] == os.cpu_count()
    assert out["worlds"] == bench.WORLDS and len(bench.WORLDS) == 2
    assert all("\n" not in line and "->" in line for line in bench.WORLDS)


def test_cli_bench_one_phase_prints_json_last(monkeypatch):
    monkeypatch.setenv("BENCH_SMOKE", "1")
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main(["bench", "--phase", "sw", "--device", "cpu"])
    assert rc == 0
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert list(out) == (["sw_kernel_gcups"] + ADDED
                         + ["sw_kernel_gcups_runs_s"])
    assert out["sw_kernel_gcups"] > 0 and out["card"] == "cpu"


def test_failed_phase_exits_nonzero_naming_it(monkeypatch, capsys):
    def broken(b):
        raise ValueError("planted fault")

    monkeypatch.setitem(bench.PHASES, "device_step", broken)
    monkeypatch.setenv("BENCH_SMOKE", "1")
    assert bench.main(["--phase", "device_step", "--device", "cpu"]) == 1
    cap = capsys.readouterr()
    assert "bench phase device_step failed: planted fault" in cap.err
    assert cap.out == ""
    with pytest.raises(RuntimeError, match="bench phase device_step"):
        bench.run(bench.Bench("cpu", SMOKE), ["sw", "device_step"])


@pytest.mark.parametrize("entry", ["bench", "cli"])
def test_cuda_without_a_card_raises(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        if entry == "bench":
            bench.main(["--phase", "sw"])
        else:
            cli.main(["bench", "--device", "cuda"])


def test_module_entry_point(tmp_path):
    """python -m vgan_tpu_torch.bench: the unknown-phase error."""
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run(
        [sys.executable, "-m", "vgan_tpu_torch.bench", "--phase", "nope",
         "--device", "cpu"], cwd=repo, capture_output=True, text=True,
        timeout=120, env=dict(os.environ, PYTHONPATH=repo))
    assert p.returncode == 2 and "invalid choice: 'nope'" in p.stderr
