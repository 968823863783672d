"""The port's copied host modules (newick, diagnostics, soibean, the DB
tools and the graph loaders) against their JAX-package sources: the
copies themselves, `build-taxon-db`, the routing of graph files by
extension, and each loader on the reference's fixtures (these skip where
the reference tree is absent, as tests/test_io.py's do)."""
import os
import zipfile

import numpy as np
import pytest

from vgan_tpu import cli as jax_cli
from vgan_tpu_torch import cli as port_cli
from vgan_tpu_torch.graph import synth as port_synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COPIES = ["utils/newick.py", "infer/diagnostics.py", "pipelines/soibean.py",
          "db/taxa.py", "io/vgformat.py", "io/odgi.py", "io/gbz.py",
          "io/xg.py"]


@pytest.mark.parametrize("module", COPIES)
def test_copied_module_equals_source(module):
    """Line 1 names the source; every other line is the source's own (the
    relative imports then resolve to the port's modules)."""
    with open(os.path.join(REPO, "vgan_tpu", module)) as f:
        src = f.read().splitlines()
    with open(os.path.join(REPO, "vgan_tpu_torch", module)) as f:
        port = f.read().splitlines()
    assert port[0].startswith(f"# Copied unchanged from vgan_tpu/{module}")
    assert port[1:] == src


def _npz_members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in sorted(z.namelist())}


def test_build_taxon_db_equals_jax(tmp_path):
    """`build-taxon-db` on an .npz super-graph with a two-taxon clade
    file: the same members, byte for byte, as vgan_tpu.cli's (the zip
    entries' timestamps aside)."""
    codes = np.random.default_rng(4).integers(0, 4, size=4000)
    backbone = np.frombuffer(b"ACGT", np.uint8)[codes].tobytes().decode()
    g, _ = port_synth.build_haplotype_graph(backbone, n_haplotypes=3,
                                            n_variants=10, seed=1)
    d = tmp_path / "super"
    d.mkdir()
    g.save(str(d / "graph.npz"))
    mid = g.min_id + g.n_nodes // 2
    (d / "soibean_db.clade").write_text(
        f"0 TaxLow 0.05 3 {g.min_id} {mid}\n"
        f"1 TaxHigh 0.05 3 {mid + 1} {g.max_id}\n")
    for taxon in ("TaxLow", "TaxHigh"):
        assert jax_cli.main(["build-taxon-db", str(d), taxon,
                             str(tmp_path / "jax")]) == 0
        assert port_cli.main(["build-taxon-db", str(d), taxon,
                              str(tmp_path / "port")]) == 0
        got = _npz_members(tmp_path / "port" / f"{taxon}.npz")
        want = _npz_members(tmp_path / "jax" / f"{taxon}.npz")
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name] == want[name], (taxon, name)


LOADERS = {
    # extension -> (module, function) of each package's loader
    ".npz": ("graph.packed", "PackedGraph.load"),
    ".vg": ("io.vgformat", "read_vg"),
    ".og": ("io.odgi", "read_og"),
    ".gbz": ("io.gbz", "load_packed_graph"),
    ".giraffe.gbz": ("io.gbz", "load_packed_graph"),
    ".gg": ("io.gbz", "load_packed_graph_gg"),
    ".xg": ("io.xg", "load_packed_graph_xg"),
    ".gfa": ("graph.packed", "PackedGraph.from_gfa"),
}


def _routes(pkg, cli_mod, monkeypatch):
    """{extension: the loader cli_mod._load_one_graph calls}."""
    import importlib

    for mod, fn in set(LOADERS.values()):
        m = importlib.import_module(f"{pkg}.{mod}")
        owner, attr = (m.PackedGraph, fn.split(".")[1]) if "." in fn \
            else (m, fn)
        monkeypatch.setattr(owner, attr,
                            lambda *a, _n=f"{mod}.{fn}", **k: _n)
    return {ext: cli_mod._load_one_graph("x/graph" + ext)
            for ext in LOADERS}


def test_load_one_graph_routes_like_jax(monkeypatch):
    port = _routes("vgan_tpu_torch", port_cli, monkeypatch)
    jax = _routes("vgan_tpu", jax_cli, monkeypatch)
    assert port == jax == {e: f"{m}.{f}" for e, (m, f) in LOADERS.items()}


def _graphs_equal(a, b):
    assert a.min_id == b.min_id
    for f in ("node_seq_pool", "node_off", "edge_from", "edge_from_rev",
              "edge_to", "edge_to_rev", "path_support"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert a.path_names == b.path_names
    for x, y in zip(a.path_steps_node, b.path_steps_node):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a.path_steps_rev, b.path_steps_rev):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("fixture", [
    "test/reconstructInputSeq/target_graph.vg",
    "test/reconstructInputSeq/target_graph.og",
    "test/input_files/target.giraffe.gbz",
    "test/input_files/target.gg",
    "test/input_files/target.xg",
])
def test_loader_on_reference_fixture_equals_jax(ref, fixture, tmp_path):
    """Each format's loader on the reference's fixture (.gg with its
    sibling .gbwt), and `build-db` from it: the same packed graph."""
    path = str(ref / fixture)
    _graphs_equal(port_cli._load_one_graph(path),
                  jax_cli._load_one_graph(path))
    assert port_cli.main(["build-db", path, str(tmp_path / "p")]) == 0
    assert jax_cli.main(["build-db", path, str(tmp_path / "j")]) == 0
    got = _npz_members(tmp_path / "p" / "graph.npz")
    want = _npz_members(tmp_path / "j" / "graph.npz")
    assert got == want
