"""The port's package rules: it runs where jax is absent, never imports
jax or vgan_tpu, compiles only its own sources, picks no device on its
own and never writes into the JAX package's native directory."""
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "vgan_tpu_torch")
TESTS = os.path.join(REPO, "tests")

torch.set_num_threads(1)

_NOJAX_SCRIPT = r"""
import importlib, os, pkgutil, sys
sys.modules["jax"] = None        # any `import jax` now raises ImportError
sys.modules["vgan_tpu"] = None
import vgan_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vgan_tpu_torch.__path__,
                                               "vgan_tpu_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, sys.argv[2])
import _torch_world as world
from vgan_tpu_torch.graph import synth
from vgan_tpu_torch import cli
out = sys.argv[1]
_g, db_dir, fq, _reads = world.build(synth, out, n_bp=1500, n_haps=8,
                                     n_variants=24, n_reads=120)
tsv = os.path.join(out, "hc.tsv")
assert cli.main(["haplocart", "--db", db_dir, "-fq1", fq, "-o", tsv,
                 "--device", "cpu"]) == 0
d5, d3 = world.write_damage_profiles(out)
assert cli.main(["keelime", "--dbdir", db_dir, "--dbprefix", "graph.npz",
                 "-fq1", fq, "-o", os.path.join(out, "kl_"), "-p", "hap5",
                 "--deam5p", d5, "--deam3p", d3, "--device", "cpu"]) == 0
import gzip
with gzip.open(os.path.join(out, "kl_Consensus.fa.gz"), "rt") as f:
    cons = f.read().split("\n")[1]
print("KEELIME", len(cons), len(cons) - cons.count("N"))
gam = os.path.join(out, "r.gam")
assert cli.main(["map", "--db", os.path.join(db_dir, "graph.npz"), "-fq1", fq,
                 "-o", gam, "--device", "cpu"]) == 0
assert cli.main(["duprm", gam, os.path.join(out, "dedup.gam")]) == 0
from vgan_tpu_torch.io import gam as gamio
print("DUPRM", len(gamio.read_gam(gam)),
      len(gamio.read_gam(os.path.join(out, "dedup.gam"))))
from vgan_tpu_torch.graph.packed import PackedGraph
graph, ranges = world.build_euka_graph(synth, PackedGraph, n_bp=1500)
edir, _d5, _d3 = world.write_euka_db(
    os.path.join(out, "edb"), graph, ranges, 2, [0.03] * 3,
    world.euka_bins(ranges, n_bins=4))
efq = os.path.join(out, "euka.fq")
world.write_mixture_fastq(synth, graph, efq, [(0, 60), (1, 30)], 2)
eout = os.path.join(out, "eu")
assert cli.main(["euka", "--euka_dir", edir, "-fq1", efq, "-o", eout,
                 "--minBins", "2", "--iter", "200", "--burnin", "10",
                 "--device", "cpu"]) == 0
tw = world.random_tree(8, 3)
sg, priv = world.build_tree_graph(synth, tw, 1500, 40, seed=2)
sdb = world.write_soibean_db(os.path.join(out, "sdb"), "fam", sg, tw[0],
                             [0.25] * 4)
leaves = sorted((n for n in priv if n.startswith("L")),
                key=lambda n: -priv[n])[:2]
sfq = os.path.join(out, "sb.fq")
world.write_source_fastq(synth, sg, sfq, [(leaves[0], 60), (leaves[1], 30)])
assert cli.main(["soibean", "--soibean_dir", sdb, "--dbprefix", "fam",
                 "-fq1", sfq, "-o", os.path.join(out, "sb_"), "--iter", "200",
                 "--burnin", "40", "--chains", "2", "--device", "cpu"]) == 0
print("SOIBEAN", " ".join(sorted(f for f in os.listdir(out)
                                 if f.startswith("sb_"))))
# the plot commands, the torch trace and the entry points
assert cli.main(["plot-k", os.path.join(out, "sb_")]) == 0
assert os.path.getsize(os.path.join(out, "sb_kCurve.png")) > 1000
from vgan_tpu_torch import entry
from vgan_tpu_torch.utils import profiling
with profiling.torch_trace(os.path.join(out, "trace")):
    fn, args = entry.entry("cpu")
    assert fn(*args).shape == (640,)
print("TRACE", os.listdir(os.path.join(out, "trace")))
print("DRYRUN", entry.dryrun_multichip(2, "cpu"))
leaked = [m for m in sys.modules
          if (m == "jax" or m.startswith(("jax.", "vgan_tpu.")))
          and sys.modules[m] is not None]
assert not leaked, leaked
print("MODULES", len(names))
print(open(tsv).read())
print(open(eout + "_detected.tsv").read())
assert cli.main(["tree-from-output", eout + "_abundance.tsv"]) == 0
"""


def test_port_runs_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-c", _NOJAX_SCRIPT, str(tmp_path), TESTS],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "MODULES" in r.stdout
    lines = [l for l in r.stdout.splitlines() if "\t" in l]
    assert lines[0] == "#sample\tpredicted haplogroup\treads"
    assert lines[1].split("\t")[1] == "hap5"
    # euka's detected taxa, with MCMC estimates and their intervals
    det = [l.split("\t") for l in lines if l.startswith("Taxon")]
    assert [d[0] for d in det] == ["Taxon0", "Taxon1"]
    assert all(d[1] == "yes" and len(d) == 8 for d in det)
    assert 0.5 < float(det[0][3]) < 0.85
    # keelime's consensus over the 1,500-bp haplotype, and duprm on the
    # port's own GAM of the same reads
    kl = [l for l in r.stdout.splitlines() if l.startswith("KEELIME")][0]
    n_cons, n_called = map(int, kl.split()[1:])
    assert n_cons >= 0.9 * 1500 and n_called >= 0.5 * 1500, kl
    dup = [l for l in r.stdout.splitlines() if l.startswith("DUPRM")][0]
    n_in, n_kept = map(int, dup.split()[1:])
    assert n_in == 120 and 0 < n_kept <= n_in, dup
    # soibean's five file kinds for k = 1 and 2
    sb = [l for l in r.stdout.splitlines() if l.startswith("SOIBEAN")][0]
    files = set(sb.split()[1:])
    for k in (1, 2):
        assert {f"sb_ProportionEstimates{k}.txt", f"sb_BranchEstimate{k}.txt",
                f"sb_Diagnostics{k}0.txt", f"sb_Result{k}1.mcmc",
                f"sb_Trace{k}1.detail.mcmc"} <= files, files
    # the new modules: plots, the torch trace, entry and the split steps
    trace = [l for l in r.stdout.splitlines() if l.startswith("TRACE")][0]
    assert "torch_trace." in trace, trace
    assert any(l.startswith("DRYRUN dryrun_multichip ok over 2 devices")
               for l in r.stdout.splitlines()), r.stdout
    assert "Taxon0 - detected - " in r.stdout


def test_no_jax_or_vgan_tpu_imports_in_port():
    pat = re.compile(r"^\s*(from|import)\s+(jax|vgan_tpu)(\.|\s|$)", re.M)
    offenders = []
    for root, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    if pat.search(fh.read()):
                        offenders.append(os.path.relpath(path, REPO))
    assert not offenders, offenders


def test_cuda_requested_without_card_raises(monkeypatch, tmp_path):
    sys.path.insert(0, TESTS)
    import _torch_world as world
    from vgan_tpu_torch import cli
    from vgan_tpu_torch.graph import synth
    from vgan_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    _g, db_dir, fq, _r = world.build(synth, tmp_path, n_bp=600, n_haps=4,
                                     n_variants=8, n_reads=20, hap=1)
    with pytest.raises(RuntimeError, match="cuda"):
        # the CLI's default device is cuda: never a silent CPU run
        cli.main(["haplocart", "--db", db_dir, "-fq1", fq,
                  "-o", str(tmp_path / "o.tsv")])
    assert not (tmp_path / "o.tsv").exists()


def test_import_changes_no_global_state():
    code = ("import torch; d = torch.get_default_dtype(); "
            "import vgan_tpu_torch.pipelines.haplocart_runner, "
            "vgan_tpu_torch.mapper.sw; "
            "assert torch.get_default_dtype() == d; print('ok')")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "ok" in r.stdout, r.stderr


def test_native_sources_lie_in_the_port(monkeypatch):
    """Every source _native compiles (the host library's C++ and the
    seven CUDA files) lies under vgan_tpu_torch/, and the host library
    is built from exactly the C++ list."""
    from vgan_tpu_torch import _native

    cuda = [_native.SW_SRC, _native.TREE_MCMC_SRC, _native.KEELIME_SRC,
            _native.ABUNDANCE_MCMC_SRC, _native.HAPLOCART_SRC,
            _native.EUKA_SRC, _native.PATRISTIC_SRC]
    host = [os.path.join(_native.CPP_DIR, s) for s in _native.HOST_SRCS]
    for src in host + cuda:
        assert os.path.isfile(src), src
        assert os.path.commonpath([os.path.realpath(src), PKG]) == PKG, src
    seen = []
    build = _native._build

    def recording(name, compiler, flags, srcs, libs):
        seen.append(list(srcs))
        return build(name, compiler, flags, srcs, libs)

    monkeypatch.setattr(_native, "_build", recording)
    monkeypatch.setattr(_native, "_loaded", {})
    _native.host_lib()
    assert seen == [host]


def test_native_library_built_outside_jax_package():
    from vgan_tpu_torch import _native

    lib = _native.host_lib()
    assert os.path.dirname(lib._name) == _native.BUILD_DIR
    assert not os.path.commonpath(
        [lib._name, os.path.join(REPO, "vgan_tpu")]
    ).endswith("vgan_tpu")
