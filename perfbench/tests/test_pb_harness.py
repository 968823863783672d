"""CPU tests of the benchmark's harness, reference and yardstick.

    python -m pytest perfbench/tests -q

from the root of the repository. The tests marked `cuda` need the card
and skip without one; they decide that inside the test.
"""
import ast
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from perfbench import bounds, run  # noqa: E402

# a soibean world and sample small enough for the CPU's plain kernels
TINY = dict(leaves=8, backbone_bp=3000, reads_per_sample=120,
            iterations=40, burnin=10, warm_up_iterations=30, samples=2,
            ll_steps_per_row=64, steps_per_row=64)
CELL = "sb-sample-4k"


def _dry(seed, **kw):
    t = time.perf_counter()
    return run.run_cell(ROOT, CELL, seed, 0.0, False, "cpu", t,
                        overrides=dict(TINY), **kw)


def test_finds_a_cell_that_only_new_files_define(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cfg = json.loads((tmp_path / "perfbench/configs/"
                      "soibean-family-128.json").read_text())
    cfg.update(name="soibean-family-64", leaves=64)
    (tmp_path / "perfbench/configs/soibean-family-64.json").write_text(
        json.dumps(cfg))
    traffic = json.loads((tmp_path / "perfbench/traffic/sample-4k.json")
                         .read_text())
    traffic["reads_per_sample"] = 2000
    (tmp_path / "perfbench/traffic/sample-2k.json").write_text(
        json.dumps(traffic))
    (tmp_path / "perfbench/metrics/sb_samples.py").write_text(
        "def read(ctx):\n    return float(ctx.samples)\n")
    bench["configs"].append(dict(bench["configs"][0],
                                 name="soibean-family-64",
                                 file="perfbench/configs/soibean-family-64.json"))
    bench["workloads"].append(dict(name="sb-small", config="soibean-family-64",
                                   traffic="sample-2k", chips=1, why="test"))
    bench["end_to_end"][0]["workloads"].append("sb-small")
    bench["per_layer"].append(dict(
        name="sb_samples", unit="1", better="higher", source="host_clock",
        layer="test", moves="mcmc_steps_per_s", workloads=["sb-small"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    b, cell, cfg2, traffic2 = run.load_cell(str(tmp_path), "sb-small")
    assert cell["config"] == "soibean-family-64"
    assert cfg2["leaves"] == 64 and cfg2["pipeline"] == "soibean"
    assert traffic2["reads_per_sample"] == 2000
    assert [m["name"] for m in run.reported(b, cell, False)] == [
        "mcmc_steps_per_s", "setup_s"]
    assert [m["name"] for m in run.reported(b, cell, True)] == ["sb_samples"]
    ctx = type("Ctx", (), {"samples": 3})()
    assert run.reader(str(tmp_path), "sb_samples")(ctx) == 3.0


def test_every_metric_has_its_reader_and_every_cell_its_files():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "perfbench", "metrics",
                                           m["name"] + ".py")), m["name"]
    for w in bench["workloads"]:
        _b, _c, cfg, _t = run.load_cell(ROOT, w["name"])
        assert os.path.exists(os.path.join(
            ROOT, "perfbench", "pipelines", cfg["pipeline"] + ".py"))
        assert run.reported(bench, w, True), w["name"]


def test_dry_run_loads_no_jax_nor_the_jax_package():
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "from perfbench import run\n"
            "r, c, _ = run.run_cell(%r, %r, 5, 0.0, False, 'cpu', "
            "time.perf_counter(), overrides=%r)\n"
            "print('RESULT', r['correct'], run.forbidden_modules(), "
            "'vgan_tpu_torch' in sys.modules)\n" % (ROOT, ROOT, CELL, TINY))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600)
    line = [x for x in out.stdout.splitlines() if x.startswith("RESULT")]
    assert line, out.stderr[-3000:]
    assert line[0] == "RESULT True [] True"


def test_reference_imports_neither_jax_nor_the_program():
    refs = sorted("reference/" + f for f in os.listdir(
        os.path.join(ROOT, "perfbench", "reference")) if f.endswith(".py"))
    for name in refs + ["world.py", "bounds.py"]:
        # the chains' noise is drawn again with torch's generators
        allowed = {"__future__", "typing", "math", "statistics", "numpy"} | (
            {"torch"} if name == "reference/noise.py" else set())
        tree = ast.parse(open(os.path.join(ROOT, "perfbench", name)).read())
        mods = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods.add(node.module.split(".")[0])
        assert mods <= allowed, (name, mods)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import perfbench.reference.soibean_ref, "
            "perfbench.reference.noise, perfbench.world, perfbench.bounds\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'vgan_tpu', 'vgan_tpu_torch'}))\n"
            % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]


def test_tree_bound_known_values():
    # 200 post-burn-in steps of the k-sweep batch: 12 rows, Kmax 3, 24
    # active sources, 4,000 reads, 255 paths, uint8 counts, 8 hops
    s = bounds.tree_bound_s(12, 3, 24, 200, 4000, 255, 1, 8)
    fma = 200 * 24 * 2 * 4000 * 25
    assert s == pytest.approx(fma / 33.5e12, rel=1e-12)
    assert s * 1e3 == pytest.approx(0.02866, abs=1e-5)
    # a bytes-bound case: one row, one read
    nbytes = 255 * 8 + 255 * 25 + 10 * (1 * (2 + 4 * 32) + 1) * 4 \
        + 10 * (20 + 8)
    assert bounds.tree_bound_s(1, 1, 1, 10, 1, 255, 1, 32) == pytest.approx(
        nbytes / 3.35e12, rel=1e-12)
    assert bounds.burn_walk_hops(255) == 32
    assert bounds.burn_walk_hops(15) == 20
    assert bounds.burn_walk_hops(5) == 20


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class _NoSpans:
    def __call__(self, name):
        import contextlib
        return contextlib.nullcontext()


@pytest.mark.parametrize("seconds,sample_s,want_n", [
    (10.0, 3.0, 4), (10.0, 60.0, 1), (0.0, 1.0, 1), (9.0, 3.0, 3)])
def test_window_counts_whole_samples(seconds, sample_s, want_n):
    clock = _Clock()

    def sample(i, spans):
        clock.t += sample_s
        return 1000.0

    n, work, elapsed = run.run_window(sample, seconds, _NoSpans(), clock)
    assert n == want_n
    assert work == 1000.0 * want_n
    assert elapsed == pytest.approx(sample_s * want_n)
    assert work / elapsed == pytest.approx(1000.0 / sample_s)


def test_busy_intervals_and_breakdown():
    ev = [("k", 10, 5), ("k", 12, 10), ("m", 40, 10), ("k", 95, 20)]
    merged = run.busy_intervals(ev, 0, 100)
    assert merged == [[10, 22], [40, 50], [95, 100]]
    spans = [("sample", 0, 100), ("sample.map", 20, 45)]
    ops, gaps = run.breakdown(ev, merged, spans, 0, 100)
    assert ops[0] == ["k", 35e-9]
    assert gaps[0] == ["sample", 45e-9]
    assert ["sample.map", 18e-9] in gaps


def test_dry_run_sound_is_correct_and_control_is_not():
    result, compared, control = _dry(11, control=True)
    assert result["correct"], compared
    assert result["attempted"] == 1
    got = {n: v for n, v, _l in compared}
    assert got["stats_gap"] < 1e-13 and got["ll_gap"] < 1e-12
    assert got["step_bad"] == 0 and got["step_gap"] < 1e-12
    assert got["summary_gap"] < 1e-12
    assert not all(v <= lim for _n, v, lim in control), control
    ctl = {n: v for n, v, _l in control}
    assert ctl["stats_gap"] > 1e-9 and ctl["ll_gap"] > 1e-8
    assert ctl["step_gap"] > 1e-8


@pytest.mark.parametrize("fault,number", [
    ("frozen_step", "frozen_rows"), ("half_reads", "ll_gap"),
    ("half_mapped", "unmapped"), ("altered_alignment", "align_bad"),
    ("altered_loglike", "ll_gap"), ("always_accept", "step_bad"),
    ("zeroed_patristic", "summary_gap")])
def test_dry_run_with_a_planted_fault_is_not_correct(fault, number):
    from perfbench import faults

    with faults.FAULTS[fault]():
        result, compared, _ = _dry(12)
    assert not result["correct"]
    bad = {n for n, v, lim in compared if not v <= lim}
    assert number in bad, compared


@pytest.mark.cuda
def test_control_fails_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    sizes = dict(TINY, leaves=32, backbone_bp=8000, reads_per_sample=1000,
                 iterations=3000, burnin=1000, warm_up_iterations=300)
    for seed in (21, 22, 23):
        result, compared, control = run.run_cell(
            ROOT, CELL, seed, 0.0, False, "cuda:0", time.perf_counter(),
            overrides=sizes, control=True)
        assert result["correct"], compared
        assert not all(v <= lim for _n, v, lim in control), control
