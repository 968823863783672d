"""The port's tracer (vgan_tpu_torch/utils/profiling.py): spans with
parents and self times on the device trace's clock, counters, the
stages and report derived from the spans, recording turned on by a
torch.profiler session; and the spans and counters that soibean's path
and the mapper record, on the CPU at tiny sizes. Imports no JAX."""
import io
import os
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_world as world
from vgan_tpu_torch.graph import synth
from vgan_tpu_torch.infer import tree_mcmc as tm
from vgan_tpu_torch.io import fastx
from vgan_tpu_torch.mapper.giraffe import BatchedMapper
from vgan_tpu_torch.pipelines import soibean as sb
from vgan_tpu_torch.pipelines import soibean_runner as runner
from vgan_tpu_torch.utils import profiling
from vgan_tpu_torch.utils.newick import parse_newick

torch.set_num_threads(1)


class Clock:
    """A time_ns that advances by `step` on every read."""

    def __init__(self, step=10):
        self.t, self.step, self.reads = 0, step, 0

    def time_ns(self):
        self.reads += 1
        self.t += self.step
        return self.t


def _raise(*_a, **_k):
    raise AssertionError("called while recording is off")


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(profiling, "time", c)
    return c


@pytest.fixture
def global_profiler():
    """The port's PROFILER, emptied, recording on; restored after."""
    p = profiling.PROFILER
    was = p.enabled
    p.clear()
    p.enabled = True
    yield p
    p.enabled = was
    p.clear()


# ------------------------------------------------------------- the tracer
def test_off_records_nothing_reads_no_clock_and_calls_no_record_function(
        monkeypatch):
    p = profiling.Profiler(enabled=False)
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(
        time_ns=_raise))
    monkeypatch.setattr(profiling, "_autograd_profiler", types.SimpleNamespace(
        _is_profiler_enabled=False, record_function=_raise))
    monkeypatch.setattr(torch.cuda, "synchronize", _raise)
    # one shared no-op: nothing is allocated a span
    assert p.span("a") is p.span("b") is p.stage("c", items=3)
    with p.span("a"):
        with p.stage("b", items=5):
            p.count("n", 7)

    @p.traced("d")
    def f(x):
        return x + 1

    assert f(1) == 2
    assert p.records() == [] and p.counters == {} and p.stages == {}


def test_on_never_synchronizes(monkeypatch, clock):
    monkeypatch.setattr(torch.cuda, "synchronize", _raise)
    p = profiling.Profiler(enabled=True)
    with p.span("a"):
        with p.span("b"):
            pass
    assert [s.name for s in p.records()] == ["b", "a"]
    assert clock.reads == 4  # a start and an end a span, nothing else


def test_nested_spans_parents_and_self_times(clock):
    p = profiling.Profiler(enabled=True)
    with p.span("root"):            # t = 10
        with p.span("child"):       # 20
            with p.span("leaf"):    # 30
                pass                # 40
        p.count("n")                # child ends at 50
        with p.span("child"):       # 60
            p.count("n", 2)
        p.count("m", 4)             # child ends at 70
    # root ends at 80
    rec = {(s.name, s.start_ns): s for s in p.records()}
    root = rec[("root", 10)]
    c1, c2, leaf = rec[("child", 20)], rec[("child", 60)], rec[("leaf", 30)]
    assert root.parent == 0
    assert c1.parent == c2.parent == root.id
    assert leaf.parent == c1.id
    assert (root.end_ns, c1.end_ns, leaf.end_ns, c2.end_ns) == (80, 50, 40, 70)
    own = profiling.self_times(p.records())
    assert own[root.id] == 70 - 30 - 10
    assert own[c1.id] == 30 - 10
    assert own[leaf.id] == 10 and own[c2.id] == 10
    assert p.counters == {"n": 3, "m": 4}
    assert len({s.tid for s in p.records()}) == 1
    p.clear()
    assert p.records() == [] and p.counters == {}


def test_two_threads_keep_their_own_stacks():
    p = profiling.Profiler(enabled=True)
    barrier = threading.Barrier(2, timeout=30)
    errors = []

    def work(tag):
        try:
            with p.span(f"outer.{tag}"):
                barrier.wait()  # both outer spans open at once
                with p.span(f"inner.{tag}"):
                    barrier.wait()
                    p.count("n")
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors
    by_name = {s.name: s for s in p.records()}
    for tag in "ab":
        outer, inner = by_name[f"outer.{tag}"], by_name[f"inner.{tag}"]
        assert outer.parent == 0
        assert inner.parent == outer.id
        assert inner.tid == outer.tid
    assert by_name["outer.a"].tid != by_name["outer.b"].tid
    assert p.counters == {"n": 2}


def test_a_torch_profiler_session_turns_recording_on():
    p = profiling.Profiler(enabled=False)
    with p.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with p.span("traced.outer"):
            with p.span("traced.inner"):
                torch.ones(64).sum()
            p.count("n")
    with p.span("after"):
        pass
    spans = {s.name: s for s in p.records()}
    assert sorted(spans) == ["traced.inner", "traced.outer"]
    assert p.counters == {"n": 1}
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("traced.")}
    assert sorted(events) == sorted(spans)
    for name, s in spans.items():
        e = events[name]
        assert s.start_ns <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= s.end_ns


def test_stages_and_report_sum_the_spans_as_before(clock):
    p = profiling.Profiler(enabled=True)
    with p.stage("map", items=100):        # 10 .. 20
        pass
    with p.stage("analyse", items=40):     # 30 .. 60
        with p.span("soibean.analyse"):    # 40 .. 50
            pass
    with p.stage("map", items=50):         # 70 .. 80
        pass
    st = p.stages
    assert list(st) == ["map", "soibean.analyse", "analyse"]
    assert (st["map"].seconds, st["map"].items, st["map"].calls) == (
        20e-9, 150, 2)
    assert (st["analyse"].seconds, st["analyse"].items,
            st["analyse"].calls) == (30e-9, 40, 1)
    assert st["map"].per_s == pytest.approx(150 / 20e-9)
    out = io.StringIO()
    p.report(file=out)
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("── stage timing")
    names = [ln.split()[0] for ln in lines[1:]]
    assert names == ["map", "analyse", "soibean.analyse", "total"]
    # the child is indented under its parent; shares of the 50 ns the
    # roots cover
    child = [ln for ln in lines if "soibean.analyse" in ln][0]
    assert child.startswith("    soibean.analyse")
    assert "( 20.0%)" in child
    analyse = [ln for ln in lines if ln.split()[0] == "analyse"][0]
    assert "( 60.0%)" in analyse and "self     0.00s ( 40.0%)" in analyse
    assert "/s" in [ln for ln in lines if ln.split()[0] == "map"][0]
    assert lines[-1].split()[0] == "total"


def test_report_prints_the_counters_after_the_stages(clock):
    p = profiling.Profiler(enabled=True)
    p.count("tree_mcmc.row_steps", 1_500_003)
    p.count("mapper.reads", 4000)
    out = io.StringIO()
    p.report(file=out)  # no span: the counters alone
    assert out.getvalue().splitlines() == [
        "── counters ──",
        f"  {'mapper.reads':<32} {'4,000':>16}",
        f"  {'tree_mcmc.row_steps':<32} {'1,500,003':>16}"]
    with p.span("a"):
        pass
    out = io.StringIO()
    p.report(file=out)
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("── stage timing")
    assert lines[lines.index("── counters ──") - 1].split()[0] == "total"
    assert lines[-1].split() == ["tree_mcmc.row_steps", "1,500,003"]


# ---------------------------------------------------------- soibean's path
@pytest.fixture(scope="module")
def sb_world(tmp_path_factory):
    out = tmp_path_factory.mktemp("sb_trace")
    tw = world.random_tree(8, 3)
    graph, private = world.build_tree_graph(synth, tw, 3000, 40, seed=2)
    leaves = sorted((n for n in private if n.startswith("L")),
                    key=lambda n: -private[n])[:2]
    fq = str(out / "r.fq")
    world.write_source_fastq(synth, graph, fq,
                             [(leaves[0], 150), (leaves[1], 60)])
    return dict(graph=graph, tree=tw[0], reads=fastx.read_fastq(fq))


def _infer(w, stats, **kw):
    return runner.run_soibean_inference(
        parse_newick(w["tree"]), stats, w["graph"].path_names,
        sb.make_freqs(0.3, 0.2, 0.22, 0.28), "", write_files=False,
        device="cpu", **kw)


def test_soibean_traced_equals_untraced_and_records_the_span_tree(
        sb_world, global_profiler):
    p = global_profiler
    n_iter, burnin, chains = 120, 30, 2
    table = BatchedMapper(sb_world["graph"], k=20, w=10, device="cpu"
                          ).map_reads_table(sb_world["reads"])
    stats = sb.analyse_table(sb_world["graph"], table)
    traced = _infer(sb_world, stats, n_iter=n_iter, burnin=burnin,
                    chains=chains)
    spans, counters = p.records(), dict(p.counters)
    p.enabled = False
    plain = _infer(sb_world, stats, n_iter=n_iter, burnin=burnin,
                   chains=chains)
    assert p.records() == spans  # off: nothing more recorded
    K = len(traced)
    assert K >= 2 and sorted(traced) == sorted(plain) == list(range(1, K + 1))
    for k in traced:
        for a, b in zip(traced[k], plain[k]):
            assert a.est_lines == b.est_lines
            assert a.branch_lines == b.branch_lines
            assert (a.theta_mean, a.pos_var, a.max_loglike) == (
                b.theta_mean, b.pos_var, b.max_loglike)

    by_id = {s.id: s for s in spans}

    def parent(s):
        return by_id[s.parent].name if s.parent else None

    names = {s.name for s in spans}
    assert {"soibean.inference", "soibean.prepare",
            "tree_mcmc.sweep", "tree_mcmc.noise", "tree_mcmc.launch",
            "tree_mcmc.records", "soibean.summaries", "soibean.chain",
            "summaries.moments", "summaries.ess", "summaries.patristic",
            "summaries.quantiles", "mapper.map_table", "mapper.submit",
            "mapper.collect", "mapper.finalize"} == names
    want_parent = {
        "soibean.inference": None,
        "mapper.map_table": None, "mapper.submit": "mapper.map_table",
        "mapper.collect": "mapper.map_table",
        "mapper.finalize": "mapper.map_table",
        "soibean.prepare": "soibean.inference",
        "tree_mcmc.sweep": "soibean.inference",
        "soibean.summaries": "soibean.inference",
        "tree_mcmc.noise": "tree_mcmc.sweep",
        "tree_mcmc.launch": "tree_mcmc.sweep",
        "tree_mcmc.records": "tree_mcmc.sweep",
        "soibean.chain": "soibean.summaries",
        "summaries.moments": "soibean.chain",
        "summaries.ess": "soibean.chain",
        "summaries.patristic": "soibean.chain",
        "summaries.quantiles": "soibean.chain"}
    for s in spans:
        assert parent(s) == want_parent[s.name], s
    count = {n: sum(s.name == n for s in spans) for n in names}
    rows = K * chains
    plan = tm.segment_plan(n_iter + 1, burnin, len(sb_world["graph"]
                                                    .path_names), rows, K)
    blocks = sum(len(range(i0 // tm.NOISE_BLOCK,
                           (i1 - 1) // tm.NOISE_BLOCK + 1))
                 for i0, i1, _h in plan)
    assert counters == {
        "tree_mcmc.row_steps": rows * (n_iter + 1),
        "tree_mcmc.noise_generators": rows * blocks,
        "tree_mcmc.record_bytes": rows * (n_iter + 1) * (
            K * (4 + 8 + 8) + 8),
        "mapper.reads": len(sb_world["reads"])}
    assert count["mapper.submit"] == 1  # a span a chunk
    assert count["tree_mcmc.sweep"] == count["tree_mcmc.records"] == 1
    assert count["tree_mcmc.noise"] == count["tree_mcmc.launch"] == len(plan)
    assert count["soibean.summaries"] == K
    assert count["soibean.chain"] == K * chains
    for n in ("moments", "ess", "patristic", "quantiles"):  # a chain source
        assert count[f"summaries.{n}"] == chains * K * (K + 1) // 2
    # the inference's children cover all of it but the host glue
    inf = [s for s in spans if s.name == "soibean.inference"][0]
    own = profiling.self_times(spans)
    assert 0 <= own[inf.id] < inf.end_ns - inf.start_ns


def test_soibean_writes_are_write_spans(sb_world, global_profiler,
                                        tmp_path):
    """With trace files, each chain's files and each k's diagnostics are
    `soibean.write` spans: inside `soibean.chain`, and beside the
    summaries under `soibean.inference`."""
    p = global_profiler
    table = BatchedMapper(sb_world["graph"], k=20, w=10, device="cpu"
                          ).map_reads_table(sb_world["reads"])
    stats = sb.analyse_table(sb_world["graph"], table)
    p.clear()
    res = runner.run_soibean_inference(
        parse_newick(sb_world["tree"]), stats, sb_world["graph"].path_names,
        sb.make_freqs(0.3, 0.2, 0.22, 0.28), str(tmp_path / "o_"),
        n_iter=60, burnin=20, chains=2, device="cpu")
    by_id = {s.id: s for s in p.records()}
    writes = [s for s in by_id.values() if s.name == "soibean.write"]
    parents = sorted(by_id[s.parent].name for s in writes)
    K = len(res)
    assert parents == ["soibean.chain"] * (2 * K) + [
        "soibean.inference"] * K
    assert os.path.exists(tmp_path / "o_Result10.mcmc")


def test_checkpointed_runner_records_its_segments(global_profiler,
                                                  tmp_path):
    p = global_profiler
    tree = parse_newick(world.random_tree(4, 1)[0])
    N, R, n_iter, burn = tree.n_nodes, 20, 90, 20
    rng = np.random.default_rng(3)
    path_map = rng.uniform(-30.0, -20.0, size=(R, N))
    counts25 = rng.integers(0, 4, size=(R, N, 25)).astype(np.float32)
    tm.run_tree_mcmc_checkpointed(
        tree, path_map, counts25, np.array([1, 2], np.int32),
        sb.make_freqs(0.3, 0.2, 0.22, 0.28), con=0.01, max_iter=n_iter,
        burn=burn, num_paths=N, init_loglike=-500.0, seed=4,
        checkpoint_path=str(tmp_path / "c"), checkpoint_every=40,
        device="cpu")
    plan = tm.segment_plan(n_iter + 1, burn, N, 1, 2, max_len=40)
    spans = p.records()
    by_id = {s.id: s for s in spans}
    (sweep,) = [s for s in spans if s.name == "tree_mcmc.sweep"]
    for name in ("tree_mcmc.noise", "tree_mcmc.launch", "tree_mcmc.records"):
        mine = [s for s in spans if s.name == name]
        assert len(mine) == len(plan), name
        assert all(by_id[s.parent] is sweep for s in mine)
    assert p.counters["tree_mcmc.row_steps"] == n_iter + 1
    assert p.counters["tree_mcmc.record_bytes"] == (n_iter + 1) * (
        2 * (4 + 8 + 8) + 8)


@pytest.mark.parametrize("chunk", [4096, 64])
def test_mapping_records_its_stages_and_chunks(sb_world, global_profiler,
                                               chunk):
    """One chunk on the caller's thread, or several streamed (collect and
    finalize on the mapper's worker thread)."""
    p = global_profiler
    reads = sb_world["reads"]
    t = BatchedMapper(sb_world["graph"], k=20, w=10,
                      device="cpu").map_reads_table(reads, chunk=chunk)
    assert t.n == len(reads)
    chunks = 1 if len(reads) <= chunk * 3 // 2 else -(-len(reads) // chunk)
    spans = p.records()
    by_id = {s.id: s for s in spans}
    count = {n: sum(s.name == n for s in spans)
             for n in ("mapper.submit", "mapper.collect", "mapper.finalize",
                       "mapper.map_table")}
    assert count == {"mapper.submit": chunks, "mapper.collect": chunks,
                     "mapper.finalize": chunks, "mapper.map_table": 1}
    assert p.counters == {"mapper.reads": len(reads)}
    for s in spans:
        if s.name == "mapper.submit" or chunks == 1:
            if s.name != "mapper.map_table":
                assert by_id[s.parent].name == "mapper.map_table"
    st = profiling.stage_stats(spans)
    assert st["mapper.submit"].calls == chunks
    assert all(st[f"mapper.{k}"].seconds > 0
               for k in ("submit", "collect", "finalize"))
