"""CPU tests of the soibean cell's readers of the sampler, the summaries
and analyse_GAM: the four that read the program's own spans (perfbench/program_spans.py and
the readers on it) and sb_analyse_ms_per_sample, which reads the
harness's, on a synthetic window and synthetic program records.

    python -m pytest perfbench/tests -q
"""
import os
import sys
from types import SimpleNamespace

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from perfbench import program_spans, run  # noqa: E402
from vgan_tpu_torch.utils import profiling  # noqa: E402

READERS = ("sb_summaries_ms_per_sample", "sb_patristic_ms_per_sample",
           "sb_noise_wait_ms_per_sample", "sb_sweep_idle_ms_per_sample")
MS = 1_000_000  # ns


def _span(i, parent, name, a_ms, b_ms, tid=1):
    return profiling.Span(i, parent, tid, name, a_ms * MS, b_ms * MS)


# two samples, [0, 100) and [200, 300) ms; spans before, between and
# after them (other runs of the process) must not count
RECORDS = [
    _span(1, 0, "tree_mcmc.noise", -50, -40),        # before the window
    _span(3, 0, "soibean.inference", 20, 95),
    _span(4, 3, "tree_mcmc.sweep", 20, 40),
    _span(5, 4, "tree_mcmc.noise", 21, 23),
    _span(6, 4, "tree_mcmc.noise", 30, 31),
    _span(7, 3, "soibean.summaries", 40, 90),
    _span(8, 7, "summaries.patristic", 45, 80),
    _span(9, 7, "soibean.write", 82, 88),
    _span(10, 0, "tree_mcmc.noise", 150, 160),      # between samples
    _span(12, 0, "tree_mcmc.sweep", 230, 250),
    _span(13, 12, "tree_mcmc.noise", 231, 234),
    _span(14, 0, "soibean.summaries", 250, 280),
    _span(15, 14, "summaries.patristic", 255, 265),
    _span(16, 0, "soibean.write", 260, 262, tid=2),  # another thread
]
# the card: busy [25, 35) and [38, 60) ms in the first sweep (the
# second overlaps the sweep's end only in part), [228, 232) in the
# second (overlaps its start in part)
EVENTS = [("k", 25 * MS, 10 * MS), ("k", 38 * MS, 22 * MS),
          ("k", 228 * MS, 4 * MS)]


def _ctx(events=EVENTS):
    return SimpleNamespace(
        spans=[("sample", 0, 100 * MS), ("sample.map", 0, 5 * MS),
               ("sample.analyse", 5 * MS, 15 * MS),
               ("sample", 200 * MS, 300 * MS),
               ("sample.analyse", 205 * MS, 225 * MS)],
        events=events, samples=2)


@pytest.fixture
def records(monkeypatch):
    holder = SimpleNamespace(records=lambda: list(RECORDS))
    monkeypatch.setattr(profiling, "PROFILER", holder)
    return holder


def test_each_reader_reads_its_spans(records):
    got = {n: run.reader(ROOT, n)(_ctx()) for n in READERS}
    assert got["sb_noise_wait_ms_per_sample"] == pytest.approx(
        (2 + 1 + 3) / 2)
    assert got["sb_patristic_ms_per_sample"] == pytest.approx((35 + 10) / 2)
    # the write inside the first summaries span is left out; the one on
    # another thread is not inside a summaries span
    assert got["sb_summaries_ms_per_sample"] == pytest.approx(
        (50 - 6 + 30) / 2)
    # sweep [20, 40): busy [25, 35) and [38, 40) -> idle 8; sweep
    # [230, 250): busy [230, 232) -> idle 18
    assert got["sb_sweep_idle_ms_per_sample"] == pytest.approx((8 + 18) / 2)


def test_busy_intervals_that_overlap_a_sweep_in_part_count_their_part(
        records):
    # one interval that covers the whole first sweep and more
    ev = [("k", 10 * MS, 40 * MS)]
    v = run.reader(ROOT, "sb_sweep_idle_ms_per_sample")(_ctx(ev))
    assert v == pytest.approx((0 + 20) / 2)


def test_no_spans_in_the_window_reads_none(monkeypatch):
    outside = [s for s in RECORDS if s.start_ns < 0 or 100 * MS <= s.start_ns
               < 200 * MS]
    monkeypatch.setattr(profiling, "PROFILER",
                        SimpleNamespace(records=lambda: outside))
    for n in READERS:
        assert run.reader(ROOT, n)(_ctx()) is None, n
    monkeypatch.setattr(profiling, "PROFILER",
                        SimpleNamespace(records=lambda: []))
    for n in READERS:
        assert run.reader(ROOT, n)(_ctx()) is None, n


def test_a_program_without_the_tracer_reads_none(monkeypatch):
    """The parent commit's PROFILER has stages and no records()."""
    monkeypatch.setattr(profiling, "PROFILER",
                        SimpleNamespace(enabled=False, stages={}))
    for n in READERS:
        assert run.reader(ROOT, n)(_ctx()) is None, n


def test_a_name_with_no_span_reads_none(records):
    assert program_spans.ms_per_sample(_ctx(), "mapper.submit") is None
    assert program_spans.ms_per_sample(_ctx(), "tree_mcmc.noise") == \
        pytest.approx(3.0)


def test_sweep_idle_needs_the_trace(records):
    assert run.reader(ROOT, "sb_sweep_idle_ms_per_sample")(_ctx([])) is None


def test_analyse_reads_the_harness_spans_without_the_tracer(monkeypatch):
    """sb_analyse_ms_per_sample times analyse_table by the harness's own
    `sample.analyse` spans, so a program without the tracer reads it
    too; a window without them reads None."""
    monkeypatch.setattr(profiling, "PROFILER",
                        SimpleNamespace(enabled=False, stages={}))
    read = run.reader(ROOT, "sb_analyse_ms_per_sample")
    assert read(_ctx()) == pytest.approx((10 + 20) / 2)
    ctx = _ctx()
    ctx.spans = [s for s in ctx.spans if s[0] != "sample.analyse"]
    assert read(ctx) is None
