"""Host milliseconds a sample spends on the chains' summaries: the
program's `soibean.summaries` spans (each k's process_chain calls and
the gather of their summaries), less any `soibean.write` span inside
them (trace files; the cell writes none)."""
from perfbench import program_spans


def read(ctx):
    got = program_spans.in_samples(ctx)
    if got is None:
        return None
    n, spans = got
    outer = [s for s in spans if s.name == "soibean.summaries"]
    if not outer:
        return None
    ns = sum(s.end_ns - s.start_ns for s in outer)
    ns -= sum(w.end_ns - w.start_ns for w in spans
              if w.name == "soibean.write"
              and any(o.tid == w.tid and o.start_ns <= w.start_ns
                      and w.end_ns <= o.end_ns for o in outer))
    return ns / 1e6 / n
