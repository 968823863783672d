"""Milliseconds a sample in which the host was inside the sampler's
`tree_mcmc.sweep` span while the card ran nothing: each sweep span less
the card's busy intervals inside it, from the profiler's timeline on
the same clock."""
from perfbench import program_spans, run


def read(ctx):
    got = program_spans.named(ctx, "tree_mcmc.sweep")
    if got is None or not ctx.events:
        return None
    n, sweeps = got
    idle = 0
    for s in sweeps:
        busy = run.busy_intervals(ctx.events, s.start_ns, s.end_ns)
        idle += s.end_ns - s.start_ns - sum(b - a for a, b in busy)
    return idle / 1e6 / n
