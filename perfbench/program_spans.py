"""The program's own spans, for the per-layer readers.

`vgan_tpu_torch.utils.profiling.PROFILER` records spans (name, start and
end on `time.time_ns()`, the clock of the profiler's trace and of the
harness's spans) while a torch.profiler session runs, so a traced window
holds the program's spans and the untraced runs none. The readers keep
the spans that started inside a harness `sample` span. A program without
that tracer, or a window in which it recorded nothing, gives None, and
so does every reader built on it.
"""


def in_samples(ctx):
    """(the window's samples, [program spans that started inside one]),
    or None."""
    try:
        from vgan_tpu_torch.utils import profiling
    except ImportError:
        return None
    records = getattr(getattr(profiling, "PROFILER", None), "records", None)
    if records is None:
        return None
    samples = [(a, b) for n, a, b in ctx.spans if n == "sample"]
    spans = [s for s in records()
             if any(a <= s.start_ns < b for a, b in samples)]
    if not samples or not spans:
        return None
    return len(samples), spans


def named(ctx, name):
    """(the window's samples, [its program spans called `name`]), or
    None when it has none."""
    got = in_samples(ctx)
    if got is None:
        return None
    n, spans = got
    spans = [s for s in spans if s.name == name]
    return (n, spans) if spans else None


def ms_per_sample(ctx, name):
    """Host milliseconds a sample spends in the spans called `name`."""
    got = named(ctx, name)
    if got is None:
        return None
    n, spans = got
    return sum(s.end_ns - s.start_ns for s in spans) / 1e6 / n
