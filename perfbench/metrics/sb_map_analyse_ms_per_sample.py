"""Host milliseconds a sample spends in BatchedMapper.map_reads_table and
soibean.analyse_table: the harness's spans around the two calls, each
closed after a synchronize."""


def read(ctx):
    ms = sum(b - a for n, a, b in ctx.spans
             if n in ("sample.map", "sample.analyse")) / 1e6
    if ctx.samples <= 0 or ms <= 0:
        return None
    return ms / ctx.samples
