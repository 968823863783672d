"""Host milliseconds a sample spends in soibean's analyse_GAM
(`soibean.analyse_table`): the harness's `sample.analyse` spans, closed
after a synchronize (the analysis queues no work on the card)."""


def read(ctx):
    ms = sum(b - a for n, a, b in ctx.spans if n == "sample.analyse") / 1e6
    if ctx.samples <= 0 or ms <= 0:
        return None
    return ms / ctx.samples
