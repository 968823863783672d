"""Device microseconds of tree_mcmc_segment_kernel a step of the k-sweep
batch (all its rows at once), over the steps the window's samples ran."""

KERNEL = "tree_mcmc_segment_kernel"


def read(ctx):
    us = sum(d for n, _s, d in ctx.events if KERNEL in n) / 1e3
    steps = sum(s["iterations"] for s in ctx.info["shapes"])
    if us <= 0 or steps <= 0:
        return None
    return us / steps
