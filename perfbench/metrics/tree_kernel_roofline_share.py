"""Share (%) of tree_mcmc_segment_kernel's device time that the card's
least time for the same steps would take: perfbench/bounds.py's tree
bound from each sample's rows, sources, reads, paths and walk lengths,
over the kernel's measured time."""
from perfbench import bounds

KERNEL = "tree_mcmc_segment_kernel"


def read(ctx):
    s_kernel = sum(d for n, _s, d in ctx.events if KERNEL in n) / 1e9
    if s_kernel <= 0:
        return None
    least = 0.0
    for s in ctx.info["shapes"]:
        if not s["rows"]:
            continue
        burn_hops = bounds.burn_walk_hops(s["paths"])
        for steps, hops in ((s["burn_steps"], burn_hops),
                            (s["iterations"] - s["burn_steps"],
                             bounds.POST_BURN_HOPS)):
            least += bounds.tree_bound_s(s["rows"], s["kmax"], s["active"],
                                         steps, s["reads"], s["paths"],
                                         s["count_bytes"], hops)
    if least <= 0:
        return None
    return 100.0 * least / s_kernel
