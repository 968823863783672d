"""Host milliseconds a sample spends inside the sampler's noise draws
(`tree_mcmc.draw_noise`): the program's `tree_mcmc.noise` spans. Most of
it is the wait for a slot in the card's launch queue, full behind the
running segment kernel, so it moves with `tree_kernel_us_per_step`; the
draws' own host work is the smaller part. What the draws cost the card
is in `sb_sweep_idle_ms_per_sample`."""
from perfbench import program_spans


def read(ctx):
    return program_spans.ms_per_sample(ctx, "tree_mcmc.noise")
