"""Host milliseconds a sample spends on the chains' patristic-distance
series and their ESS: the program's `summaries.patristic` spans."""
from perfbench import program_spans


def read(ctx):
    return program_spans.ms_per_sample(ctx, "summaries.patristic")
