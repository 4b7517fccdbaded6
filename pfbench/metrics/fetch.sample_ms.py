"""The run-length sampling on the host a build: the run starts of the BWT
and the SA samples at them (``info`` sample_s, span ``fetch.sample``)."""

from pfbench.metrics import mean_ms


def read(ctx):
    return mean_ms(ctx, "sample_s")
