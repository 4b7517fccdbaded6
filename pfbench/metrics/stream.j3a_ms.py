"""J3a of the streamed build: dictionary doubling, parse BWT, emission
state and chunk table (``info`` j3a_s, span ``j3a``, ending in the chunk
table's read)."""

from pfbench.metrics import mean_ms


def read(ctx):
    return mean_ms(ctx, "j3a_s")
