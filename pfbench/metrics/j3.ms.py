"""J3, the assembly on the card: dictionary doubling, parse BWT, emission
and final sort (``info`` j3_s, ending in the checksum read)."""

from pfbench.metrics import mean_ms


def read(ctx):
    return mean_ms(ctx, "j3_s")
