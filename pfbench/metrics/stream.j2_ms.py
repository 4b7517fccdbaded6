"""J2 of the streamed build: upload, cut scan, dictionary and parse
(``info`` j2_s, span ``j2``, ending in the host read of J2's sizes)."""

from pfbench.metrics import mean_ms


def read(ctx):
    return mean_ms(ctx, "j2_s")
