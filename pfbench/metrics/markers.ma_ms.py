"""The SA to marker array stage: the .mps index, the permute on the card
and the .ma write (``info`` ma_s)."""

from pfbench.metrics import mean_ms


def read(ctx):
    return mean_ms(ctx, "ma_s")
