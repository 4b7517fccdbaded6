"""The download a build: the copies of the BWT and the SA from the card to
host memory (``info`` download_s, span ``fetch.download``)."""

from pfbench.metrics import mean_ms


def read(ctx):
    return mean_ms(ctx, "download_s")
