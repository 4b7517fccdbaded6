"""Stage 3 of the staged build: the assembly on the device from the
files read back, with its run sampling and download (span
``staged.assemble``, children ``fetch``, ``fetch.sample``,
``fetch.download``)."""

from pfbench.build_spans import with_spans
from pfbench.metrics import mean_ms


def read(ctx):
    return mean_ms(with_spans(ctx, "staged.assemble"), "staged.assemble")
