"""The run-length sampling of the streamed build on the host, chunk by
chunk, across chunk boundaries (span ``j3e.sample``)."""

from pfbench.build_spans import with_spans
from pfbench.metrics import mean_ms


def read(ctx):
    return mean_ms(with_spans(ctx, "j3e.sample"), "j3e.sample")
