"""The staged build's dictionary dedup and ranking on the device, with
T', the phrases' metadata and the ranks' download (span
``staged.dedup``)."""

from pfbench.build_spans import with_spans
from pfbench.metrics import mean_ms


def read(ctx):
    return mean_ms(with_spans(ctx, "staged.dedup"), "staged.dedup")
