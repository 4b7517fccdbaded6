"""The merge's parse of the rebuilt text: the cut scan with the codes'
upload, K1 and the cut positions' download (span ``merge.scan``), and
the dictionary dedup and ranking on the device with the ranks' download
(``merge.dedup``)."""

from pfbench.build_spans import with_spans
from pfbench.metrics import mean_ms

SPANS = ("merge.scan", "merge.dedup")


def read(ctx):
    return mean_ms(with_spans(ctx, *SPANS), *SPANS)
