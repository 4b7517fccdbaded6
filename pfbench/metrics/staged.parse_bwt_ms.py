"""Stage 2 of the staged build: the parse's suffix sort, ``.bwlast``,
``.ilist`` and ``.bwsai`` on the device and their download (span
``staged.parse_bwt``)."""

from pfbench.build_spans import with_spans
from pfbench.metrics import mean_ms


def read(ctx):
    return mean_ms(with_spans(ctx, "staged.parse_bwt"), "staged.parse_bwt")
