"""Stage 1 of the staged build up to the dedup: the FASTA read (span
``staged.read``), the host stream and its code check (``staged.stream``)
and the cut scan with the cut positions' download and the phrase bounds
(``staged.scan``)."""

from pfbench.build_spans import with_spans
from pfbench.metrics import mean_ms

SPANS = ("staged.read", "staged.stream", "staged.scan")


def read(ctx):
    return mean_ms(with_spans(ctx, *SPANS), *SPANS)
