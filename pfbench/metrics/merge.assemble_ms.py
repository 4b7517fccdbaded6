"""The merge cell's device assembly: the merged parse's BWT, ``.bwlast``,
``.ilist`` and ``.bwsai`` (span ``staged.parse_bwt``, in merge_pfp's
``--parse-bwt``) and stage 3 from the files read back (span
``staged.assemble``, with its ``fetch``), the staged build's own code."""

from pfbench.build_spans import with_spans
from pfbench.metrics import mean_ms

SPANS = ("staged.parse_bwt", "staged.assemble")


def read(ctx):
    return mean_ms(with_spans(ctx, *SPANS), *SPANS)
