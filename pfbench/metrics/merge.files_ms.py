"""The merge cell's files a build: the merged parse's writes (span
``merge.save_parse``: .dict .occ .parse .n .docs), the parse-BWT's
(``staged.save_parse_bwt``: .bwlast .ilist .bwsai), stage 3's read back
(``staged.load``), the outputs' writes (``staged.write``: .bwt .sa .ssa
.esa) and the flush of the twelve files to the disk (the harness's span
``fsync``)."""

from pfbench.build_spans import with_spans
from pfbench.metrics import mean_ms

SPANS = ("merge.save_parse", "staged.save_parse_bwt", "staged.load",
         "staged.write")


def read(ctx):
    return mean_ms(with_spans(ctx, *SPANS), *SPANS, spans=("fsync",))
