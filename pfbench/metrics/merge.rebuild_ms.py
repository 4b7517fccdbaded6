"""The merge's text rebuild on the host: each prefix's characters worked
out again from its ``.dict`` and ``.parse`` (``parallel/merge.
reconstruct_text``: an arange, a searchsorted and gathers over the
shard's length), and the texts joined (span ``merge.rebuild``)."""

from pfbench.build_spans import with_spans
from pfbench.metrics import mean_ms


def read(ctx):
    return mean_ms(with_spans(ctx, "merge.rebuild"), "merge.rebuild")
