"""The streamed build's output a build: each chunk's ``.bwt`` and ``.sa``
writes (span ``j3e.write``), the run samples' concatenation and their
``.ssa/.esa`` writes (span ``files``), and the flush of the four files
to the disk (the harness's span ``fsync``)."""

from pfbench.build_spans import with_spans
from pfbench.metrics import mean_ms


def read(ctx):
    return mean_ms(with_spans(ctx, "j3e.write", "files"), "j3e.write",
                   "files", spans=("fsync",))
