"""Host I/O and stream of a streamed build: the FASTA read (the harness's
span ``read_fasta``), build_stream (``info`` stream_s, span ``stream``)
and the input check and padding (span ``host_prep``)."""

from pfbench.build_spans import with_spans
from pfbench.metrics import mean_ms


def read(ctx):
    return mean_ms(with_spans(ctx, "host_prep"), "stream_s", "host_prep",
                   spans=("read_fasta",))
