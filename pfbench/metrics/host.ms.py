"""Host I/O and stream a build: the FASTA read (the harness's span) and
the fused build's host stages, build_stream (stream_s), the input check
and padding (host_s), and the download with the run sampling (fetch_s)."""

from pfbench.metrics import mean_ms


def read(ctx):
    return mean_ms(ctx, "stream_s", "host_s", "fetch_s", spans=("read_fasta",))
