"""J3e of the streamed build less its file writes and run sampling: the
chunk programs' launches, the waits for each chunk's download (span
``j3e.fetch``) and the checksum read (``info`` chunks_s, span ``j3e``,
less spans ``j3e.write`` and ``j3e.sample``)."""

from pfbench.build_spans import with_spans
from pfbench.metrics import mean_ms


def read(ctx):
    c = with_spans(ctx, "j3e.write", "j3e.sample")
    got = [mean_ms(c, k) for k in ("chunks_s", "j3e.write", "j3e.sample")]
    return None if None in got else got[0] - got[1] - got[2]
