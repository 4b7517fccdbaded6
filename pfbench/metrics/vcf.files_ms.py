"""vcf_to_bwt's file work a build: the VCF read (read_s), the ``.fai``
(fai_s), the merged ``.mps`` (mps_s) and the ``.bwt/.sa/.ssa/.esa``
writes (write_s)."""

from pfbench.metrics import mean_ms


def read(ctx):
    return mean_ms(ctx, "read_s", "fai_s", "mps_s", "write_s")
