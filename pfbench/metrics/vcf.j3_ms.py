"""J3 of the fused build inside vcf_to_bwt (``info`` j3_s, span ``j3``,
ending in the checksum read)."""

from pfbench.metrics import mean_ms


def read(ctx):
    return mean_ms(ctx, "j3_s")
