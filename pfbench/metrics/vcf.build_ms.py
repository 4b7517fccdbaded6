"""The fused build inside vcf_to_bwt, records to BWT and SA in host memory
(``info`` build_s)."""

from pfbench.metrics import mean_ms


def read(ctx):
    return mean_ms(ctx, "build_s")
