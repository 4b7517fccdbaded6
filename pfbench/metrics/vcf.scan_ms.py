"""vcf_to_bwt's haplotype scans on the host (``info`` scan_s)."""

from pfbench.metrics import mean_ms


def read(ctx):
    return mean_ms(ctx, "scan_s")
