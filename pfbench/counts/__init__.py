"""The work each roofline divides by, from the input's sizes alone, and
the card's published peaks."""

# NVIDIA H100 SXM data sheet: HBM3 bandwidth at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
