"""K1's share of its roofline: the least time its bytes take at the card's
published bandwidth (pfbench.counts.k1), over its mean device time a
launch in the traced window."""

from pfbench.counts import k1


def read(ctx):
    hits = [v for name, v in ctx["trace"].get("ops", {}).items()
            if k1.KERNEL in name]
    count = sum(c for c, _ in hits)
    if not count:
        return None
    seconds = sum(s for _, s in hits) / count
    return 100.0 * k1.least_seconds(ctx["text_n"]) / seconds
