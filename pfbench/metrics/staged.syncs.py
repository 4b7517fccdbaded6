"""The host reads of device values a staged build
(``info["counts"]["syncs"]``): the cut positions, the dedup's ranks,
the parse-BWT's four outputs, a scalar or two each doubling round, the
run count and the outputs' download. Syncs inside torch ops are not
counted."""


def read(ctx):
    counts = [b["info"].get("counts", {}).get("syncs") for b in ctx["builds"]]
    if not counts or None in counts:
        return None
    return sum(counts) / len(counts)
