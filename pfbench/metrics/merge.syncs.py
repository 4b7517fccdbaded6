"""The host reads of device values a build of the merge cell, over both
commands (``info["counts"]["syncs"]``, merge_pfp's and pfbwt_f
--pfbwt-only's summed): the cut positions, the dedup's ranks, the
parse-BWT's four outputs, a scalar or two each doubling round, the run
count and the outputs' download. Syncs inside torch ops are not
counted."""


def read(ctx):
    counts = [b["info"].get("counts", {}).get("syncs") for b in ctx["builds"]]
    if not counts or None in counts:
        return None
    return sum(counts) / len(counts)
