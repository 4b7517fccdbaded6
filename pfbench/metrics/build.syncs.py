"""The host reads of device values a build (``info["counts"]["syncs"]``):
J2's sizes, a scalar or two each doubling round, the checksum and the
downloads. Syncs inside torch ops are not counted."""


def read(ctx):
    counts = [b["info"].get("counts", {}).get("syncs") for b in ctx["builds"]]
    if not counts or None in counts:
        return None
    return sum(counts) / len(counts)
