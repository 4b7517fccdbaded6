"""The bytes a build reads back from the card, in MB (10^6 bytes):
``info["counts"]["d2h_bytes"]``, the downloads of the BWT and the SA and
the scalars read between stages. Copies inside torch ops are not
counted."""


def read(ctx):
    counts = [b["info"].get("counts", {}).get("d2h_bytes")
              for b in ctx["builds"]]
    if not counts or None in counts:
        return None
    return sum(counts) / len(counts) / 1e6
