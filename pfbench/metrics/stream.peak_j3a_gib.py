"""The card's peak allocation as the streamed build's J3a ends (``info``
peak_j3a), in GiB, the least over the window's builds as for
``stream.peak_j2_gib``: where it reads above that, J3a set the peak so
far; where it reads ``peak_dev_gib``, the chunks did not raise it."""


def read(ctx):
    got = [b["info"].get("peak_j3a") for b in ctx["builds"]]
    return None if not got or None in got else min(got) / float(1 << 30)
