"""The card's peak allocation as the streamed build's J2 ends (``info``
peak_j2, torch.cuda.max_memory_allocated), in GiB. The least over the
window's builds: the harness resets the peak as the window starts, so the
first build's figure is J2's own and later builds' hold the stages
before them."""


def read(ctx):
    got = [b["info"].get("peak_j2") for b in ctx["builds"]]
    return None if not got or None in got else min(got) / float(1 << 30)
