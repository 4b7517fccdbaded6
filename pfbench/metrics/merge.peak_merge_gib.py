"""The card's peak allocation as the merge's dedup ends (``info``
peak_merge, torch.cuda.max_memory_allocated), in GiB. The least over the
window's builds: the harness resets the peak as the window starts, so the
first build's figure is the merge's own and later builds' hold the
assembly before them."""


def read(ctx):
    got = [b["info"].get("peak_merge") for b in ctx["builds"]]
    return None if not got or None in got else min(got) / float(1 << 30)
