"""The merge cell's rate in the traced run: input bases of every build of
the window (10^6) over the window's seconds, as ``staged.build_mbps``. A
build is the merge of the per-haplotype parses and stage 3 from the
merged files."""


def read(ctx):
    if not ctx["builds"] or not ctx.get("window_s"):
        return None
    return ctx["bases"] * len(ctx["builds"]) / ctx["window_s"] / 1e6
