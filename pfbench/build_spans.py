"""The program's own spans of each build (``info["spans"]``, the
``(name, parent, t0, t1)`` tuples that ``pfbwtf_tpu_torch.utils.timer``
hands out) summed by name, for the per-layer readers that need a span
with no ``info`` key of its own."""


def span_seconds(info: dict, name: str):
    """Seconds of every span ``name`` of one build, summed; None where the
    build has none."""
    durs = [t1 - t0 for n, _, t0, t1 in info.get("spans", ()) if n == name]
    return sum(durs) if durs else None


def with_spans(ctx: dict, *names) -> dict:
    """``ctx`` with each build's ``info`` also holding, under each span name
    of ``names`` the build has, its ``span_seconds``: what
    ``pfbench.metrics.mean_ms`` reads."""
    builds = []
    for b in ctx["builds"]:
        got = {n: span_seconds(b["info"], n) for n in names}
        builds.append({**b, "info": {
            **b["info"], **{n: s for n, s in got.items() if s is not None}}})
    return {**ctx, "builds": builds}
