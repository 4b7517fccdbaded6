"""One reader per per-layer metric, ``metrics/<metric name>.py``, found by
the name in BENCHMARK.json. ``read(ctx)`` returns the metric's value, or
None where the run has nothing to read (the harness then leaves the metric
out). ``ctx`` holds:

- ``builds``: one dict per build of the window, ``info`` (the program's own
  stage seconds and sizes) and ``spans`` (the harness's host-clock seconds
  by span name);
- ``trace``: trace.summarize's reading of the profiler run, or {};
- ``text_n``, ``bases``: the input's sizes, from the reference;
- ``window_s``: the window's host-clock seconds.
"""


def mean_ms(ctx, *keys, spans=()):
    """The mean per build of the sum of ``info`` keys and span seconds,
    in milliseconds; None where a build lacks one."""
    total = 0.0
    for b in ctx["builds"]:
        if any(k not in b["info"] for k in keys) or any(
                s not in b["spans"] for s in spans):
            return None
        total += sum(b["info"][k] for k in keys)
        total += sum(b["spans"][s] for s in spans)
    return 1000.0 * total / len(ctx["builds"]) if ctx["builds"] else None
