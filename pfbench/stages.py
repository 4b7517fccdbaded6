"""The program's stage ranges in a traced window: the ``pfbwt.<name>``
user annotations that ``pfbwtf_tpu_torch.utils.timer.span`` opens while a
profiler records.  These are the pieces that ``trace.summarize`` lacks to
read them, for it to call with what it has already worked out from the
trace: the window, the busy intervals, the idle gaps, the harness spans
and the outermost ops of the window's thread.  It does not call them yet
(PERF.md §7).

- ``ranges(xs, tid, w0, w1)``: the program's ranges on the window's
  thread, clipped to the window, as (start, end, span name);
- ``stages(ranges, busy)``: for each span name, [wall seconds, device-busy
  seconds inside it, count];
- ``idle_by_label(gaps, spans, cpu, ranges)``: the idle seconds by
  trace.summarize's label ``<harness span>:<op>``, where each part of a
  gap that a program range covers reads
  ``<harness span>/<innermost span>:<op>`` (``build/fetch.sample:host``).
  With no program range it is trace.summarize's reading.
"""

from collections import defaultdict

from . import trace

PREFIX = "pfbwt."


def ranges(xs, tid, w0: float, w1: float):
    """The ``pfbwt.*`` ranges of the events ``xs`` on thread ``tid``,
    clipped to [w0, w1), as (start, end, span name)."""
    out = []
    for e in xs:
        if (e.get("cat") == "user_annotation" and e.get("tid") == tid
                and e["name"].startswith(PREFIX)):
            s, t = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
            if t > s:
                out.append((s, t, e["name"][len(PREFIX):]))
    return out


def _innermost(ranges):
    """Nested ranges (start, end, name) as parts that do not overlap,
    each named by the innermost range over it, by start."""
    out, stack, t = [], [], None

    def close_until(x):
        nonlocal t
        while stack and stack[-1][0] <= x:
            end, name = stack.pop()
            if end > t:
                out.append((t, end, name))
                t = end

    for s, e, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        close_until(s)
        if stack and s > t:
            out.append((t, s, stack[-1][1]))
        stack.append((e, name))
        t = s
    close_until(float("inf"))
    return out


def stages(ranges, busy) -> dict:
    """[wall seconds, device-busy seconds, count] by span name; ``busy``
    the merged device intervals, sorted."""
    named = [(s, e, "busy") for s, e in busy]
    starts = [b[0] for b in busy]
    out = defaultdict(lambda: [0.0, 0.0, 0])
    for s, e, name in ranges:
        st = out[name]
        st[0] += (e - s) / 1e6
        st[1] += sum(d for on, d in trace._overlaps(named, starts, s, e)
                     if on) / 1e6
        st[2] += 1
    return dict(sorted(out.items()))


def idle_by_label(gaps, spans, cpu, ranges) -> dict:
    """Idle seconds by label; ``spans`` and ``cpu`` the outermost harness
    spans and host ops (start, end, name), sorted."""
    parts = _innermost(ranges)
    span_starts = [sp[0] for sp in spans]
    part_starts = [p[0] for p in parts]
    cpu_starts = [c[0] for c in cpu]
    idle = defaultdict(float)
    for s, e in gaps:
        t = s
        for span, d in trace._overlaps(spans, span_starts, s, e):
            head = span or "window"
            for stage, d2 in trace._overlaps(parts, part_starts, t, t + d):
                label = f"{head}/{stage}" if stage else head
                for op, d3 in trace._overlaps(cpu, cpu_starts, t, t + d2):
                    idle[f"{label}:{op or 'host'}"] += d3 / 1e6
                t += d2
    return dict(idle)
