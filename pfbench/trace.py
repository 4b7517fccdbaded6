"""The traced window: one ``torch.profiler`` run (CPU and CUDA) over the
whole window, read back from its Chrome trace.

Device time is the union of the kernel, memcpy and memset intervals that
fall inside the harness's ``pfbench.window`` range. An idle gap is time in
that range with no device interval. Each part of a gap is labelled by the
harness span (``pfbench.<name>``; they do not nest) and the outermost aten
op that the host thread was in, or ``host`` where it was in no op (Python
and NumPy work, file reads); the parts add up by label.
"""

import bisect
import json
import os
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "pfbench.window"


def profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _outermost(events):
    """Events (start, end, name) not inside an earlier one, by start."""
    out, end = [], float("-inf")
    for s, e, name in sorted(events):
        if s >= end:
            out.append((s, e, name))
            end = e
    return out


def _overlaps(events, starts, s, e):
    """(name, seconds) of each part of [s, e) that an event of ``events``
    (sorted, not nested) covers, and (None, seconds) for the rest."""
    out, t = [], s
    j = max(bisect.bisect_right(starts, s) - 1, 0)
    while j < len(events) and events[j][0] < e:
        a, b = max(events[j][0], t), min(events[j][1], e)
        if b > a:
            if a > t:
                out.append((None, a - t))
            out.append((events[j][2], b - a))
            t = b
        j += 1
    if e > t:
        out.append((None, e - t))
    return out


def summarize(prof, workdir: str, top: int = 10) -> dict:
    """busy_s, window_s, per-kernel (count, seconds), and the breakdown."""
    path = os.path.join(workdir, "trace.json")
    prof.export_chrome_trace(path)
    size = os.path.getsize(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("cat") == "user_annotation"
           and e.get("name") == WINDOW]
    if not win:
        return {}
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    tid = win[0].get("tid")
    ops = defaultdict(lambda: [0, 0.0])
    dev = []
    for e in xs:
        if e.get("cat") in DEVICE_CATS:
            s, t = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
            if t > s:
                dev.append((s, t))
                ops[e["name"]][0] += 1
                ops[e["name"]][1] += (t - s) / 1e6
    busy = _union(dev)
    spans = _outermost([(e["ts"], e["ts"] + e["dur"],
                         e["name"][len("pfbench."):])
                        for e in xs if e.get("cat") == "user_annotation"
                        and e["name"].startswith("pfbench.")
                        and e["name"] != WINDOW])
    span_starts = [sp[0] for sp in spans]
    cpu = _outermost([(e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
                      if e.get("cat") == "cpu_op" and e.get("tid") == tid])
    cpu_starts = [c[0] for c in cpu]
    gaps, t = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    idle = defaultdict(float)
    for s, e in gaps:
        t = s
        for span, d in _overlaps(spans, span_starts, s, e):
            for op, d2 in _overlaps(cpu, cpu_starts, t, t + d):
                idle[f"{span or 'window'}:{op or 'host'}"] += d2 / 1e6
            t += d
    busy_s = sum(e - s for s, e in busy) / 1e6
    by_time = sorted(ops.items(), key=lambda kv: -kv[1][1])
    return {
        "trace_bytes": size,
        "busy_s": busy_s,
        "window_s": (w1 - w0) / 1e6,
        "ops": {name: tuple(v) for name, v in ops.items()},
        "breakdown": {
            "device_ops": [[name[:160], v[1]] for name, v in by_time[:top]],
            "idle_gaps": [[k, v] for k, v in sorted(
                idle.items(), key=lambda kv: -kv[1])[:top]],
        },
    }
