"""The reading of a profiler trace, on a made-up Chrome trace."""

import json

import pytest

from pfbench import trace
from pfbench.counts import k1


class _Prof:
    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def _x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


EVENTS = [
    _x("user_annotation", trace.WINDOW, 0, 1000),
    _x("user_annotation", "pfbench.read_fasta", 0, 100),
    _x("user_annotation", "pfbench.build", 100, 900),
    _x("cpu_op", "aten::sort", 200, 300),
    _x("cpu_op", "aten::empty", 210, 5),        # inside sort: not outermost
    _x("cpu_op", "aten::cumsum", 50, 10, tid=2),  # another thread
    _x("kernel", "void cut_scan_kernel<10>(...)", 150, 100, tid=7),
    _x("kernel", "sort_kernel", 300, 150, tid=7),
    _x("gpu_memcpy", "Memcpy DtoH", 420, 80, tid=7),   # overlaps the sort
    _x("kernel", "late", 990, 50, tid=7),        # cut at the window's end
]


def test_summary_of_a_made_up_trace(tmp_path):
    s = trace.summarize(_Prof(EVENTS), str(tmp_path))
    # busy: [150, 250) + [300, 500) + [990, 1000)
    assert s["busy_s"] == pytest.approx(310e-6)
    assert s["window_s"] == pytest.approx(1000e-6)
    assert s["ops"]["void cut_scan_kernel<10>(...)"] == (1, pytest.approx(1e-4))
    gaps = dict(map(tuple, s["breakdown"]["idle_gaps"]))
    # idle: [0, 150) read 100 + build 50; [250, 300) in sort; [500, 990)
    assert gaps == pytest.approx({"read_fasta:host": 100e-6,
                                  "build:host": 50e-6 + 490e-6,
                                  "build:aten::sort": 50e-6})
    assert s["breakdown"]["device_ops"][0][0] == "sort_kernel"
    assert not list(tmp_path.iterdir())  # the exported trace is removed


def test_no_window_reads_nothing(tmp_path):
    assert trace.summarize(_Prof(EVENTS[1:]), str(tmp_path)) == {}


def test_k1_reader_and_idle_reader():
    from pfbench.run import metric_reader

    s = {"ops": {"void cut_scan_kernel<10>(...)": (2, 4e-4)},
         "busy_s": 0.25, "window_s": 1.0}
    ctx = {"trace": s, "text_n": 67108944, "builds": []}
    share = metric_reader("k1_roofline")(ctx)
    assert share == pytest.approx(100 * k1.least_seconds(67108944) / 2e-4)
    assert metric_reader("device.idle_pct")(ctx) == pytest.approx(75.0)
    assert metric_reader("k1_roofline")({"trace": {}, "text_n": 1}) is None
    assert metric_reader("device.idle_pct")({"trace": {}}) is None


def test_build_rate_reader():
    from pfbench.run import metric_reader

    read = metric_reader("build_mbps.panel")
    builds = [{"info": {}, "spans": {}}] * 3
    assert read({"builds": builds, "bases": 2_000_000, "window_s": 4.0}) \
        == pytest.approx(1.5)
    assert read({"builds": [], "bases": 1, "window_s": 1.0}) is None
