"""The program's stage ranges in a made-up Chrome trace (pfbench.stages),
and the readers of the program's stage seconds and counters."""

import pytest

from pfbench import stages, trace
from pfbench.run import metric_reader

from .test_pfbench_trace import EVENTS, _Prof, _x

# EVENTS with the program's ranges inside the build span, on the window's
# thread: fetch [500, 1000) holds fetch.download [500, 600) and
# fetch.sample [600, 950); j3 [150, 500) holds j3.emit [200, 480); one on
# another thread is not read
NESTED = EVENTS + [
    _x("user_annotation", "pfbwt.j3", 150, 350),
    _x("user_annotation", "pfbwt.j3.emit", 200, 280),
    _x("user_annotation", "pfbwt.fetch", 500, 500),
    _x("user_annotation", "pfbwt.fetch.download", 500, 100),
    _x("user_annotation", "pfbwt.fetch.sample", 600, 350),
    _x("user_annotation", "pfbwt.j2", 100, 50, tid=2),
]


def test_innermost_parts():
    got = stages._innermost([(0, 100, "a"), (10, 20, "b"), (20, 30, "c"),
                             (25, 28, "d"), (50, 100, "e")])
    assert got == [(0, 10, "a"), (10, 20, "b"), (20, 25, "c"),
                   (25, 28, "d"), (28, 30, "c"), (30, 50, "a"),
                   (50, 100, "e")]


# what trace.summarize works out of EVENTS (and of NESTED, whose
# program ranges change none of it): the busy union, the idle gaps, the
# harness spans and the outermost ops of the window's thread
BUSY = [[150, 250], [300, 500], [990, 1000]]
GAPS = [(0, 150), (250, 300), (500, 990)]
SPANS = [(0, 100, "read_fasta"), (100, 1000, "build")]
CPU = [(200, 500, "aten::sort")]


def test_program_ranges_on_the_window_thread():
    got = stages.ranges(NESTED, 1, 0, 1000)
    assert sorted(got) == [(150, 500, "j3"), (200, 480, "j3.emit"),
                           (500, 600, "fetch.download"), (500, 1000, "fetch"),
                           (600, 950, "fetch.sample")]
    # clipped to the window; a range outside it is not read
    assert sorted(stages.ranges(NESTED, 1, 0, 540)) == [
        (150, 500, "j3"), (200, 480, "j3.emit"), (500, 540, "fetch"),
        (500, 540, "fetch.download")]
    assert stages.ranges(EVENTS, 1, 0, 1000) == []


def test_stages_of_nested_ranges():
    got = stages.stages(stages.ranges(NESTED, 1, 0, 1000), BUSY)
    assert got == {
        "fetch": pytest.approx([500e-6, 10e-6, 1]),
        "fetch.download": pytest.approx([100e-6, 0.0, 1]),
        "fetch.sample": pytest.approx([350e-6, 0.0, 1]),
        "j3": pytest.approx([350e-6, 300e-6, 1]),
        "j3.emit": pytest.approx([280e-6, 230e-6, 1]),
    }


def test_idle_labels_of_nested_ranges():
    got = stages.idle_by_label(GAPS, SPANS, CPU,
                               stages.ranges(NESTED, 1, 0, 1000))
    # idle: read 0-100; build 100-150 (no stage), 250-300 (j3.emit, in
    # aten::sort), 500-600 (download), 600-950 (sample), 950-990 (fetch)
    assert got == pytest.approx({
        "read_fasta:host": 100e-6, "build:host": 50e-6,
        "build/j3.emit:aten::sort": 50e-6,
        "build/fetch.download:host": 100e-6,
        "build/fetch.sample:host": 350e-6, "build/fetch:host": 40e-6})


def test_no_program_range_reads_as_trace_does(tmp_path):
    want = trace.summarize(_Prof(EVENTS), str(tmp_path))
    got = stages.idle_by_label(GAPS, SPANS, CPU, [])
    assert want["busy_s"] == pytest.approx(
        sum(e - s for s, e in BUSY) / 1e6)
    assert got == pytest.approx(dict(map(tuple,
                                         want["breakdown"]["idle_gaps"])))
    assert stages.stages([], BUSY) == {}


def _ctx(*infos):
    return {"builds": [{"info": i, "spans": {}} for i in infos]}


@pytest.mark.parametrize("metric, info, want", [
    ("fetch.download_ms", {"download_s": 0.25}, 250.0),
    ("fetch.sample_ms", {"sample_s": 1.5}, 1500.0),
    ("vcf.j3_ms", {"j3_s": 0.5}, 500.0),
    ("vcf.files_ms", {"read_s": 0.1, "fai_s": 0.2, "mps_s": 0.3,
                      "write_s": 0.4}, 1000.0),
    ("build.syncs", {"counts": {"syncs": 44}}, 44.0),
    ("build.d2h_mb", {"counts": {"d2h_bytes": 2_500_000}}, 2.5),
])
def test_stage_readers(metric, info, want):
    read = metric_reader(metric)
    assert read(_ctx(info, info)) == pytest.approx(want)
    # a program without the spans or counters: nothing to read
    assert read(_ctx({"j2_s": 1.0})) is None
    assert read(_ctx(info, {})) is None
    assert read(_ctx()) is None
