"""The streamed cell, ``stream-pan451.hap8``, at a tiny size on the CPU:
its walk reads correct, a written ``.bwt`` with one byte flipped and the
control read not correct, a run loads no JAX, and its readers say
nothing where a run has nothing for them."""

import functools
import json
import os
import subprocess
import sys

import pytest

from pfbench import control, run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = "stream-pan451.hap8"
# the cell's shapes at far less scale
TINY = {"config": {"text_bp": 1 << 15}}
READERS = [m["name"] for m in run.load_cell(CELL)[3]["per_layer"]
           if CELL in m.get("workloads", [])]
SPANS = ("stream.host_ms", "stream.j2_ms", "stream.j3a_ms",
         "stream.emit_ms", "stream.write_ms", "stream.sample_ms")


@pytest.fixture(autouse=True)
def several_chunks(monkeypatch):
    """A build at the tiny size still runs in several chunks, as at full
    size (about 10)."""
    from pfbwtf_tpu_torch.ops import fused_stream

    monkeypatch.setattr(fused_stream, "pfbwt_fused_stream_records",
                        functools.partial(
                            fused_stream.pfbwt_fused_stream_records,
                            chunk_target=4096))


def _run(seed=2**35 + 5, trace=False):
    return run.run_cell(CELL, seed, 0.2, trace, device="cpu", overrides=TINY)


def test_cpu_walk_is_correct():
    r = _run()
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"peak_dev_gib", "setup_s"}
    names = {k.split(".", 1)[1] for k in r["checks"]}
    assert names == {"bwt", "sa", "ssa", "esa"}
    assert all(v["value"] == 0 for v in r["checks"].values())


def test_traced_cpu_walk_reads_the_program_spans():
    r = _run(seed=3, trace=True)
    assert r["correct"]
    assert set(SPANS) | {"stream.build_mbps"} <= set(r["metrics"])
    assert all(r["metrics"][m]["value"] > 0 for m in SPANS)
    # no card: no peak counters, and their readers say nothing
    assert not {"stream.peak_j2_gib", "stream.peak_j3a_gib"} & set(
        r["metrics"])


def _flip_written(monkeypatch, ext):
    """Flip one byte of output ``ext`` of every build once the build has
    written it."""
    from pfbwtf_tpu_torch.ops import fused_stream

    build = fused_stream.pfbwt_fused_stream_records

    def broken(records, params, *, open_out, **kw):
        opened = {}

        def spy(e):
            opened[e] = f = open_out(e)
            return f

        out = build(records, params, open_out=spy, **kw)
        path = opened[ext].name
        with open(path, "r+b") as f:
            at = os.path.getsize(path) // 2
            f.seek(at)
            (b,) = f.read(1)
            f.seek(at)
            f.write(bytes([b ^ 1]))
        return out

    monkeypatch.setattr(fused_stream, "pfbwt_fused_stream_records", broken)


def _bad(r):
    return {k.split(".", 1)[1] for k, v in r["checks"].items()
            if v["value"] > v["limit"]}


def test_flipped_bwt_byte_is_not_correct(monkeypatch):
    _flip_written(monkeypatch, "bwt")
    r = _run()
    assert not r["correct"] and r["failed"] >= 1
    assert _bad(r) == {"bwt"}


def test_flipped_written_ssa_byte_is_not_correct(monkeypatch):
    """.ssa is written by the entry and read back from its file."""
    _flip_written(monkeypatch, "ssa")
    r = _run()
    assert not r["correct"] and r["failed"] >= 1
    assert _bad(r) == {"ssa"}


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct(seed):
    r = control.control_numbers(CELL, seed, device="cpu", overrides=TINY)
    assert not r["correct"], r


_BOUNDARY = r"""
import json, sys
sys.path.insert(0, {root!r})
from pfbench import run
run.run_cell({cell!r}, 7, 0.1, True, device="cpu", overrides={tiny!r})
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_jax():
    code = _BOUNDARY.format(root=ROOT, cell=CELL, tiny=TINY)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & set(run.FORBIDDEN)


def test_the_cell_has_nine_readers():
    assert sorted(READERS) == sorted(SPANS + (
        "stream.build_mbps", "stream.peak_j2_gib", "stream.peak_j3a_gib"))


@pytest.mark.parametrize("name", READERS)
def test_reader_says_nothing_without_its_keys(name):
    read = run.metric_reader(name)
    assert read({"builds": [], "trace": {}, "bases": 10, "window_s": 0.0,
                 "text_n": 10}) is None
    bare = {"info": {}, "spans": {}, "cpu_s": 0.0}
    assert read({"builds": [bare, bare], "trace": {}, "bases": 10,
                 "window_s": 0.0, "text_n": 10}) is None


def _build(spans, info, harness):
    return {"info": {"spans": spans, **info}, "spans": harness,
            "cpu_s": 0.0}


def test_readers_sum_spans_and_take_the_first_peak():
    """Two builds: spans by name (a name twice is summed), emit less its
    writes and sampling, the peaks' least value."""
    def spans(k):
        return [("stream", None, 0.0, 1.0 * k), ("host_prep", None, 0, 0.5),
                ("j2", None, 0, 2.0), ("j3a", None, 0, 3.0),
                ("j3e", None, 0, 10.0), ("j3e.write", 4, 0, 1.0),
                ("j3e.sample", 4, 0, 2.0), ("j3e.write", 4, 0, 1.0),
                ("files", None, 0, 0.25)]

    def info(k, peak_j2):
        return {"stream_s": 1.0 * k, "j2_s": 2.0, "j3a_s": 3.0,
                "chunks_s": 10.0, "peak_j2": peak_j2, "peak_j3a": 3 << 30}

    harness = {"read_fasta": 0.25, "build": 20.0, "fsync": 0.5}
    ctx = {"builds": [_build(spans(1), info(1, 1 << 30), harness),
                      _build(spans(3), info(3, 3 << 30), harness)],
           "trace": {}, "bases": 10**6, "window_s": 4.0, "text_n": 10**6}
    want = {"stream.host_ms": 2750.0, "stream.j2_ms": 2000.0,
            "stream.j3a_ms": 3000.0, "stream.emit_ms": 6000.0,
            "stream.write_ms": 2750.0, "stream.sample_ms": 2000.0,
            "stream.peak_j2_gib": 1.0, "stream.peak_j3a_gib": 3.0,
            "stream.build_mbps": 0.5}
    for name, v in want.items():
        assert run.metric_reader(name)(ctx) == pytest.approx(v), name
