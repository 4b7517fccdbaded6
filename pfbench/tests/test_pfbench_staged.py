"""The staged cell, ``staged-pan256.hap8``, at a tiny size on the CPU: its
walk reads correct, a written ``.parse``, ``.ilist`` or ``.bwt`` with one
byte flipped and the control read not correct, a run loads no JAX, and
its readers say nothing where a run has nothing for them."""

import json
import os
import subprocess
import sys

import pytest

from pfbench import control, run
from pfbench.drivers import staged

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = "staged-pan256.hap8"
# the cell's shapes at far less scale
TINY = {"config": {"text_bp": 1 << 15}}
READERS = [m["name"] for m in run.load_cell(CELL)[3]["per_layer"]
           if CELL in m.get("workloads", [])]
SPANS = ("staged.parse_ms", "staged.dedup_ms", "staged.parse_bwt_ms",
         "staged.assemble_ms", "staged.files_ms")


def _run(seed=2**35 + 7, trace=False):
    return run.run_cell(CELL, seed, 0.2, trace, device="cpu", overrides=TINY)


def test_cpu_walk_is_correct():
    r = _run()
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"peak_dev_gib", "setup_s"}
    names = {k.split(".", 1)[1] for k in r["checks"]}
    assert names == set(staged.FILES) and len(names) == 11
    assert all(v["value"] == 0 for v in r["checks"].values())


def test_traced_cpu_walk_reads_the_program_spans():
    r = _run(seed=3, trace=True)
    assert r["correct"]
    assert set(SPANS) | {"staged.build_mbps", "staged.syncs"} <= set(
        r["metrics"])
    assert all(r["metrics"][m]["value"] > 0 for m in SPANS)
    assert r["metrics"]["staged.syncs"]["value"] > 0
    # no card: no peak counter, and its reader says nothing
    assert "staged.peak_parse_gib" not in r["metrics"]


def _flip_written(monkeypatch, ext):
    """Flip one byte of file ``ext`` of every build once the CLI has
    written all eleven."""
    from pfbwtf_tpu_torch.cli import pfbwt_f

    real = pfbwt_f.main

    def broken(argv, **kw):
        rc = real(argv, **kw)
        path = argv[argv.index("-o") + 1] + "." + ext
        with open(path, "r+b") as f:
            at = os.path.getsize(path) // 2
            f.seek(at)
            (b,) = f.read(1)
            f.seek(at)
            f.write(bytes([b ^ 1]))
        return rc

    monkeypatch.setattr(pfbwt_f, "main", broken)


def _bad(r):
    return {k.split(".", 1)[1] for k, v in r["checks"].items()
            if v["value"] > v["limit"]}


@pytest.mark.parametrize("ext", ["parse", "ilist", "bwt"])
def test_flipped_written_byte_is_not_correct(monkeypatch, ext):
    """Stage 3 reads no .parse, and the flip comes after it: only the
    flipped file's number moves."""
    _flip_written(monkeypatch, ext)
    r = _run()
    assert not r["correct"] and r["failed"] >= 1
    assert _bad(r) == {ext}


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


def test_the_cell_has_eight_readers():
    assert sorted(READERS) == sorted(SPANS + (
        "staged.build_mbps", "staged.syncs", "staged.peak_parse_gib"))


@pytest.mark.parametrize("name", READERS)
def test_reader_says_nothing_without_its_keys(name):
    read = run.metric_reader(name)
    assert read({"builds": [], "trace": {}, "bases": 10, "window_s": 0.0,
                 "text_n": 10}) is None
    bare = {"info": {}, "spans": {}, "cpu_s": 0.0}
    assert read({"builds": [bare, bare], "trace": {}, "bases": 10,
                 "window_s": 0.0, "text_n": 10}) is None


def test_readers_sum_spans_and_take_the_least_peak():
    """Two builds: spans by name, the harness's fsync added to the files,
    syncs a build, the peaks' least value."""
    def spans(k):
        return [("staged.read", None, 0.0, 0.5), ("staged.stream", None, 0, k),
                ("staged.scan", None, 0, 0.25), ("staged.dedup", None, 0, 2.0),
                ("staged.save_parse", None, 0, 0.5),
                ("staged.parse_bwt", None, 0, 0.75),
                ("staged.save_parse_bwt", None, 0, 0.125),
                ("staged.load", None, 0, 0.125),
                ("staged.assemble", None, 0, 3.0), ("fetch", 8, 0, 1.0),
                ("staged.write", None, 0, 1.0)]

    def build(k, peak, syncs):
        return {"info": {"spans": spans(k), "peak_parse": peak,
                         "counts": {"syncs": syncs}},
                "spans": {"build": 10.0, "fsync": 0.25}, "cpu_s": 0.0}

    ctx = {"builds": [build(1, 1 << 30, 20), build(3, 3 << 30, 30)],
           "trace": {}, "bases": 10**6, "window_s": 4.0, "text_n": 10**6}
    want = {"staged.parse_ms": 2750.0, "staged.dedup_ms": 2000.0,
            "staged.parse_bwt_ms": 750.0, "staged.assemble_ms": 3000.0,
            "staged.files_ms": 2000.0, "staged.syncs": 25.0,
            "staged.peak_parse_gib": 1.0, "staged.build_mbps": 0.5}
    for name, v in want.items():
        assert run.metric_reader(name)(ctx) == pytest.approx(v), name
