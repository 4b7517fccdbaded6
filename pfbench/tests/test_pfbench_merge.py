"""The merge cell, ``merge_pfp-pan256.hap8``, at a tiny size on the CPU:
its walk reads correct, a written file with one byte flipped, a shard
left out of the merge and the control read not correct, a run loads no
JAX, the two commands' ``info`` join into one build's, and its readers
say nothing where a run has nothing for them."""

import json
import os
import subprocess
import sys

import pytest

from pfbench import control, run
from pfbench.drivers import merge_pfp

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = "merge_pfp-pan256.hap8"
# the cell's shapes (8 haplotypes, one shard each) at far less scale
TINY = {"config": {"text_bp": 1 << 15}}
READERS = [m["name"] for m in run.load_cell(CELL)[3]["per_layer"]
           if CELL in m.get("workloads", [])]
SPANS = ("merge.rebuild_ms", "merge.parse_ms", "merge.assemble_ms",
         "merge.files_ms")


def _run(seed=2**35 + 11, trace=False):
    return run.run_cell(CELL, seed, 0.2, trace, device="cpu", overrides=TINY)


def test_cpu_walk_is_correct():
    r = _run()
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"peak_dev_gib", "setup_s"}
    names = {k.split(".", 1)[1] for k in r["checks"]}
    assert names == set(merge_pfp.FILES) and len(names) == 12
    assert all(v["value"] == 0 for v in r["checks"].values())


def test_traced_cpu_walk_reads_the_program_spans():
    r = _run(seed=5, trace=True)
    assert r["correct"]
    assert set(SPANS) | {"merge.build_mbps", "merge.syncs"} <= set(
        r["metrics"])
    assert all(r["metrics"][m]["value"] > 0 for m in SPANS)
    assert r["metrics"]["merge.syncs"]["value"] > 0
    # no card: no peak counter, and its reader says nothing
    assert "merge.peak_merge_gib" not in r["metrics"]


def _flip_written(monkeypatch, ext):
    """Flip one byte of file ``ext`` of every build once pfbwt_f
    --pfbwt-only has written the last of the twelve."""
    from pfbwtf_tpu_torch.cli import pfbwt_f

    real = pfbwt_f.main

    def broken(argv, **kw):
        rc = real(argv, **kw)
        if "--pfbwt-only" in argv:
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


@pytest.mark.parametrize("ext", ["parse", "docs", "bwlast", "sa"])
def test_flipped_written_byte_is_not_correct(monkeypatch, ext):
    """The flip comes after stage 3 has read the merged files: only the
    flipped file's number moves."""
    _flip_written(monkeypatch, ext)
    r = _run()
    assert not r["correct"] and r["failed"] >= 1
    assert _bad(r) == {ext}


def test_a_shard_left_out_is_not_correct(monkeypatch):
    """The merge given seven of the eight shard parses: every file but the
    parse-free ones moves."""
    from pfbwtf_tpu_torch.cli import merge_pfp as cli

    real = cli.main

    def seven(argv, **kw):
        return real([a for a in argv if not a.endswith("shard3")], **kw)

    monkeypatch.setattr(cli, "main", seven)
    r = _run()
    assert not r["correct"] and r["failed"] >= 1
    assert {"docs", "n", "parse", "bwt", "sa"} <= _bad(r)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct(seed):
    r = control.control_numbers(CELL, seed, device="cpu", overrides=TINY)
    assert not r["correct"], r
    assert r["numbers"]["docs"] == 0 and r["numbers"]["parse"] == 0


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


def test_joined_info_is_one_build():
    first = {"rebuild_s": 1.0, "write_s": 0.5, "peak_merge": 7,
             "build_id": 3, "counts": {"syncs": 4, "merge_prefixes": 8},
             "spans": [("merge.rebuild", None, 0.0, 1.0),
                       ("staged.parse_bwt", None, 1.0, 2.0)]}
    second = {"write_s": 0.25, "assembly_s": 2.0, "build_id": 4,
              "counts": {"syncs": 6, "out_bytes": 9},
              "spans": [("staged.assemble", None, 2.0, 4.0),
                        ("fetch", 0, 3.0, 4.0)]}
    got = merge_pfp.joined_info(first, second)
    assert got["write_s"] == 0.75 and got["rebuild_s"] == 1.0
    assert got["assembly_s"] == 2.0 and got["peak_merge"] == 7
    assert got["build_id"] == (3, 4)
    assert got["counts"] == {"syncs": 10, "merge_prefixes": 8,
                             "out_bytes": 9}
    assert got["spans"][2:] == [("staged.assemble", None, 2.0, 4.0),
                                ("fetch", 2, 3.0, 4.0)]
    # a merge that hands back no spans or counters (a program without
    # them): the build has neither, so no reader sums one command alone
    bare = merge_pfp.joined_info({"rebuild_s": 1.0}, second)
    assert "spans" not in bare and "counts" not in bare


def test_the_cell_has_seven_readers():
    assert sorted(READERS) == sorted(SPANS + (
        "merge.build_mbps", "merge.syncs", "merge.peak_merge_gib"))


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
        return [("merge.rebuild", None, 0.0, k), ("merge.scan", None, 0, 0.25),
                ("merge.dedup", None, 0, 2.0),
                ("merge.save_parse", None, 0, 0.5),
                ("staged.parse_bwt", None, 0, 0.75),
                ("staged.save_parse_bwt", None, 0, 0.125),
                ("staged.load", None, 0, 0.125),
                ("staged.assemble", None, 0, 3.0), ("fetch", 7, 0, 1.0),
                ("staged.write", None, 0, 1.0)]

    def build(k, peak, syncs):
        return {"info": {"spans": spans(k), "peak_merge": peak,
                         "counts": {"syncs": syncs}},
                "spans": {"build": 10.0, "fsync": 0.25}, "cpu_s": 0.0}

    ctx = {"builds": [build(1, 1 << 30, 20), build(3, 3 << 30, 30)],
           "trace": {}, "bases": 10**6, "window_s": 4.0, "text_n": 10**6}
    want = {"merge.rebuild_ms": 2000.0, "merge.parse_ms": 2250.0,
            "merge.assemble_ms": 3750.0, "merge.files_ms": 2000.0,
            "merge.syncs": 25.0, "merge.peak_merge_gib": 1.0,
            "merge.build_mbps": 0.5}
    for name, v in want.items():
        assert run.metric_reader(name)(ctx) == pytest.approx(v), name
