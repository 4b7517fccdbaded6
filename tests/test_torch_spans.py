"""Stage spans and per-build counters (utils/timer.py) of the fused build
and of vcf_to_bwt, on the CPU: how spans nest, the ``info`` seconds they
fill, the ``pfbwt.<name>`` ranges under a profiler (and none without
one), the counters' repeatability, and the TASK-line contract."""

import json
import os
import shutil
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest
import torch

from pfbwtf_tpu_torch.io.fasta import read_fasta_bytes
from pfbwtf_tpu_torch.ops.fused import pfbwt_fused_records
from pfbwtf_tpu_torch.ops.parse import ParserParams
from pfbwtf_tpu_torch.utils import timer
from pfbwtf_tpu_torch.vcf.pipeline import VcfToBwtConfig, vcf_to_bwt

from .ref_fixtures import random_fasta
from .vcf_gen import random_vcf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACGT = np.frombuffer(b"ACGT", np.uint8)

FUSED_KEYS = {"stream_s": "stream", "host_s": "host_prep", "j2_s": "j2",
              "j3_s": "j3", "fetch_s": "fetch",
              "download_s": "fetch.download", "sample_s": "fetch.sample"}
VCF_KEYS = {"fai_s": "vcf.fai", "read_s": "vcf.read", "scan_s": "vcf.scan",
            "mps_s": "vcf.mps", "build_s": "vcf.build",
            "write_s": "vcf.write", "ma_s": "vcf.ma",
            "ma_index_s": "ma.index", "ma_permute_s": "ma.permute",
            "ma_write_s": "ma.write"}
KEYS = {"fused": FUSED_KEYS, "vcf": {**FUSED_KEYS, **VCF_KEYS}}
# the chars reach the card in span ``stream``: J2 uploads nothing
J_SPANS = {"j2.run", "j2.sizes_read", "j3.dict_flat", "j3.dict_sort",
           "j3.ranks_bwt", "j3.emit", "j3.checksum_read"}


def _fused_build(tmp_path):
    rng = np.random.default_rng(61)
    unit = rng.choice(ACGT, size=1500)
    records = []
    for i in range(3):
        seq = unit.copy()
        seq[rng.integers(0, seq.size, 8)] = rng.choice(ACGT, 8)
        records.append((f"h{i}", seq))
    params = ParserParams(w=6, p=20)

    def run():
        return pfbwt_fused_records(records, params, device="cpu",
                                   want_sa=True, want_rssa=True)[1]

    return run


def _vcf_build(tmp_path):
    """vcf_to_bwt --fused -r -m (the CLI's config) on a tiny panel."""
    rng = np.random.default_rng(62)
    fa = random_fasta(str(tmp_path / "ref.fa"), rng, nrecords=2, length=1500)
    vcf = str(tmp_path / "p.vcf")
    random_vcf(vcf, read_fasta_bytes(fa), rng, nsamples=2, density=0.02,
               indel_frac=0.3)
    calls = []

    def run():
        calls.append(len(calls))
        own = tmp_path / f"run{calls[-1]}"
        own.mkdir()
        shutil.copy(fa, own / "ref.fa")
        info = {}
        vcf_to_bwt(VcfToBwtConfig(
            fasta=str(own / "ref.fa"), vcfs=[vcf], output=str(own / "out"),
            mod=10, rssa=True, ma=True, fused=True, device="cpu"), info)
        return info

    return run


CASES = {"fused": _fused_build, "vcf": _vcf_build}


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """Two builds of one input per case, their ``info``, made once."""
    out = {}
    for case, make in CASES.items():
        run = make(tmp_path_factory.mktemp(case))
        out[case] = (run, run(), run())
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_nest(builds, case):
    spans = builds[case][1]["spans"]
    assert spans and {s[0] for s in spans} >= set(KEYS[case].values()) | J_SPANS
    children = {}
    for i, (name, parent, t0, t1) in enumerate(spans):
        assert t1 >= t0
        if parent is not None:
            assert parent < i
            _, _, p0, p1 = spans[parent]
            assert p0 <= t0 and t1 <= p1
            children.setdefault(parent, []).append(t1 - t0)
        else:
            assert "." not in name or name.startswith("vcf.")
    for i, durs in children.items():
        assert spans[i][3] - spans[i][2] - sum(durs) >= 0  # self time
    names = [s[0] for s in spans]

    def ancestors(name):
        out, p = [], spans[names.index(name)][1]
        while p is not None:
            out.append(names[p])
            p = spans[p][1]
        return out

    assert ancestors("j2.run")[0] == "j2" and ancestors("j3.emit")[0] == "j3"
    assert ancestors("fetch.sample")[0] == "fetch"
    if case == "vcf":
        assert "vcf.build" in ancestors("j3") and "vcf.build" in \
            ancestors("fetch.download")
        assert ancestors("ma.permute") == ["vcf.ma"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_info_keys_are_their_spans(builds, case):
    info = builds[case][1]
    by_name = {}
    for name, _, t0, t1 in info["spans"]:
        by_name.setdefault(name, []).append(t1 - t0)
    for key, name in KEYS[case].items():
        assert by_name[name] == [info[key]], (key, name)
    assert info["fetch_s"] >= info["download_s"] + info["sample_s"]
    assert isinstance(info["build_id"], int)


def test_vcf_info_carries_the_fused_build(builds):
    first, second = builds["vcf"][1:]
    for key in ("j2_s", "j3_s", "download_s", "read_s", "fai_s", "mps_s",
                "write_s", "checksum", "j2_runs"):
        assert key in first, key
    assert first["checksum"] == second["checksum"]
    assert first["build_id"] != second["build_id"]
    # one build: the fused build joined vcf_to_bwt's
    assert sum(s[0] == "vcf.build" for s in first["spans"]) == 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_counts_repeat(builds, case):
    _, first, second = builds[case]
    assert first["counts"] == second["counts"]
    c = first["counts"]
    # J2's sizes a run, a scalar or two a doubling round, the checksum
    # and the downloads
    assert c["syncs"] >= 2 + first["j2_runs"] + c["rounds"]
    assert c["d2h_bytes"] >= first["n"] + 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_ranges_only_under_a_profiler(builds, case, monkeypatch):
    run = builds[case][0]
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        info = run()
    ranges = Counter(e.name for e in prof.events()
                     if e.name.startswith("pfbwt."))
    assert ranges == Counter("pfbwt." + s[0] for s in info["spans"])

    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: opened.append(a) or real(*a, **k))
    assert run()["spans"] and opened == []


def test_task_timer_contract(capsys):
    info = {}
    with timer.build(info):
        with timer.task_timer("a stage", "outer") as s:
            with timer.span("outer.inner"):
                timer.count("things", 3)
            timer.count("things")
        with timer.build({}):  # a nested entry point joins
            timer.count("things")
        with timer.task_timer("no span") as none:  # a TASK line alone
            pass
    timer.count("things")  # no build open: nothing counted
    err = capsys.readouterr().err.splitlines()
    assert none is None and err[0] == f"TASK\ta stage\t{s.seconds:.2f}s"
    assert err[1].startswith("TASK\tno span\t") and len(err) == 2
    assert [(n, p) for n, p, _, _ in info["spans"]] == [
        ("outer", None), ("outer.inner", 0)]
    assert info["counts"] == {"things": 5}


def test_profile_trace_holds_the_fused_spans(tmp_path):
    """PFBWT_PROFILE=<dir>: the --fused CLI's trace holds its TASK range
    and the fused build's J2 and J3 spans."""
    fa = tmp_path / "in.fa"
    rng = np.random.default_rng(28)
    fa.write_bytes(b">r\n" + rng.choice(ACGT, size=3000).tobytes() + b"\n")
    code = ("import sys; from pfbwtf_tpu_torch.cli.pfbwt_f import main; "
            "sys.exit(main(sys.argv[1:], device='cpu'))")
    env = dict(os.environ, PYTHONPATH=REPO,
               PFBWT_PROFILE=str(tmp_path / "prof"))
    proc = subprocess.run(
        [sys.executable, "-c", code, str(fa), "-o", str(tmp_path / "o"),
         "--fused", "-s", "-r", "-p", "20"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    traces = list((tmp_path / "prof").glob("pfbwt_*.json"))
    assert len(traces) == 1
    names = {ev.get("name") for ev in json.loads(traces[0].read_text())
             ["traceEvents"]}
    assert {"fused device pipeline (parse+pfbwt)", "pfbwt.j2", "pfbwt.j3",
            "pfbwt.j2.run", "pfbwt.fetch.sample"} <= names
