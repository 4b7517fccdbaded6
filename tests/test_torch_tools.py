"""The port's host tools against pfbwtf_tpu's: simplebwt (the brute-force
BWT oracle), dump_intfile, dump_markers, readable_sa and readable_markers.
Their files, stdout bytes and exit codes must be equal."""

import io
import sys

import numpy as np
import pytest

from pfbwtf_tpu.cli import dump_intfile as jax_dump_intfile
from pfbwtf_tpu.cli import dump_markers as jax_dump_markers
from pfbwtf_tpu.cli import readable_markers as jax_readable_markers
from pfbwtf_tpu.cli import readable_sa as jax_readable_sa
from pfbwtf_tpu.cli import simplebwt as jax_simplebwt
from pfbwtf_tpu_torch.cli import (dump_intfile, dump_markers, pfbwt_f,
                                  readable_markers, readable_sa, simplebwt)
from pfbwtf_tpu_torch.markers.marker import create_marker
from pfbwtf_tpu_torch.markers.mps import write_mps_runs

from .ref_fixtures import random_fasta


def _run(capsysbinary, main, argv, stdin: bytes = None, monkeypatch=None):
    """(exit code, stdout bytes) of one CLI call."""
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin",
                            io.TextIOWrapper(io.BytesIO(stdin)))
    capsysbinary.readouterr()
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    sys.stdout.flush()
    return rc, capsysbinary.readouterr().out


@pytest.mark.parametrize("nrecords,length,sa", [(1, 1, False), (1, 800, True),
                                                (3, 700, True),
                                                (2, 1500, False)])
def test_simplebwt_equals_jax(tmp_path, capsysbinary, nrecords, length, sa):
    fa = random_fasta(str(tmp_path / "in.fa"), np.random.default_rng(length),
                      nrecords=nrecords, length=length)
    extra = ["-s"] if sa else []
    got = _run(capsysbinary, simplebwt.main,
               [fa, "-o", str(tmp_path / "port"), *extra])
    want = _run(capsysbinary, jax_simplebwt.main,
                [fa, "-o", str(tmp_path / "jax"), *extra])
    assert got == want and got[0] == 0
    for ext in ("bwt", "sa"):
        port, jax = tmp_path / f"port.{ext}", tmp_path / f"jax.{ext}"
        assert port.exists() == jax.exists() == (ext == "bwt" or sa)
        if jax.exists():
            assert port.read_bytes() == jax.read_bytes(), ext
    # the default output prefix is the FASTA's path
    assert simplebwt.main([fa]) == 0
    assert ((tmp_path / "in.fa.bwt").read_bytes()
            == (tmp_path / "jax.bwt").read_bytes())


def test_simplebwt_equals_the_pipeline(tmp_path):
    """Over records each padded with w 'A's, the brute-force BWT equals
    the staged build's .bwt and its SA the staged .sa."""
    from pfbwtf_tpu_torch.io.fasta import read_fasta_bytes

    fa = random_fasta(str(tmp_path / "in.fa"), np.random.default_rng(3),
                      nrecords=2, length=1200)
    padded = tmp_path / "padded.fa"
    padded.write_bytes(b"".join(
        b">" + name.encode() + b"\n" + seq.tobytes() + b"A" * 10 + b"\n"
        for name, seq in read_fasta_bytes(fa)))
    assert simplebwt.main([str(padded), "-o", str(tmp_path / "sb"),
                           "-s"]) == 0
    assert pfbwt_f.main([fa, "-o", str(tmp_path / "pf"), "-s", "-p", "10"],
                        device="cpu") == 0
    for ext in ("bwt", "sa"):
        assert ((tmp_path / f"sb.{ext}").read_bytes()
                == (tmp_path / f"pf.{ext}").read_bytes()), ext


INTFILES = [(np.uint32, 0, []), (np.uint32, 0, ["-b"]), (np.uint32, 3, []),
            (np.uint64, 0, ["-l"]), (np.uint64, 5, ["-l"]),
            (np.uint64, 0, ["-b", "-l"])]


@pytest.mark.parametrize("dtype,tail,flags", INTFILES)
@pytest.mark.parametrize("count", [0, 1, 257])
@pytest.mark.parametrize("stdin", [False, True])
def test_dump_intfile_equals_jax(tmp_path, capsysbinary, monkeypatch, dtype,
                                 tail, flags, count, stdin):
    """-b (32-bit, the default) and -l (64-bit), a named file or stdin; a
    ragged tail of ``tail`` bytes is dropped."""
    rng = np.random.default_rng(count + tail)
    vals = rng.integers(0, np.iinfo(dtype).max, size=count, dtype=dtype,
                        endpoint=True)
    raw = vals.tobytes() + bytes(range(1, tail + 1))
    path = tmp_path / "ints.bin"
    path.write_bytes(raw)
    argv = flags if stdin else [*flags, str(path)]
    feed = raw if stdin else None
    got = _run(capsysbinary, dump_intfile.main, argv, feed, monkeypatch)
    want = _run(capsysbinary, jax_dump_intfile.main, argv, feed, monkeypatch)
    assert got == want and got[0] == 0
    assert got[1] == b"".join(b"%d\n" % int(v) for v in vals)


def _write_runs(path, seed, nruns, empty_every=0):
    """A .mps/.ma stream of ``nruns`` random runs; every ``empty_every``-th
    run carries no marker."""
    rng = np.random.default_rng(seed)
    starts, ends, markers = [], [], []
    pos = 0
    for i in range(nruns):
        pos += int(rng.integers(0, 5))
        length = int(rng.integers(0, 4))
        starts.append(pos)
        ends.append(pos + length)
        pos += length + 1
        k = 0 if empty_every and i % empty_every == 0 else int(
            rng.integers(1, 4))
        markers.append(np.array(
            [create_marker(int(rng.integers(0, 1 << 30)),
                           int(rng.integers(0, 15)),
                           int(rng.integers(0, 1 << 16))) for _ in range(k)],
            dtype=np.uint64))
    with open(path, "wb") as f:
        write_mps_runs(f, starts, ends, markers)
    return sum(e - s + 1 for s, e in zip(starts, ends))


TOOLS = [(dump_markers.main, jax_dump_markers.main),
         (readable_markers.main, jax_readable_markers.main)]


@pytest.mark.parametrize("tool", [0, 1], ids=["dump_markers",
                                              "readable_markers"])
@pytest.mark.parametrize("nruns,empty_every", [(0, 0), (1, 0), (40, 0),
                                               (40, 3), (5, 1)])
def test_marker_dumps_equal_jax(tmp_path, capsysbinary, tool, nruns,
                                empty_every):
    """One line per run (dump_markers) or per position (readable_markers,
    the run's last marker on each), including runs with no marker and a
    stream with no run."""
    path = tmp_path / "x.mps"
    npos = _write_runs(path, nruns * 7 + empty_every, nruns, empty_every)
    port, jax = TOOLS[tool]
    got = _run(capsysbinary, port, [str(path)])
    want = _run(capsysbinary, jax, [str(path)])
    assert got == want and got[0] == 0
    lines = got[1].decode().splitlines()
    assert len(lines) == (nruns if tool == 0 else npos)


@pytest.mark.parametrize("count", [0, 1, 1000])
def test_readable_sa_equals_jax(tmp_path, capsysbinary, count):
    sa = np.random.default_rng(count).permutation(count).astype(np.uint64)
    path = tmp_path / "x.sa"
    path.write_bytes(sa.tobytes())
    got = _run(capsysbinary, readable_sa.main, [str(path)])
    want = _run(capsysbinary, jax_readable_sa.main, [str(path)])
    assert got == want and got[0] == 0
    assert got[1] == b"".join(b"%d\n" % int(v) for v in sa)


@pytest.mark.parametrize("mains", [
    (dump_markers.main, jax_dump_markers.main),
    (readable_markers.main, jax_readable_markers.main),
    (readable_sa.main, jax_readable_sa.main),
], ids=["dump_markers", "readable_markers", "readable_sa"])
def test_dump_tools_without_a_file_exit_1(capsys, mains):
    results = []
    for main in mains:
        rc = main([])
        results.append((rc, capsys.readouterr()))
    assert results[0] == results[1]
    assert results[0][0] == 1 and "usage" in results[0][1].err
