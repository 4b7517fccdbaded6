"""The staged -m of the port (``pfbwt_f -m`` without ``--fused``): the
host dict layout (ops/bwt.suffix_layout), the streamed stage 3 on a
device (ops/bwt_mmap.assemble_bwt_stream) and the CLI, held against
pfbwtf_tpu's -m byte for byte, .gsa and .glcp included."""

import io

import numpy as np
import pytest

from pfbwtf_tpu.cli.pfbwt_f import main as jax_main
from pfbwtf_tpu.ops.bwt import suffix_layout as jax_suffix_layout
from pfbwtf_tpu.ops.bwt_mmap import assemble_bwt_stream as jax_stream
from pfbwtf_tpu.ops.parse import ParserParams, parse_records
from pfbwtf_tpu.ops.parse_bwt import bwt_of_parse
from pfbwtf_tpu_torch import native
from pfbwtf_tpu_torch.cli.pfbwt_f import main as torch_main
from pfbwtf_tpu_torch.ops.bwt import suffix_layout
from pfbwtf_tpu_torch.ops.bwt_mmap import assemble_bwt_stream

ACGT = np.frombuffer(b"ACGT", np.uint8)
# a staged -m -s -r run's files: the checkpoint files, the final files and
# the -m workspace
MMAP_FILES = ("dict", "occ", "parse", "n", "bwlast", "ilist", "bwsai", "bwt",
              "sa", "ssa", "esa", "gsa", "glcp")


def _stage12(records, w, p):
    res = parse_records(records, ParserParams(w=w, p=p, get_sai=True))
    pb = bwt_of_parse(res.parse_ranks, res.last, res.sai, get_sai=True)
    return (res.dict_flat(), w, res.occs.astype(np.int64), pb.bwlast,
            pb.ilist, pb.bwsai, res.n)


def _stream(fn, args, chunk, tmp_path, name, **kw):
    bwt_buf, sa_buf = io.BytesIO(), io.BytesIO()
    nruns, ssa, esa = fn(*args, bwt_buf, sa_fp=sa_buf, want_rssa=True,
                         chunk=chunk, workspace_prefix=str(tmp_path / name),
                         **kw)
    return bwt_buf.getvalue(), sa_buf.getvalue(), nruns, ssa, esa


@pytest.mark.parametrize("chunk", [1 << 22, 1024, 64, 7])
def test_stream_equals_jax_at_chunk_sizes(tmp_path, chunk):
    """assemble_bwt_stream on the CPU device against pfbwtf_tpu's at the
    chunk sizes of tests/test_bwt_mmap.py, workspace files included."""
    rng = np.random.default_rng(28)
    args = _stage12([("s", rng.choice(ACGT, size=9000))], 4, 9)
    want = _stream(jax_stream, args, chunk, tmp_path, "jax")
    info = {}
    got = _stream(assemble_bwt_stream, args, chunk, tmp_path, "port",
                  device="cpu", info=info)
    assert got[:3] == want[:3]
    assert np.array_equal(got[3], want[3]) and np.array_equal(got[4], want[4])
    for ext in ("gsa", "glcp"):
        assert ((tmp_path / f"port.{ext}").read_bytes()
                == (tmp_path / f"jax.{ext}").read_bytes())
    assert info["n_chunks"] >= (1 if chunk > 9000 else 9000 // chunk)


def test_stream_repetitive_groups_stay_whole():
    """Groups larger than the chunk target are taken whole."""
    rng = np.random.default_rng(50)
    args = _stage12([("r", np.tile(rng.choice(ACGT, size=300), 20))], 4, 7)
    bufs = [io.BytesIO(), io.BytesIO()]
    want = jax_stream(*args, bufs[0], chunk=16)
    got = assemble_bwt_stream(*args, bufs[1], chunk=16, device="cpu")
    assert bufs[1].getvalue() == bufs[0].getvalue()
    assert got[0] == want[0]


@pytest.mark.parametrize("lib", ["native", "numpy"])
def test_suffix_layout_equals_jax(monkeypatch, lib):
    """The layout with the native LCP kernel and with the numpy fallback
    (which spills no LCP) equals pfbwtf_tpu's native layout."""
    rng = np.random.default_rng(29)
    dict_flat, w, occs = _stage12(
        [("a", rng.choice(ACGT, size=4000)), ("b", rng.choice(ACGT, 3000))],
        5, 11)[:3]
    if lib == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    else:
        assert native.available()
    spilled = []
    got = suffix_layout(dict_flat, w, occs,
                        workspace=lambda sa, lcp: spilled.append(lcp))
    want = jax_suffix_layout(dict_flat, w, occs)
    for a, b in zip(got[:5], want[:5]):
        assert np.array_equal(a, b)
    assert got[5] == want[5]
    assert (spilled[0] is None) == (lib == "numpy")


@pytest.mark.parametrize("extra", [["-s", "-r"], ["--u32", "-s"],
                                   ["-s", "-r", "--chunk-mb", "1"]])
def test_cli_mmap_files_equal_jax(tmp_path, extra):
    """pfbwt_f -m: every file of pfbwtf_tpu's -m run, .gsa and .glcp
    included, and the .bwt/.sa/.ssa/.esa of the port's run without -m."""
    rng = np.random.default_rng(30)
    fa = tmp_path / "x.fa"
    fa.write_bytes(b">s\n" + rng.choice(ACGT, size=6000).tobytes() + b"\n"
                   + b">t\n" + rng.choice(ACGT, size=2000).tobytes() + b"\n")
    args = ["-p", "11", "-w", "4", *extra]
    assert jax_main([str(fa), "-o", str(tmp_path / "jax"), "-m", *args]) == 0
    assert torch_main([str(fa), "-o", str(tmp_path / "port"), "-m", *args],
                      device="cpu") == 0
    assert torch_main([str(fa), "-o", str(tmp_path / "plain"), *args],
                      device="cpu") == 0
    for ext in MMAP_FILES:
        want = tmp_path / f"jax.{ext}"
        got = tmp_path / f"port.{ext}"
        assert want.exists() == got.exists(), ext
        if want.exists():
            assert got.read_bytes() == want.read_bytes(), ext
    assert (tmp_path / "port.glcp").exists()
    for ext in ("bwt", "sa", "ssa", "esa"):
        if (tmp_path / f"plain.{ext}").exists():
            assert ((tmp_path / f"port.{ext}").read_bytes()
                    == (tmp_path / f"plain.{ext}").read_bytes()), ext


def test_cli_mmap_bwt_to_stdout_equals_jax(tmp_path, capfdbinary):
    """pfbwt_f -m -c bwt: the BWT goes to stdout, as pfbwtf_tpu's does."""
    rng = np.random.default_rng(31)
    fa = tmp_path / "x.fa"
    fa.write_bytes(b">s\n" + rng.choice(ACGT, size=5000).tobytes() + b"\n")
    args = ["-p", "10", "-m", "-c", "bwt"]
    capfdbinary.readouterr()
    assert jax_main([str(fa), "-o", str(tmp_path / "jax"), *args]) == 0
    want = capfdbinary.readouterr().out
    assert torch_main([str(fa), "-o", str(tmp_path / "port"), *args],
                      device="cpu") == 0
    got = capfdbinary.readouterr().out
    assert len(want) == 5000 + 10 + 1 and got == want
    assert not (tmp_path / "port.bwt").exists()
    assert ((tmp_path / "port.gsa").read_bytes()
            == (tmp_path / "jax.gsa").read_bytes())


@pytest.mark.parametrize("parser", ["jax", "port"])
def test_mmap_resume_across_packages(tmp_path, parser):
    """--pfbwt-only -m of the port from either package's checkpoint files
    (read as memmaps) equals pfbwtf_tpu's whole -m run."""
    rng = np.random.default_rng(32)
    fa = tmp_path / "x.fa"
    fa.write_bytes(b">s\n" + rng.choice(ACGT, size=4000).tobytes() + b"\n")
    args = ["-p", "10", "-s", "-r", "-m"]
    assert jax_main([str(fa), "-o", str(tmp_path / "want"), *args]) == 0
    ck = str(tmp_path / "ck")
    if parser == "jax":
        assert jax_main([str(fa), "-o", ck, "--parse-only", *args]) == 0
    else:
        assert torch_main([str(fa), "-o", ck, "--parse-only", *args],
                          device="cpu") == 0
    assert torch_main(["-o", ck, "--pfbwt-only", *args], device="cpu") == 0
    for ext in MMAP_FILES:
        assert ((tmp_path / f"ck.{ext}").read_bytes()
                == (tmp_path / f"want.{ext}").read_bytes()), ext
