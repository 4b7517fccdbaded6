"""The streamed build's records entry
(``ops/fused_stream.pfbwt_fused_stream_records``) on seeded pan-genomes,
on the CPU: its outputs against the plain reference of the benchmark
(``pfbench/reference/sa.py``, plain PyTorch) and the monolithic build, its
spans and counters, and the ``--fused -m`` CLI built on it."""

import io
import re
from contextlib import nullcontext

import numpy as np
import pytest
import torch

from pfbench.reference import sa as ref_sa
from pfbench.reference.text import collection_text
from pfbwtf_tpu_torch import constants
from pfbwtf_tpu_torch.cli.pfbwt_f import main as torch_main
from pfbwtf_tpu_torch.ops.fused import pfbwt_fused_records
from pfbwtf_tpu_torch.ops.fused_stream import (pfbwt_fused_stream,
                                               pfbwt_fused_stream_records)
from pfbwtf_tpu_torch.ops.parse import ParserParams, build_stream

ACGT = np.frombuffer(b"ACGT", np.uint8)
W, P = 10, 100
CHUNK = 2048  # emission slots a chunk: about 16 chunks at 4 x 8 KiB
SEEDS = (2**35 + 1, 2**35 + 2, 2**35 + 3)
# each span of the streamed build and the span it sits in
PARENTS = {
    "stream": None, "host_prep": None, "j2": None, "j3a": None,
    "j3e": None, "files": None,
    "j2.upload": "j2", "j2.run": "j2", "j2.sizes_read": "j2",
    "j3.dict_flat": "j3a", "j3.dict_sort": "j3a", "j3.ranks_bwt": "j3a",
    "j3a.state": "j3a", "j3a.table_read": "j3a",
    "j3e.fetch": "j3e", "j3e.write": "j3e", "j3e.sample": "j3e",
    "j3e.checksum_read": "j3e",
}
TASKS = ["streamed build: J2 parse",
         "streamed build: J3a dict sort, parse-BWT, chunk table",
         "streamed build: J3e emission chunks"]


def _pangenome(seed, copies=4, unit_bp=8192, snp_rate=0.001):
    """``copies`` haplotypes of one random genome, each with its own SNPs,
    as pfbench/generators/pangenome.py draws them."""
    rng = np.random.default_rng(seed)
    unit = ACGT[rng.integers(0, 4, size=unit_bp)]
    nmut = int(unit_bp * snp_rate)
    records = []
    for i in range(copies):
        hap = unit.copy()
        hap[rng.integers(0, unit_bp, size=nmut)] = ACGT[
            rng.integers(0, 4, size=nmut)]
        records.append((f"hap{i}", hap))
    return records


def _stream(records, **kw):
    """The records entry writing its four outputs to memory."""
    bufs = {e: io.BytesIO() for e in ("bwt", "sa", "ssa", "esa")}
    out, info = pfbwt_fused_stream_records(
        records, ParserParams(w=W, p=P),
        open_out=lambda e: nullcontext(bufs[e]), want_sa=True,
        want_rssa=True, device="cpu", chunk_target=CHUNK, **kw)
    got = {e: np.frombuffer(b.getvalue(), np.uint8 if e == "bwt"
                            else np.uint64) for e, b in bufs.items()}
    assert np.array_equal(got["ssa"], out[3])
    assert np.array_equal(got["esa"], out[4])
    return got, out, info


@pytest.fixture(scope="module", params=SEEDS)
def built(request):
    records = _pangenome(request.param)
    got, out, info = _stream(records)
    return records, got, out, info


def test_outputs_equal_the_reference_and_the_monolithic_build(built):
    records, got, out, info = built
    text = collection_text([s for _, s in records], W)
    sa, _ = ref_sa.suffix_array(text, "cpu")
    bwt = ref_sa.bwt_of(torch.from_numpy(text), sa)
    ssa, esa = ref_sa.run_samples(bwt, sa)
    want = {"bwt": bwt.numpy(), "sa": sa.numpy().view(np.uint64),
            "ssa": ssa.numpy().view(np.uint64),
            "esa": esa.numpy().view(np.uint64)}
    mono, _ = pfbwt_fused_records(records, ParserParams(w=W, p=P),
                                  device="cpu", want_sa=True, want_rssa=True)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
        assert np.array_equal(got[k], getattr(mono, k)), k
    assert out[0] == mono.nruns == ssa.shape[0] // 2
    assert out[1] == info["n"] + 1 == text.shape[0] + 1


def test_spans_nest_as_named(built):
    info = built[3]
    spans = info["spans"]
    names = [s[0] for s in spans]
    assert set(names) == set(PARENTS)
    for name, parent, t0, t1 in spans:
        assert t1 >= t0
        assert (names[parent] if parent is not None else None) == \
            PARENTS[name], name
        if parent is not None:
            assert spans[parent][2] <= t0 and t1 <= spans[parent][3]
    # each chunk is fetched, written and sampled once
    assert names.count("j3e.write") == names.count("j3e.sample") == \
        names.count("j3e.fetch") == info["n_chunks"]
    assert [s[3] - s[2] for s in spans if s[0] == "stream"] == \
        [info["stream_s"]]


def test_counts(built):
    records, _, _, info = built
    c = info["counts"]
    assert info["n_chunks"] >= 8
    assert isinstance(info["build_id"], int)
    # no card: no peaks
    assert info["peak_j2"] is info["peak_j3a"] is info["peak_chunks"] is None
    # the chunks' downloads are counted as bytes, not as syncs: checksum
    # mode makes the same host reads and no download
    C, _, _ = build_stream(records, ParserParams(w=W, p=P))
    ck_info = {}
    ck = pfbwt_fused_stream(C, W, P, chunk_target=CHUNK, device="cpu",
                            info=ck_info)
    assert ck[0] is None and ck[2] == info["checksum"]
    assert c["syncs"] == ck_info["counts"]["syncs"]
    assert c["d2h_bytes"] - ck_info["counts"]["d2h_bytes"] == \
        (info["n"] + 1) * (1 + 8)


def test_task_lines(capsys):
    _stream(_pangenome(SEEDS[0], copies=2))
    err = capsys.readouterr().err
    assert re.findall(r"^TASK\t([^\t]+)\t\d+\.\d\ds$", err, re.M) == TASKS


def _fasta(path, records):
    with open(path, "wb") as f:
        for name, seq in records:
            f.write(b">" + name.encode() + b"\n")
            for j in range(0, seq.size, 60):
                f.write(seq[j: j + 60].tobytes() + b"\n")


def _lines(err: str):
    return ([l for l in err.splitlines() if re.match(r"(n|r|n/r): ", l)],
            re.findall(r"^TASK\t([^\t]+)\t", err, re.M))


@pytest.mark.parametrize("flags", [["-s", "-r"], ["-s"], ["-r"], [],
                                   ["-s", "-r", "--u32"]])
def test_cli_stream_files_unchanged(tmp_path, capsys, flags):
    """--fused -m writes what the monolithic --fused writes and what the
    records entry returns, and prints the same n, r and n/r lines."""
    records = _pangenome(SEEDS[1], copies=3)
    fa = tmp_path / "in.fa"
    _fasta(fa, records)
    args = ["-w", str(W), "-p", str(P), *flags]
    assert torch_main([str(fa), "-o", str(tmp_path / "mono"), "--fused",
                       *args], device="cpu") == 0
    mono_lines, _ = _lines(capsys.readouterr().err)
    assert torch_main([str(fa), "-o", str(tmp_path / "stream"), "--fused",
                       "-m", *args], device="cpu") == 0
    lines, tasks = _lines(capsys.readouterr().err)
    assert lines == mono_lines and len(lines) == 3
    assert tasks == TASKS + ["fused device pipeline, streamed (parse+pfbwt)"]
    exts = ["bwt"] + ["sa"] * ("-s" in flags) + ["ssa", "esa"] * (
        "-r" in flags)
    for ext in ("bwt", "sa", "ssa", "esa"):
        path = tmp_path / f"stream.{ext}"
        assert path.exists() == (ext in exts), ext
        if ext in exts:
            assert path.read_bytes() == (tmp_path / f"mono.{ext}") \
                .read_bytes(), ext
    got, _, _ = _stream(records)
    assert (tmp_path / "stream.bwt").read_bytes() == got["bwt"].tobytes()


def test_cli_stream_u32_too_long_writes_nothing(tmp_path, capsys,
                                                 monkeypatch):
    """A text too long for --u32 dies before any output is opened."""
    fa = tmp_path / "in.fa"
    _fasta(fa, _pangenome(SEEDS[2], copies=2))
    monkeypatch.setattr(constants, "MAX_TEXT_32", 1000)
    assert torch_main([str(fa), "-o", str(tmp_path / "stream"), "--fused",
                       "-m", "-s", "-r", "--u32", "-w", str(W), "-p",
                       str(P)], device="cpu") == 1
    assert "use 64-bit version" in capsys.readouterr().err
    assert sorted(p.name for p in tmp_path.iterdir()) == ["in.fa"]
