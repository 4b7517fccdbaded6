"""The staged build's spans and counters (pfbwtf_tpu_torch/pipeline.py,
engine.py, cli/pfbwt_f._run_staged): one build a CLI run, its ten
``staged.*`` spans in order, the ``*_s`` keys read off them, the files'
bytes counted, and the host reads counted as syncs."""

import numpy as np
import pytest

from pfbwtf_tpu_torch import engine
from pfbwtf_tpu_torch.cli.pfbwt_f import main

ACGT = np.frombuffer(b"ACGT", np.uint8)
CKPT = ("dict", "occ", "parse", "n", "bwlast", "ilist", "bwsai")
OUTS = ("bwt", "sa", "ssa", "esa")
PARSE_SPANS = ("staged.read", "staged.stream", "staged.scan",
               "staged.dedup", "staged.save_parse", "staged.parse_bwt",
               "staged.save_parse_bwt")
PFBWT_SPANS = ("staged.load", "staged.assemble", "fetch", "fetch.sample",
               "fetch.download", "staged.write")
# each stage key and the spans whose seconds it is
KEYS = {"read_s": ("staged.read",), "stream_s": ("staged.stream",),
        "scan_s": ("staged.scan",), "dedup_s": ("staged.dedup",),
        "parse_bwt_s": ("staged.parse_bwt",),
        "assembly_s": ("staged.assemble",)}
WRITES = ("staged.save_parse", "staged.save_parse_bwt", "staged.load",
          "staged.write")


def _fasta(path, seed=5, unit_len=3000, copies=4):
    rng = np.random.default_rng(seed)
    unit = rng.choice(ACGT, size=unit_len)
    with open(path, "wb") as f:
        for i in range(copies):
            hap = unit.copy()
            pos = rng.integers(0, hap.size, size=12)
            hap[pos] = ACGT[rng.integers(0, 4, size=12)]
            f.write(b">hap%d\n" % i + hap.tobytes() + b"\n")


def _sizes(tmp_path, prefix, exts):
    return sum((tmp_path / f"{prefix}.{ext}").stat().st_size for ext in exts)


def _seconds(info, names):
    return sum(t1 - t0 for n, _, t0, t1 in info["spans"] if n in names)


@pytest.fixture
def cut_reads(monkeypatch):
    """The element counts of the cut scan's host reads, through the
    counted read that engine.py calls."""
    seen = []
    real = engine.host_read

    def spy(t):
        seen.append(t.numel())
        return real(t)

    monkeypatch.setattr(engine, "host_read", spy)
    return seen


def _check_parse(info, tmp_path, prefix, cut_reads):
    present = {n for n, *_ in info["spans"]}
    for key, names in KEYS.items():
        if names[0] in present:
            assert info[key] == pytest.approx(_seconds(info, names)), key
    assert info["counts"]["ckpt_bytes"] == _sizes(tmp_path, prefix, CKPT)
    # one read of the cut positions, one a cut: phrases less one
    nphrases = (tmp_path / f"{prefix}.parse").stat().st_size // 4
    assert cut_reads == [nphrases - 1]
    assert info["counts"]["syncs"] > len(cut_reads)
    assert info["counts"]["d2h_bytes"] >= 8 * (nphrases - 1)
    assert "peak_parse" in info  # None on the CPU


@pytest.mark.parametrize("extra", [[], ["--u32"], ["-w", "6", "-p", "17"]])
def test_one_build_with_ten_spans(tmp_path, extra, cut_reads):
    fa = tmp_path / "in.fa"
    _fasta(fa)
    info = {}
    assert main([str(fa), "-o", str(tmp_path / "out"), "-s", "-r", *extra],
                device="cpu", info=info) == 0
    names = [s[0] for s in info["spans"]]
    assert names == list(PARSE_SPANS + PFBWT_SPANS)
    parents = {s[0]: s[1] for s in info["spans"]}
    at = {n: i for i, n in enumerate(names)}
    assert parents["fetch"] == at["staged.assemble"]
    assert parents["fetch.sample"] == parents["fetch.download"] == at["fetch"]
    top = [n for n in names if not n.startswith("fetch")]
    assert len(top) == 10 and all(parents[n] is None for n in top)
    # a span lies inside its parent and after the span before it
    spans = info["spans"]
    for _, parent, t0, t1 in spans:
        assert t0 <= t1
        if parent is not None:
            assert spans[parent][2] <= t0 and t1 <= spans[parent][3]
    for a, b in zip(top, top[1:]):
        assert spans[at[a]][3] <= spans[at[b]][2]
    assert isinstance(info["build_id"], int)
    _check_parse(info, tmp_path, "out", cut_reads)
    assert info["write_s"] == pytest.approx(_seconds(info, WRITES))
    assert info["counts"]["out_bytes"] == _sizes(tmp_path, "out", OUTS)
    assert "peak_assemble" in info


def test_parse_only_then_pfbwt_only(tmp_path, cut_reads):
    """Each half is a build of its own; together they count and write
    what one run does."""
    fa = tmp_path / "in.fa"
    _fasta(fa)
    whole, first, second = {}, {}, {}
    prefix = str(tmp_path / "out")
    assert main([str(fa), "-o", str(tmp_path / "one"), "-s", "-r"],
                device="cpu", info=whole) == 0
    cut_reads.clear()
    assert main([str(fa), "-o", prefix, "-s", "-r", "--parse-only"],
                device="cpu", info=first) == 0
    assert main(["-o", prefix, "-s", "-r", "--pfbwt-only"], device="cpu",
                info=second) == 0
    assert [s[0] for s in first["spans"]] == list(PARSE_SPANS)
    assert [s[0] for s in second["spans"]] == list(PFBWT_SPANS)
    assert first["build_id"] != second["build_id"]
    _check_parse(first, tmp_path, "out", cut_reads)
    assert first["write_s"] == pytest.approx(
        _seconds(first, WRITES[:2]))
    assert second["write_s"] == pytest.approx(_seconds(second, WRITES[2:]))
    assert second["assembly_s"] == pytest.approx(
        _seconds(second, ("staged.assemble",)))
    assert "ckpt_bytes" not in second["counts"]
    assert second["counts"]["out_bytes"] == _sizes(tmp_path, "out", OUTS)
    for ext in CKPT + OUTS:
        assert ((tmp_path / f"out.{ext}").read_bytes()
                == (tmp_path / f"one.{ext}").read_bytes()), ext
    assert "peak_parse" in first and "peak_assemble" in second
    total = {k: first["counts"].get(k, 0) + second["counts"].get(k, 0)
             for k in ("syncs", "d2h_bytes", "ckpt_bytes", "out_bytes")}
    assert total == {k: whole["counts"][k] for k in total}


def test_streamed_stage3_counts_its_outputs(tmp_path):
    """-m: span ``staged.assemble`` holds the streamed assembly and its
    writes; ``out_bytes`` the four outputs."""
    fa = tmp_path / "in.fa"
    _fasta(fa)
    info = {}
    assert main([str(fa), "-o", str(tmp_path / "out"), "-m", "-s", "-r"],
                device="cpu", info=info) == 0
    names = [s[0] for s in info["spans"]]
    assert names[:len(PARSE_SPANS)] == list(PARSE_SPANS)
    assert names[len(PARSE_SPANS):][:2] == ["staged.load", "staged.assemble"]
    assert info["assembly_s"] == pytest.approx(
        _seconds(info, ("staged.assemble",)))
    assert info["counts"]["out_bytes"] == _sizes(tmp_path, "out", OUTS)
