"""The port's ``io/fasta.read_fasta_bytes`` against the JAX package's on
every shape of input: the same names, bytes and record order, the same
``ValueError``, on plain, gzip, two-member bgzip and stdin input.  Each
record is a 1-D, C-contiguous, writable uint8 array, and the build's
counters say which of the reader's two paths each record took: a view of
the read buffer (``fasta_views``) or a whitespace strip
(``fasta_stripped``)."""

import gzip
import io
import os
import sys
import threading

import numpy as np
import pytest

from pfbwtf_tpu.io.fasta import read_fasta_bytes as jread_fasta_bytes
from pfbwtf_tpu_torch.io.fasta import read_fasta_bytes
from pfbwtf_tpu_torch.utils.timer import build

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _seq(n: int, seed: int, alphabet=ACGT) -> bytes:
    return alphabet[np.random.default_rng(seed).integers(
        0, alphabet.size, n)].tobytes()


def _wrap(seq: bytes, width: int, eol: bytes = b"\n") -> bytes:
    return b"".join(seq[i: i + width] + eol
                    for i in range(0, len(seq), width))


def _fasta(records, width=None, eol=b"\n") -> bytes:
    out = b""
    for header, seq in records:
        body = seq + eol if width is None else _wrap(seq, width, eol)
        out += b">" + header + eol + body
    return out


THREE = [(b"chr1 first", _seq(1000, 1)), (b"chr2", _seq(517, 2)),
         (b"chr3\tthird", _seq(240, 3))]
IUPAC = np.frombuffer(b"ACGTacgtNnRYKMSWBDHVryk-*.", np.uint8)

# id -> (file bytes, the counters a read engages); None for a ValueError
CASES = {
    "one_line": (_fasta(THREE), {"fasta_views": 3}),
    "wrap60_short_last": (_fasta(THREE, 60), {"fasta_stripped": 3}),
    "wrap70_short_last": (_fasta(THREE, 70), {"fasta_stripped": 3}),
    "wrap80_short_last": (_fasta(THREE, 80), {"fasta_stripped": 3}),
    "wrap60_full_last": (
        _fasta([(b"a", _seq(600, 4)), (b"b", _seq(120, 5))], 60),
        {"fasta_stripped": 2}),
    "wrap80_full_last": (
        _fasta([(b"a", _seq(800, 6)), (b"b", _seq(160, 7))], 80),
        {"fasta_stripped": 2}),
    "crlf_wrapped": (_fasta(THREE, 60, b"\r\n"), {"fasta_stripped": 3}),
    "crlf_one_line": (_fasta(THREE, None, b"\r\n"), {"fasta_views": 3}),
    "one_full_line_and_newline": (
        b">a\n" + _seq(60, 8) + b"\n", {"fasta_views": 1}),
    "ragged": (b">a\nACGTA\nCG\nTTTAC\nG\n>b\nACG\nACGTT\nA\n",
               {"fasta_stripped": 2}),
    "long_last_line": (b">a\nACGT\nACGT\nACGTAC\n", {"fasta_stripped": 1}),
    "long_last_line_crlf": (b">a\r\nACG\r\nACGT\r\n",
                            {"fasta_stripped": 1}),
    "mixed_eol": (b">a\nACGT\r\nACGT\nAC\n", {"fasta_stripped": 1}),
    "space_in_line": (b">a\nACG TACGT\n>b\nAC\tGT\n",
                      {"fasta_stripped": 2}),
    "tab_in_wrapped": (b">a\nACGT\nA\tCG\nAC\n", {"fasta_stripped": 1}),
    "space_in_last_line": (b">a\nACGT\nACGT\nA C\n", {"fasta_stripped": 1}),
    "blank_inside": (b">a\nACGT\n\nACGT\nAC\n", {"fasta_stripped": 1}),
    "blank_after_header": (b">a\n\nACGT\nACGT\n", {"fasta_stripped": 1}),
    "blank_between": (b">a\nACGT\nACGT\nAC\n\n\n>b\nACGT\n \t\n",
                      {"fasta_stripped": 1, "fasta_views": 1}),
    "empty_record": (b">a\n>b desc\nACGT\n>c\n", {"fasta_views": 3}),
    "header_only_no_newline": (b">a\nACGT\n>last", {"fasta_views": 2}),
    "empty_name": (b">\nACGT\n> \nGG\n", {"fasta_views": 2}),
    "no_final_newline": (b">a\nACGTACGT\n>b\nACGTAC", {"fasta_views": 2}),
    "no_final_newline_wrapped": (b">a\nACGT\nACGT\nAC",
                                 {"fasta_stripped": 1}),
    "gt_inside_line": (b">a\nAC>GT\nACG>T\nA>\n>b\nA>CGT\n",
                       {"fasta_stripped": 1, "fasta_views": 1}),
    "gt_in_header": (b">a>b c>d\nACGT\n", {"fasta_views": 1}),
    "text_before_header": (b"junk line\nmore > junk\n>a\nACGT\n",
                           {"fasta_views": 1}),
    "iupac_lowercase": (_fasta([(b"x", _seq(333, 9, IUPAC)),
                                (b"y", _seq(90, 10, IUPAC))], 60),
                        {"fasta_stripped": 2}),
    "iupac_one_line": (_fasta([(b"x", _seq(333, 11, IUPAC))]),
                       {"fasta_views": 1}),
    "other_bytes_kept": (b">a\nAC\x0bGT\x0cN\x00\n", {"fasta_views": 1}),
    "empty_file": (b"", {}),
    "no_header": (b"ACGT\nACGT\n", None),
    "no_header_blank": (b"\n\n", None),
    "gt_not_at_line_start": (b"AC>GT\n", None),
}
# where the JAX package's reader fails (IndexError: the last header has
# no newline) the port returns kseq's records
KSEQ = {"header_only_no_newline": [("a", b"ACGT"), ("last", b"")]}
ENCODINGS = {"gzip": gzip.compress,
             "bgzip": lambda b: gzip.compress(b[: len(b) // 2])
             + gzip.compress(b[len(b) // 2:])}
COMPRESSED = ("one_line", "wrap60_short_last", "ragged", "empty_record",
              "no_header")


def _read(fn, path, stdin_bytes, monkeypatch):
    if stdin_bytes is not None:
        monkeypatch.setattr(sys, "stdin",
                            io.TextIOWrapper(io.BytesIO(stdin_bytes)))
        path = "-"
    return fn(path)


PARAMS = ([pytest.param(k, "plain", id=k) for k in CASES]
          + [pytest.param(k, e, id=f"{k}-{e}") for k in COMPRESSED
             for e in ENCODINGS]
          + [pytest.param(k, "stdin", id=f"{k}-stdin")
             for k in ("one_line", "wrap70_short_last", "ragged")])


@pytest.mark.parametrize("case,encoding", PARAMS)
def test_read_fasta_bytes_matches_jax(case, encoding, tmp_path, monkeypatch):
    text, paths = CASES[case]
    raw = ENCODINGS[encoding](text) if encoding in ENCODINGS else text
    fa = tmp_path / "in.fa"
    fa.write_bytes(raw)
    stdin = raw if encoding == "stdin" else None
    if paths is None:
        with pytest.raises(ValueError) as want:
            _read(jread_fasta_bytes, str(fa), stdin, monkeypatch)
        with pytest.raises(ValueError) as got:
            _read(read_fasta_bytes, str(fa), stdin, monkeypatch)
        assert str(got.value) == str(want.value)
        return
    if case in KSEQ:
        with pytest.raises(IndexError):
            _read(jread_fasta_bytes, str(fa), stdin, monkeypatch)
        want = [(n, np.frombuffer(b, np.uint8)) for n, b in KSEQ[case]]
    else:
        want = _read(jread_fasta_bytes, str(fa), stdin, monkeypatch)
    info = {}
    with build(info):
        got = _read(read_fasta_bytes, str(fa), stdin, monkeypatch)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.dtype == np.uint8 and g.ndim == 1
        assert g.flags.c_contiguous and g.flags.writeable
        assert g.tobytes() == w.tobytes()
    assert info["counts"] == paths


@pytest.mark.parametrize("case", ["one_line", "wrap60_short_last",
                                  "ragged", "empty_record"])
def test_records_share_no_bytes(case, tmp_path):
    """A write into one record shows in no other, nor in a second read."""
    fa = tmp_path / "in.fa"
    fa.write_bytes(CASES[case][0])
    first = read_fasta_bytes(str(fa))
    before = [s.copy() for _, s in first]
    for i, (_, seq) in enumerate(first):
        seq[:] = ord("x")
        for j, (_, other) in enumerate(first[i + 1:], i + 1):
            assert other.tobytes() == before[j].tobytes()
    again = read_fasta_bytes(str(fa))
    assert [s.tobytes() for _, s in again] == [s.tobytes() for s in before]


def test_counters_only_inside_a_build(tmp_path):
    fa = tmp_path / "in.fa"
    fa.write_bytes(CASES["one_line"][0])
    info = {}
    with build(info):
        pass
    read_fasta_bytes(str(fa))
    assert info["counts"] == {}


@pytest.mark.parametrize("seed", range(8))
def test_random_layouts_match_jax(seed, tmp_path):
    """Records of random lengths, line widths, terminators and stray
    whitespace read as the JAX package reads them."""
    rng = np.random.default_rng(seed)
    text = b"" if rng.random() < 0.5 else b"preamble\n"
    for r in range(int(rng.integers(1, 6))):
        seq = _seq(int(rng.integers(0, 400)), seed * 10 + r, IUPAC)
        eol = b"\r\n" if rng.random() < 0.3 else b"\n"
        width = int(rng.integers(1, 90))
        body = seq + eol if rng.random() < 0.3 else _wrap(seq, width, eol)
        if rng.random() < 0.3 and body:
            at = int(rng.integers(0, len(body)))
            body = body[:at] + bytes([b" \t\n\r"[rng.integers(0, 4)]]) \
                + body[at:]
        text += b">r%d desc\n" % r + body + b"\n" * int(rng.integers(0, 3))
    fa = tmp_path / "in.fa"
    fa.write_bytes(text)
    got, want = read_fasta_bytes(str(fa)), jread_fasta_bytes(str(fa))
    assert [(n, s.tobytes()) for n, s in got] == \
        [(n, s.tobytes()) for n, s in want]


@pytest.mark.parametrize("case", ["one_line", "ragged"])
def test_named_pipe_reads_as_file(case, tmp_path):
    """A path with no size (a FIFO) is read whole, as the file would be."""
    text = CASES[case][0]
    fa = tmp_path / "in.fa"
    fa.write_bytes(text)
    fifo = tmp_path / "pipe.fa"
    os.mkfifo(fifo)
    writer = threading.Thread(target=fifo.write_bytes, args=(text,))
    writer.start()
    got = read_fasta_bytes(str(fifo))
    writer.join()
    assert [(n, s.tobytes()) for n, s in got] == \
        [(n, s.tobytes()) for n, s in jread_fasta_bytes(str(fa))]
