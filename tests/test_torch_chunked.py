"""The port's chunked (bounded-memory) parse against the whole-array
scan and against pfbwtf_tpu's chunked parse, for any chunk size."""

import gzip

import numpy as np
import pytest
import torch

from pfbwtf_tpu.ops.chunked import parse_fasta_chunked as jax_chunked
from pfbwtf_tpu.ops.hash import hash_scan_np
from pfbwtf_tpu.ops.parse import ParserParams as JaxParams
from pfbwtf_tpu.ops.parse import parse_fasta as jax_parse_fasta
from pfbwtf_tpu_torch.io.fasta import iter_fasta_records, read_fasta_bytes
from pfbwtf_tpu_torch.ops import chunked
from pfbwtf_tpu_torch.ops.parse import ParserParams
from pfbwtf_tpu_torch.ops.hash import mod_p, wang_hash
from pfbwtf_tpu_torch.testing import wang_inverse
from pfbwtf_tpu_torch.utils.tables import NTOA_TABLE

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _pieces(codes, rng):
    """The codes in awkward piece sizes, to exercise the re-blocking."""
    i = 0
    while i < codes.shape[0]:
        take = int(rng.integers(1, 7000))
        yield codes[i: i + take]
        i += take


@pytest.mark.parametrize("w,p", [(10, 17), (4, 5), (32, 3)])
@pytest.mark.parametrize("chunk", [1 << 10, 1 << 12, 3000])
def test_chunked_cuts_match_whole_array(w, p, chunk):
    rng = np.random.default_rng(chunk + w)
    chars = rng.choice(ACGT, size=50_000)
    _, _, cut = hash_scan_np(chars, w, p)
    got = chunked.chunked_cut_positions(_pieces(NTOA_TABLE[chars], rng), w, p,
                                        chunk=chunk, device="cpu")
    assert got.dtype == np.int64
    assert np.array_equal(got, np.flatnonzero(cut))


def _plant_kmer(codes, i, w, p):
    """Write into codes[i-w+1 .. i] a k-mer whose Wang hash is a multiple
    of p (the newest code in the k-mer's low bits, ops/hash.py)."""
    kms = [wang_inverse(m * p) for m in range(64)]
    kms = [k for k in kms if k < 4 ** w]
    if not kms:  # small w: search every k-mer
        cand = torch.arange(4 ** w, dtype=torch.int64)
        kms = torch.nonzero(mod_p(wang_hash(cand), p) == 0).flatten().tolist()
    km = kms[0]
    for t in range(w):
        codes[i - t] = (km >> (2 * t)) & 3


@pytest.mark.parametrize("w,p", [(10, 97), (3, 2), (32, 1 << 20)])
def test_cut_at_the_first_live_position_of_a_later_chunk(w, p):
    """A k-mer planted to cut at the first position of chunks 2 and 3: the
    scan's own cut[:w] guard must not drop it (the halo is w codes)."""
    chunk = 1 << 12
    rng = np.random.default_rng(w)
    codes = rng.integers(0, 4, size=3 * chunk + 500, dtype=np.uint8)
    for k in (1, 2):
        _plant_kmer(codes, k * chunk, w, p)
    chars = ACGT[codes]
    _, _, cut = hash_scan_np(chars, w, p)
    assert cut[chunk] and cut[2 * chunk]
    got = chunked.chunked_cut_positions([codes], w, p, chunk=chunk,
                                        device="cpu")
    assert np.array_equal(got, np.flatnonzero(cut))


def _write_fasta(path, seed, nrec=4, lo=800, hi=5000):
    rng = np.random.default_rng(seed)
    unit = rng.choice(ACGT, size=hi)
    with open(path, "wb") as f:
        for i in range(nrec):
            hap = unit[: int(rng.integers(lo, hi))].copy()
            pos = rng.integers(0, hap.size, size=20)
            hap[pos] = ACGT[rng.integers(0, 4, size=20)]
            hap[:10] = np.frombuffer(b"acgtnACGTN", np.uint8)
            f.write(b">rec%d some description\n" % i)
            for j in range(0, hap.size, 61):
                f.write(hap[j: j + 61].tobytes() + b"\n")


@pytest.mark.parametrize("w,p,chunk", [(10, 100, 1 << 12), (6, 11, 3000),
                                       (10, 100, 1 << 22)])
def test_parse_fasta_chunked_equals_jax(tmp_path, w, p, chunk):
    """Several records and docs: every field of the ParseResult and the
    .dict bytes equal pfbwtf_tpu's chunked parse and its whole parse."""
    fa = str(tmp_path / "in.fa")
    _write_fasta(fa, w * 1000 + p)
    kw = dict(w=w, p=p, get_sai=True, store_docs=True)
    info = {}
    got = chunked.parse_fasta_chunked(fa, ParserParams(**kw), chunk=chunk,
                                      device="cpu", info=info)
    for want in (jax_chunked(fa, JaxParams(**kw), chunk=chunk),
                 jax_parse_fasta(fa, JaxParams(**kw))):
        assert got.n == want.n and got.nseqs == want.nseqs
        for f in ("dict_starts", "dict_lens", "occs", "parse_ranks", "last",
                  "sai"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert got.doc_names == want.doc_names
        assert got.doc_starts == want.doc_starts
        assert np.array_equal(got.dict_flat(), want.dict_flat())
    assert info["n_chunks"] == -(-got.n // chunk)


def test_one_scan_per_chunk(tmp_path, monkeypatch):
    """The chunked parse scans ceil(C_len / chunk) times: no chunk is
    scanned twice."""
    fa = str(tmp_path / "in.fa")
    _write_fasta(fa, 5)
    calls = []
    real = chunked.cut_mask
    monkeypatch.setattr(chunked, "cut_mask",
                        lambda c, w, p: calls.append(c.shape[0]) or real(c, w,
                                                                         p))
    info = {}
    res = chunked.parse_fasta_chunked(fa, ParserParams(), chunk=3000,
                                      device="cpu", info=info)
    assert len(calls) == info["n_chunks"] == -(-res.n // 3000)
    assert sum(calls) == res.n + 10 * len(calls)  # each with its w-code halo


def test_iter_fasta_records_matches_slurp(tmp_path):
    """The streaming record reader equals the whole-file reader with tiny
    blocks (records and lines straddle them), gzip input, CRLF and
    multi-line records."""
    rng = np.random.default_rng(3)
    seqs = ["".join(rng.choice(list("ACGT"), size=int(n)))
            for n in rng.integers(10, 400, size=7)]
    text = ""
    for i, s in enumerate(seqs):
        lines = [s[j:j + 37] for j in range(0, len(s), 37)]
        text += f">rec{i} extra comment\r\n" + "\r\n".join(lines) + "\n"
    fa = tmp_path / "s.fa"
    fa.write_text(text)
    gz = tmp_path / "s.fa.gz"
    gz.write_bytes(gzip.compress(text.encode()))
    want = read_fasta_bytes(str(fa))
    assert [n for n, _ in want] == [f"rec{i}" for i in range(7)]
    for path, block in ((fa, 64), (fa, 8 << 20), (gz, 128)):
        got = list(iter_fasta_records(str(path), block=block))
        assert [n for n, _ in got] == [n for n, _ in want]
        for (gn, gs), (_, ws) in zip(got, want):
            assert np.array_equal(gs, ws), gn
