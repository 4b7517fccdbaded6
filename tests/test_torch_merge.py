"""The port's parse merge (parallel/merge.py, the merge_pfp CLI) against
pfbwtf_tpu's, and against the port's own parse of the whole text: the
merge of saved shard parses equals the parse of their concatenation.
Exact equality throughout; the port runs with device="cpu"."""

import numpy as np
import pytest

from pfbwtf_tpu.cli import merge_pfp as jax_merge_pfp
from pfbwtf_tpu.ops import parse as jax_parse
from pfbwtf_tpu.parallel import merge as jax_merge
from pfbwtf_tpu.pipeline import save_parser as jax_save_parser
from pfbwtf_tpu_torch import engine
from pfbwtf_tpu_torch.cli import merge_pfp
from pfbwtf_tpu_torch.io.fasta import read_fasta_bytes
from pfbwtf_tpu_torch.ops.parse import ParserParams, build_stream
from pfbwtf_tpu_torch.parallel import (load_or_generate_text,
                                       merge_parse_prefixes,
                                       reconstruct_text)
from pfbwtf_tpu_torch.pipeline import save_parse_bwt, save_parser

from .ref_fixtures import random_fasta

MERGED = ("dict", "occ", "parse", "n", "docs", "bwlast", "ilist", "bwsai")


def _shards(tmp_path, seed, nshards=4, length=900, docs=False, bare=()):
    """``nshards`` random FASTA shards; each is saved as a parse by
    pfbwtf_tpu (with .docs when ``docs``) except those in ``bare``, given
    as the FASTA itself.  Returns (the merge's arguments, the shards'
    FASTA paths)."""
    rng = np.random.default_rng(seed)
    params = jax_parse.ParserParams(w=10, p=10, get_sai=True,
                                    store_docs=docs)
    prefixes, fastas = [], []
    for i in range(nshards):
        fa = random_fasta(str(tmp_path / f"shard{i}.fa"), rng,
                          nrecords=int(rng.integers(1, 4)), length=length)
        fastas.append(fa)
        if i in bare:
            prefixes.append(fa)
            continue
        prefix = str(tmp_path / f"p{i}")
        jax_save_parser(jax_parse.parse_fasta(fa, params), prefix)
        prefixes.append(prefix)
    return prefixes, fastas


def _assert_parse_equal(got, want):
    assert got.n == want.n and got.nseqs == want.nseqs
    for f in ("occs", "parse_ranks", "last", "sai"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert np.array_equal(got.dict_flat(), want.dict_flat())
    assert got.doc_names == want.doc_names
    assert got.doc_starts == want.doc_starts


@pytest.mark.parametrize("docs", [False, True])
@pytest.mark.parametrize("bare", [(), (3,), (0, 2)])
def test_merge_parse_prefixes_equals_jax(tmp_path, docs, bare):
    prefixes, _ = _shards(tmp_path, 51 + len(bare), docs=docs, bare=bare)
    params = ParserParams(w=10, p=10, get_sai=True, store_docs=docs)
    info = {}
    got = merge_parse_prefixes(prefixes, params, device="cpu", info=info)
    want = jax_merge.merge_parse_prefixes(
        prefixes, jax_parse.ParserParams(w=10, p=10, get_sai=True,
                                         store_docs=docs))
    _assert_parse_equal(got, want)
    assert (len(got.doc_names) > 0) == docs
    assert {"rebuild_s", "scan_s", "dedup_s"} <= set(info)


@pytest.mark.parametrize("seed", [61, 62])
def test_merge_equals_whole_parse(tmp_path, seed):
    """The merge of the shards equals the port's own parse of all their
    records (the operator+= associativity property)."""
    prefixes, fastas = _shards(tmp_path, seed, bare=(1,))
    params = ParserParams(w=10, p=10, get_sai=True, store_docs=True)
    records = [r for fa in fastas for r in read_fasta_bytes(fa)]
    whole = engine.parse_records(records, params, device="cpu")
    merged = merge_parse_prefixes(prefixes, params, device="cpu")
    for f in ("occs", "parse_ranks", "last", "sai"):
        assert np.array_equal(getattr(merged, f), getattr(whole, f)), f
    assert np.array_equal(merged.dict_flat(), whole.dict_flat())
    assert merged.n == whole.n


@pytest.mark.parametrize("docs", [False, True])
def test_reconstruct_text_roundtrip(tmp_path, docs):
    fa = random_fasta(str(tmp_path / "x.fa"), np.random.default_rng(71),
                      nrecords=3, length=1500)
    params = ParserParams(w=10, p=10, get_sai=True, store_docs=docs)
    res = engine.parse_fasta(fa, params, device="cpu")
    save_parser(res, str(tmp_path / "x"))
    C0, names0, starts0 = build_stream(read_fasta_bytes(fa), params)
    C, names, starts = reconstruct_text(str(tmp_path / "x"), 10)
    assert np.array_equal(C, C0)
    want = jax_merge.reconstruct_text(str(tmp_path / "x"), 10)
    assert np.array_equal(C, want[0])
    assert (names, starts) == (want[1], want[2])
    assert (names, starts) == ((names0, starts0) if docs else ([], []))
    # a path with no parse files is read as a FASTA
    C2, _, _ = load_or_generate_text(fa, params)
    assert np.array_equal(C2, C0)


@pytest.mark.parametrize("extra", [["-s", "--parse-bwt"],
                                   ["-s", "--parse-bwt", "--u32"],
                                   ["--parse-bwt", "-d", "-t", "4"],
                                   ["-d", "-p", "13", "-w", "10"]])
def test_merge_pfp_cli_equals_jax(tmp_path, extra):
    prefixes, _ = _shards(tmp_path, 81, docs="-d" in extra, bare=(2,))
    assert merge_pfp.main([*prefixes, "-o", str(tmp_path / "port"), *extra],
                          device="cpu") == 0
    assert jax_merge_pfp.main([*prefixes, "-o", str(tmp_path / "jax"),
                               *extra]) == 0
    seen = []
    for ext in MERGED:
        got, want = tmp_path / f"port.{ext}", tmp_path / f"jax.{ext}"
        assert got.exists() == want.exists(), ext
        if want.exists():
            assert got.read_bytes() == want.read_bytes(), ext
            seen.append(ext)
    assert ("bwlast" in seen) == ("--parse-bwt" in extra)
    assert ("bwsai" in seen) == ("-s" in extra)
    assert ("docs" in seen) == ("-d" in extra)


def test_merge_pfp_then_pfbwt_only_equals_whole_build(tmp_path):
    """The merged checkpoint resumes to the final BWT and SA of the whole
    staged build."""
    from pfbwtf_tpu_torch.cli import pfbwt_f

    prefixes, fastas = _shards(tmp_path, 91, nshards=3, bare=(0,))
    whole = tmp_path / "whole.fa"
    whole.write_bytes(b"".join(open(f, "rb").read() for f in fastas))
    assert pfbwt_f.main([str(whole), "-o", str(tmp_path / "w"), "-s", "-r",
                         "-p", "10"], device="cpu") == 0
    assert merge_pfp.main([*prefixes, "-o", str(tmp_path / "m"), "-s",
                           "--parse-bwt", "-p", "10"], device="cpu") == 0
    for ext in ("dict", "occ", "parse", "n", "bwlast", "ilist", "bwsai"):
        assert ((tmp_path / f"m.{ext}").read_bytes()
                == (tmp_path / f"w.{ext}").read_bytes()), ext
    assert pfbwt_f.main(["-o", str(tmp_path / "m"), "--pfbwt-only", "-s",
                         "-r"], device="cpu") == 0
    for ext in ("bwt", "sa", "ssa", "esa"):
        assert ((tmp_path / f"m.{ext}").read_bytes()
                == (tmp_path / f"w.{ext}").read_bytes()), ext


def test_merge_pfp_missing_prefix_exits_1(tmp_path, capsys):
    prefixes, _ = _shards(tmp_path, 95, nshards=2)
    args = [*prefixes, str(tmp_path / "absent"), "-o"]
    assert merge_pfp.main([*args, str(tmp_path / "port")],
                          device="cpu") == 1
    port_err = capsys.readouterr().err
    assert jax_merge_pfp.main([*args, str(tmp_path / "jax")]) == 1
    assert capsys.readouterr().err == port_err
    assert "not found" in port_err
    assert not (tmp_path / "port.dict").exists()


def test_save_parse_bwt_of_merge_equals_jax_on_host(tmp_path, monkeypatch):
    """--parse-bwt under PFBWT_BACKEND=numpy (the host parse-BWT) writes
    the device run's files."""
    prefixes, _ = _shards(tmp_path, 99, bare=(1,))
    params = ParserParams(w=10, p=10, get_sai=True)
    res = merge_parse_prefixes(prefixes, params, device="cpu")
    monkeypatch.delenv("PFBWT_BACKEND", raising=False)
    save_parse_bwt(res, str(tmp_path / "dev"), device="cpu")
    monkeypatch.setenv("PFBWT_BACKEND", "numpy")
    save_parse_bwt(res, str(tmp_path / "host"), device="cpu")
    for ext in ("bwlast", "ilist", "bwsai"):
        assert ((tmp_path / f"host.{ext}").read_bytes()
                == (tmp_path / f"dev.{ext}").read_bytes()), ext
