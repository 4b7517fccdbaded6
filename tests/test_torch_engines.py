"""The opt-in engines of pfbwtf_tpu (ROADMAP M12) in the port's fused and
streamed builds: with the same variable set on both sides, the port's
output equals the JAX package's byte for byte, its checksum over the
padded buffers included.  All on the CPU; every comparison is exact."""

import io

import numpy as np
import pytest

from pfbwtf_tpu.ops import fused as jfused
from pfbwtf_tpu.ops import fused_stream as jstream
from pfbwtf_tpu.ops.parse import ParserParams as JParams
from pfbwtf_tpu_torch.ops import fused as tfused
from pfbwtf_tpu_torch.ops import fused_stream as tstream
from pfbwtf_tpu_torch.ops import suffix as tsuf
from pfbwtf_tpu_torch.ops.parse import ParserParams, build_stream

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _case(name):
    """(records, w, p): the inputs of tests/test_fused.py:48-67 and
    132-158."""
    if name == "random":
        rng = np.random.default_rng(21)
        return [("s", rng.choice(ACGT, size=7000))], 4, 10
    if name == "random6000":
        rng = np.random.default_rng(21)
        return [("s", rng.choice(ACGT, size=6000))], 4, 10
    rng = np.random.default_rng(21)
    rng.choice(ACGT, size=6000)
    rep = np.tile(rng.choice(ACGT, size=700), 10)
    muts = rng.integers(0, rep.size, size=25)
    rep[muts] = ACGT[rng.integers(0, 4, size=25)]
    return [("r", rep)], 4, 12


def _fresh_jax_programs(monkeypatch):
    """The JAX package reads PFBWT_DBL_SUBSET and PFBWT_DBL_INV while it
    traces, and its program caches are not keyed by them: empty them, so
    that its run honours the variable under test."""
    for name in ("_parse_jits", "_final_jits", "_prep_jits", "_emit_jits"):
        monkeypatch.setattr(jfused, name, {})
    monkeypatch.setattr(jstream, "_state_jits", {})
    monkeypatch.setenv("PFBWT_AOT_DIR", "")


def _assert_fused_equal(records, w, p):
    """The port's fused build against the JAX package's no-fetch run: the
    true BWT and SA, and the checksum over both padded buffers."""
    got, info = tfused.pfbwt_fused_records(
        records, ParserParams(w=w, p=p), device="cpu", want_sa=True,
        want_rssa=True,
    )
    (bwt_d, sa_d), checksum = jfused.pfbwt_fused_records(
        records, JParams(w=w, p=p), fetch=False)
    total = got.bwt.shape[0]
    assert got.bwt.tobytes() == np.asarray(bwt_d)[:total].tobytes()
    assert np.array_equal(got.sa[1:], np.asarray(sa_d)[1:total])
    assert info["checksum"] == checksum
    return info


ENGINES = [
    ("PFBWT_SORT_IMPL", "radix"), ("PFBWT_FANOUT", "scatter"),
    ("PFBWT_FANOUT", "merge"), ("PFBWT_DICT_KEYS", "acgt3"),
    ("PFBWT_DBL_SUBSET", "4"), ("PFBWT_DBL_INV", "scatter"),
    ("PFBWT_J3_SPLIT", "1"), ("PFBWT_EMIT_WIDE", "1"),
    ("PFBWT_SCAN_IMPL", "xla"),
]


@pytest.mark.parametrize("var,value", ENGINES,
                         ids=[f"{v}={x}" for v, x in ENGINES])
def test_fused_engine_equals_jax(monkeypatch, var, value):
    _fresh_jax_programs(monkeypatch)
    monkeypatch.setenv(var, value)
    info = _assert_fused_equal(*_case("random"))
    if var == "PFBWT_DICT_KEYS":
        assert info["alphabet"] == "acgt3"
    if var == "PFBWT_DBL_SUBSET":
        assert tsuf.rounds["dict_sa_subset"] >= 1


@pytest.mark.parametrize("fanout", ["scatter", "merge"])
@pytest.mark.parametrize("impl", ["lax", "radix"])
def test_fused_fanout_and_sort_on_repeats(monkeypatch, fanout, impl):
    """Duplicate phrases give many zero-count suffixes (equal-first
    markers); the padded lanes of the final sort differ between the
    single-key and the two-key (radix) sorts, and the checksum sees
    them."""
    _fresh_jax_programs(monkeypatch)
    monkeypatch.setenv("PFBWT_FANOUT", fanout)
    monkeypatch.setenv("PFBWT_SORT_IMPL", impl)
    _assert_fused_equal(*_case("repeats"))


def test_radix_changes_the_padded_lanes_only(monkeypatch):
    """PFBWT_SORT_IMPL=radix with the scatter fan-out: the same files as
    the default, another checksum (the padded lanes), in both packages."""
    records, w, p = _case("random6000")
    monkeypatch.setenv("PFBWT_FANOUT", "scatter")
    base, binfo = tfused.pfbwt_fused_records(
        records, ParserParams(w=w, p=p), device="cpu", want_sa=True)
    monkeypatch.setenv("PFBWT_SORT_IMPL", "radix")
    radix, rinfo = tfused.pfbwt_fused_records(
        records, ParserParams(w=w, p=p), device="cpu", want_sa=True)
    assert base.bwt.tobytes() == radix.bwt.tobytes()
    assert np.array_equal(base.sa, radix.sa)
    assert binfo["checksum"] != rinfo["checksum"]


def test_acgt3_falls_back_to_bytes_on_other_symbols(monkeypatch):
    """acgt3 needs pure ACGT input; anything else keeps byte keys."""
    monkeypatch.setenv("PFBWT_DICT_KEYS", "acgt3")
    C = np.frombuffer(b"ACGTNACGT", np.uint8)
    assert tfused.dict_alphabet(C) == jfused.dict_alphabet(C) == "byte"
    C = np.frombuffer(b"ACGTACGT", np.uint8)
    assert tfused.dict_alphabet(C) == jfused.dict_alphabet(C) == "acgt3"
    empty = np.zeros(0, np.uint8)
    assert tfused.dict_alphabet(empty) == jfused.dict_alphabet(empty)
    monkeypatch.delenv("PFBWT_DICT_KEYS")
    assert tfused.dict_alphabet(C) == "byte"


@pytest.mark.parametrize("max_len,w", [(1, 4), (9, 4), (40, 10), (900, 15)])
def test_capture_levels_equal_jax(max_len, w):
    for alphabet in ("byte", "acgt3"):
        assert (tfused.capture_levels(max_len, w, alphabet)
                == jfused.capture_levels(max_len, w, alphabet))


def _stream_files(fn, C, w, p, **kw):
    bwt_fp, sa_fp = io.BytesIO(), io.BytesIO()
    out = fn(C, w, p, bwt_fp=bwt_fp, sa_fp=sa_fp, want_rssa=True, **kw)
    return bwt_fp.getvalue(), sa_fp.getvalue(), out


@pytest.mark.parametrize("env", [
    {"PFBWT_DICT_KEYS": "acgt3"},
    {"PFBWT_J2_STREAM": "1", "PFBWT_J2_CHUNK": str(1 << 14)},
    {"PFBWT_J2_STREAM": "0"},
], ids=["acgt3", "j2_stream_chunk", "j2_mono"])
def test_streamed_engine_equals_jax(monkeypatch, env):
    """The streamed build (--fused -m) under PFBWT_DICT_KEYS and the J2
    switch variables, which the port reads where its j2_stream /
    j2_chunk keywords are not given."""
    _fresh_jax_programs(monkeypatch)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    records, w, p = _case("random")
    C, _, _ = build_stream(records, ParserParams(w=w, p=p))
    info = {}
    got = _stream_files(tstream.pfbwt_fused_stream, C, w, p,
                        chunk_target=512, device="cpu", info=info)
    want = _stream_files(jstream.pfbwt_fused_stream, C, w, p,
                         chunk_target=512)
    assert got[:2] == want[:2] and got[2][:3] == want[2][:3]
    assert np.array_equal(got[2][3], want[2][3])
    assert np.array_equal(got[2][4], want[2][4])
    assert info["j2_stream"] == (env.get("PFBWT_J2_STREAM") == "1")
    if "PFBWT_J2_CHUNK" in env:
        # 1 << 14 positions a chunk: the padded input spans several
        assert info["n_b"] >= 4 << 14
    assert info["alphabet"] == ("acgt3" if "PFBWT_DICT_KEYS" in env
                                else "byte")


def test_scan_impl_pallas_maps_to_the_default(monkeypatch):
    """PFBWT_SCAN_IMPL picks the JAX package's cut-scan program; the port
    always runs K1 on a card and the plain scan on the CPU, so with
    ``pallas`` its files equal the JAX default's (whose Pallas kernel
    does not run on the CPU)."""
    records, w, p = _case("random6000")
    want, _ = jfused.pfbwt_fused_records(records, JParams(w=w, p=p),
                                         want_sa=True)
    monkeypatch.setenv("PFBWT_SCAN_IMPL", "pallas")
    got, _ = tfused.pfbwt_fused_records(records, ParserParams(w=w, p=p),
                                        device="cpu", want_sa=True)
    assert got.bwt.tobytes() == want.bwt.tobytes()
    assert np.array_equal(got.sa, want.sa)


def test_engine_variables_are_read_at_each_call(monkeypatch):
    for var in ("PFBWT_SORT_IMPL", "PFBWT_FANOUT", "PFBWT_DBL_SUBSET"):
        monkeypatch.delenv(var, raising=False)
    assert (tsuf.sort_impl(), tsuf.fanout_impl(), tsuf.subset_divisor()) \
        == ("lax", "fill", 0)
    monkeypatch.setenv("PFBWT_SORT_IMPL", "RADIX")
    monkeypatch.setenv("PFBWT_FANOUT", "Merge")
    monkeypatch.setenv("PFBWT_DBL_SUBSET", "8")
    assert (tsuf.sort_impl(), tsuf.fanout_impl(), tsuf.subset_divisor()) \
        == ("radix", "merge", 8)
