"""pfbwtf_tpu's engine variables (ROADMAP M12) against the port's fused
and streamed builds, which read none of them: with a variable set for
the JAX package alone, its output equals the port's byte for byte, the
checksum over the padded buffers included wherever the JAX package keeps
its default final sort; with all of them set, every build entry of the
port runs as without them.  All on the CPU; every comparison is exact."""

import io

import numpy as np
import pytest

from pfbwtf_tpu.ops import fused as jfused
from pfbwtf_tpu.ops import fused_stream as jstream
from pfbwtf_tpu.ops.parse import ParserParams as JParams
from pfbwtf_tpu_torch.ops import fused as tfused
from pfbwtf_tpu_torch.ops import fused_stream as tstream
from pfbwtf_tpu_torch.ops import suffix as tsuf
from pfbwtf_tpu_torch.ops.bwt_dev import assemble_bwt_dev
from pfbwtf_tpu_torch.ops.parse import ParserParams, build_stream

from .torch_inputs import records as _case, stage3_inputs


def _fresh_jax_programs(monkeypatch):
    """The JAX package reads PFBWT_DBL_SUBSET and PFBWT_DBL_INV while it
    traces, and its program caches are not keyed by them: empty them, so
    that its run honours the variable under test."""
    for name in ("_parse_jits", "_final_jits", "_prep_jits", "_emit_jits"):
        monkeypatch.setattr(jfused, name, {})
    monkeypatch.setattr(jstream, "_state_jits", {})
    monkeypatch.setenv("PFBWT_AOT_DIR", "")


def _assert_fused_equal(monkeypatch, records, w, p, env, checksum=True):
    """The port's fused build against the JAX package's no-fetch run under
    the variables ``env``: the true BWT and SA, and with ``checksum`` the
    checksum over both padded buffers."""
    got, info = tfused.pfbwt_fused_records(
        records, ParserParams(w=w, p=p), device="cpu", want_sa=True,
        want_rssa=True,
    )
    _fresh_jax_programs(monkeypatch)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    (bwt_d, sa_d), jchecksum = jfused.pfbwt_fused_records(
        records, JParams(w=w, p=p), fetch=False)
    total = got.bwt.shape[0]
    assert got.bwt.tobytes() == np.asarray(bwt_d)[:total].tobytes()
    assert np.array_equal(got.sa[1:], np.asarray(sa_d)[1:total])
    if checksum:
        assert info["checksum"] == jchecksum


ENGINES = [
    ("PFBWT_SORT_IMPL", "radix"), ("PFBWT_FANOUT", "scatter"),
    ("PFBWT_FANOUT", "merge"), ("PFBWT_DICT_KEYS", "acgt3"),
    ("PFBWT_DBL_SUBSET", "4"), ("PFBWT_DBL_INV", "scatter"),
    ("PFBWT_J3_SPLIT", "1"), ("PFBWT_EMIT_WIDE", "1"),
    ("PFBWT_SCAN_IMPL", "xla"),
]


@pytest.mark.parametrize("var,value", ENGINES,
                         ids=[f"{v}={x}" for v, x in ENGINES])
def test_fused_equals_jax_under_engine_variable(monkeypatch, var, value):
    _assert_fused_equal(monkeypatch, *_case("random"), {var: value})


@pytest.mark.parametrize("fanout", ["scatter", "merge"])
@pytest.mark.parametrize("impl", ["lax", "radix"])
def test_fused_on_repeats_equals_jax_fanout_and_sort(monkeypatch, fanout,
                                                     impl):
    """Duplicate phrases give many zero-count suffixes (equal-first
    markers).  The JAX package's two-key (radix) final sort orders the
    padded lanes otherwise than its single-key sort, so the checksum is
    compared under lax only."""
    _assert_fused_equal(monkeypatch, *_case("repeats"),
                        {"PFBWT_FANOUT": fanout, "PFBWT_SORT_IMPL": impl},
                        checksum=impl == "lax")


@pytest.mark.parametrize("max_len,w", [(1, 4), (9, 4), (40, 10), (900, 15)])
def test_capture_levels_equal_jax(max_len, w):
    want = jfused.capture_levels(max_len, w)
    assert tsuf.capture_levels(max_len, w) == want


def _stream_files(fn, C, w, p, **kw):
    bwt_fp, sa_fp = io.BytesIO(), io.BytesIO()
    out = fn(C, w, p, bwt_fp=bwt_fp, sa_fp=sa_fp, want_rssa=True, **kw)
    return bwt_fp.getvalue(), sa_fp.getvalue(), out


def _assert_stream_equal(got, want):
    assert got[:2] == want[:2] and got[2][:3] == want[2][:3]
    assert np.array_equal(got[2][3], want[2][3])
    assert np.array_equal(got[2][4], want[2][4])


@pytest.mark.parametrize("env,kw", [
    ({"PFBWT_DICT_KEYS": "acgt3"}, {}),
    ({"PFBWT_J2_STREAM": "1", "PFBWT_J2_CHUNK": str(1 << 14)},
     {"j2_stream": True, "j2_chunk": 1 << 14}),
    ({"PFBWT_J2_STREAM": "0"}, {"j2_stream": False}),
], ids=["acgt3", "j2_stream_chunk", "j2_mono"])
def test_streamed_keywords_equal_jax_variables(monkeypatch, env, kw):
    """The streamed build (--fused -m): the port's j2_stream / j2_chunk
    keywords against the JAX package's variables for the same J2, and
    the JAX package's acgt3 keys against the port's byte keys."""
    records, w, p = _case("random")
    C, _, _ = build_stream(records, ParserParams(w=w, p=p))
    info = {}
    got = _stream_files(tstream.pfbwt_fused_stream, C, w, p,
                        chunk_target=512, device="cpu", info=info, **kw)
    _fresh_jax_programs(monkeypatch)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    want = _stream_files(jstream.pfbwt_fused_stream, C, w, p,
                         chunk_target=512)
    _assert_stream_equal(got, want)
    assert info["j2_stream"] == kw.get("j2_stream", False)
    if "j2_chunk" in kw:
        # 1 << 14 positions a chunk: the padded input spans several
        assert info["n_b"] >= 4 << 14


@pytest.mark.parametrize("chunk_target", [512, None])
def test_streamed_on_repeats_equals_jax(chunk_target):
    """Zero-count suffixes in the streamed build, in many emission chunks
    and in one at the default chunk target."""
    records, w, p = _case("repeats")
    C, _, _ = build_stream(records, ParserParams(w=w, p=p))
    kw = {} if chunk_target is None else {"chunk_target": chunk_target}
    info = {}
    got = _stream_files(tstream.pfbwt_fused_stream, C, w, p, device="cpu",
                        info=info, **kw)
    want = _stream_files(jstream.pfbwt_fused_stream, C, w, p, **kw)
    _assert_stream_equal(got, want)
    assert (info["n_chunks"] > 1) == (chunk_target is not None)


ALL_ENGINES = {
    "PFBWT_SORT_IMPL": "radix", "PFBWT_FANOUT": "merge",
    "PFBWT_DICT_KEYS": "acgt3", "PFBWT_DBL_SUBSET": "4",
    "PFBWT_EMIT_WIDE": "1", "PFBWT_J2_STREAM": "1",
    "PFBWT_J2_CHUNK": str(1 << 14), "PFBWT_DBL_INV": "scatter",
    "PFBWT_J3_SPLIT": "1", "PFBWT_SCAN_IMPL": "pallas",
}


@pytest.mark.parametrize("entry", ["fused", "streamed", "stage3"])
def test_port_ignores_every_engine_variable(monkeypatch, entry):
    """With every engine variable of the JAX package set, each build entry
    of the port runs as without them: the same outputs, the checksum and
    the J2 choice included."""
    records, w, p = _case("repeats")

    def run():
        if entry == "fused":
            res, info = tfused.pfbwt_fused_records(
                records, ParserParams(w=w, p=p), device="cpu", want_sa=True,
                want_rssa=True)
            return (res.bwt.tobytes(), res.sa.tobytes(), res.ssa.tobytes(),
                    res.esa.tobytes(), info["checksum"], info["rounds"])
        if entry == "streamed":
            C, _, _ = build_stream(records, ParserParams(w=w, p=p))
            info = {}
            out = _stream_files(tstream.pfbwt_fused_stream, C, w, p,
                                chunk_target=512, device="cpu", info=info)
            return (*out[:2], out[2][:3], out[2][3].tobytes(),
                    out[2][4].tobytes(), info["j2_stream"], info["n_chunks"])
        res = assemble_bwt_dev(*stage3_inputs(), device="cpu", want_sa=True,
                               want_rssa=True)
        return (res.bwt.tobytes(), res.sa.tobytes(), res.ssa.tobytes(),
                res.esa.tobytes())

    want = run()
    for var, value in ALL_ENGINES.items():
        monkeypatch.setenv(var, value)
    assert run() == want
