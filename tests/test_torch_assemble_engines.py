"""The opt-in engines below the builds: the dict doubling's key packings
and subset schedule, the staged build's device assembly under every
fan-out, sort engine and key packing, and the stage variables of the
dedup, the parse-BWT and the SA->MA permute, each against pfbwtf_tpu
with the same variable set.  All on the CPU; every comparison is
exact."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfbwtf_tpu.markers.ma import write_marker_array as jax_write_ma
from pfbwtf_tpu.ops import bwt_jax
from pfbwtf_tpu.ops import suffix as jsuf
from pfbwtf_tpu.ops.bwt_jax import assemble_bwt_jax
from pfbwtf_tpu.ops.parse import ParserParams as JParams, parse_records
from pfbwtf_tpu.ops.parse_bwt import bwt_of_parse, bwt_of_parse_device
from pfbwtf_tpu_torch import engine
from pfbwtf_tpu_torch.markers import ma as tma
from pfbwtf_tpu_torch.ops import bwt_dev, suffix as tsuf
from pfbwtf_tpu_torch.ops.bwt_dev import assemble_bwt_dev
from pfbwtf_tpu_torch.ops.parse import ParserParams
from pfbwtf_tpu_torch.ops.parse_bwt import bwt_of_parse_device as t_pbwt
from pfbwtf_tpu_torch.parallel import dict_union

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _repeat_dict(seed=70, nwords=1500, w=10):
    """A dict-shaped byte array whose words are substrings of one random
    unit: long shared prefixes, so the doubling takes several rounds and
    many lanes stay unresolved at first.  EndOfWord after each word, the
    EndOfDict terminator and pads to the JAX bucket."""
    rng = np.random.default_rng(seed)
    unit = rng.choice(ACGT, size=2000)
    parts = []
    for _ in range(nwords):
        s = int(rng.integers(0, 1900))
        parts.append(unit[s: s + int(rng.integers(w + 1, 90))])
        parts.append(np.ones(1, np.uint8))
    flat = np.concatenate(parts + [np.zeros(1, np.uint8)])
    out = np.zeros(bwt_jax._bucket(flat.shape[0]), np.uint8)
    out[: flat.shape[0]] = flat
    return out


def _captures(dfp, w, alphabet, n_levels=None):
    """The port's and the JAX package's doubling_with_captures outputs
    on the same keys, fingerprint word and capture lengths."""
    keys, k0, fp = tsuf.packed_dict_keys(torch.from_numpy(dfp), w, alphabet)
    _, t_min, _ = tsuf.dict_key_plan(w, alphabet)
    suf_len = bwt_dev.dict_sort_part(torch.from_numpy(dfp), w)[3]
    got = tsuf.doubling_with_captures(keys, suf_len, k0, n_levels=n_levels,
                                      fp_word=fp, t_min=t_min)
    jfp = None if fp is None else jnp.asarray(fp.numpy())
    want = jsuf.doubling_with_captures(
        jnp.asarray(keys.numpy()), None, jnp.asarray(suf_len.numpy()),
        k0=k0, n_levels=n_levels, fp_word=jfp, t_min=t_min,
    )
    return got, want


@pytest.mark.parametrize("w", [1, 4, 10, 15])
def test_acgt3_keys_and_plan_equal_jax(w):
    dfp = _repeat_dict(w=w)
    got, k0, fp = tsuf.packed_dict_keys(torch.from_numpy(dfp), w, "acgt3")
    want, jk0, jfp = jsuf.packed_dict_keys(jnp.asarray(dfp), w, "acgt3")
    assert k0 == jk0 == 16
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(fp.numpy(), np.asarray(jfp))
    for alphabet in ("byte", "acgt3"):
        assert tsuf.dict_key_plan(w, alphabet) == jsuf.dict_key_plan(
            w, alphabet)


@pytest.mark.parametrize("w,n_levels", [(4, None), (4, 3), (10, None)])
def test_doubling_with_fingerprint_rows_equals_jax(w, n_levels):
    """acgt3: the fingerprint rows serve the capture levels below k0
    (n_fp = 2 at w=4, 1 at w=10), including a table too short for the
    longest suffixes."""
    got, want = _captures(_repeat_dict(w=w), w, "acgt3", n_levels)
    for g, x in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(x))


@pytest.mark.parametrize("div", [2, 4, 8])
@pytest.mark.parametrize("alphabet", ["byte", "acgt3"])
def test_subset_doubling_equals_jax(monkeypatch, div, alphabet):
    """PFBWT_DBL_SUBSET=N: full-width rounds until at most
    max(n // N, 4096) lanes are unresolved, then subset rounds; (order,
    rank, C1, C2) equal the JAX package's under the same setting and the
    full-width schedule's."""
    dfp = _repeat_dict()
    base, _ = _captures(dfp, 10, alphabet)
    full_rounds = tsuf.rounds["dict_sa"]
    monkeypatch.setenv("PFBWT_DBL_SUBSET", str(div))
    got, want = _captures(dfp, 10, alphabet)
    for g, x, b in zip(got, want, base):
        assert np.array_equal(g.numpy(), np.asarray(x))
        assert torch.equal(g, b)
    assert tsuf.rounds["dict_sa"] == full_rounds
    assert 1 <= tsuf.rounds["dict_sa_subset"] <= full_rounds


def test_subset_doubling_runs_both_phases(monkeypatch):
    """At n // 8 the first rounds stay full width, the rest are subset
    rounds."""
    dfp = _repeat_dict(nwords=3000)
    monkeypatch.setenv("PFBWT_DBL_SUBSET", "8")
    _captures(dfp, 10, "byte")
    assert 0 < tsuf.rounds["dict_sa_subset"] < tsuf.rounds["dict_sa"]


def _stage3_inputs(seed=22, size=5000, w=4, p=9):
    """The stage 3 inputs of tests/test_fused.py:165-177."""
    rng = np.random.default_rng(seed)
    seq = rng.choice(ACGT, size=size)
    res = parse_records([("s", seq)], JParams(w=w, p=p, get_sai=True))
    pb = bwt_of_parse(res.parse_ranks, res.last, res.sai, get_sai=True)
    return (res.dict_flat(), w, res.occs.astype(np.int64), pb.bwlast,
            pb.ilist, pb.bwsai, res.n)


def _assert_result_equal(got, want):
    assert got.nruns == want.nruns
    assert got.bwt.tobytes() == want.bwt.tobytes()
    for f in ("sa", "ssa", "esa"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


STAGE3 = [
    {}, {"PFBWT_FANOUT": "scatter"}, {"PFBWT_FANOUT": "merge"},
    {"PFBWT_SORT_IMPL": "radix"},
    {"PFBWT_SORT_IMPL": "radix", "PFBWT_FANOUT": "scatter"},
    {"PFBWT_SORT_IMPL": "radix", "PFBWT_FANOUT": "merge"},
    {"PFBWT_EMIT_WIDE": "1", "PFBWT_FANOUT": "scatter"},
    {"PFBWT_EMIT_WIDE": "1", "PFBWT_FANOUT": "merge"},
    {"PFBWT_DICT_KEYS": "acgt3"},
    {"PFBWT_DICT_KEYS": "acgt3", "PFBWT_FANOUT": "merge"},
]


@pytest.mark.parametrize("env", STAGE3,
                         ids=["-".join(f"{k[6:]}={v}" for k, v in e.items())
                              or "default" for e in STAGE3])
def test_assemble_bwt_dev_engines_equal_jax(monkeypatch, env):
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    args = _stage3_inputs()
    if "PFBWT_DICT_KEYS" in env:
        assert bwt_dev.dict_alphabet_of_bytes(args[0]) == "acgt3"
    got = assemble_bwt_dev(*args, device="cpu", want_sa=True, want_rssa=True)
    want = assemble_bwt_jax(*args, want_sa=True, want_rssa=True)
    _assert_result_equal(got, want)


def test_dict_alphabet_of_bytes_equals_jax(monkeypatch):
    df = np.frombuffer(b"ACGT\x01AC\x02GT\x01\x00", np.uint8)
    other = np.frombuffer(b"ACNT\x01\x00", np.uint8)
    assert bwt_dev.dict_alphabet_of_bytes(df) == "byte"
    monkeypatch.setenv("PFBWT_DICT_KEYS", "acgt3")
    for d, want in ((df, "acgt3"), (other, "byte")):
        assert bwt_dev.dict_alphabet_of_bytes(d) == want
        assert bwt_jax.dict_alphabet_of_bytes(d) == want


def _warned(fn, *args, **kw):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = fn(*args, **kw)
    return out, [str(x.message) for x in rec]


def test_fill_ineligible_warns_as_jax(monkeypatch):
    """PFBWT_FANOUT=fill with the wide sort forced: both packages warn
    with the same message and take the scatter fan-out."""
    monkeypatch.setenv("PFBWT_FANOUT", "fill")
    monkeypatch.setenv("PFBWT_EMIT_WIDE", "1")
    args = _stage3_inputs(seed=24, size=3000)
    got, gmsg = _warned(assemble_bwt_dev, *args, device="cpu", want_sa=True)
    want, jmsg = _warned(assemble_bwt_jax, *args, want_sa=True)
    assert [m for m in gmsg if "ineligible" in m] == \
        [m for m in jmsg if "ineligible" in m]
    assert any("fill ineligible" in m for m in gmsg)
    _assert_result_equal(got, want)


def test_merge_ineligible_warns_and_takes_scatter(monkeypatch):
    """Past MERGE_MAX_LANES the merge fan-out warns with the JAX package's
    message and gives the scatter fan-out's output (the limit is lowered
    here: 2**30 lanes do not fit a test)."""
    args = _stage3_inputs()
    monkeypatch.setenv("PFBWT_FANOUT", "scatter")
    want = assemble_bwt_jax(*args, want_sa=True, want_rssa=True)
    monkeypatch.setenv("PFBWT_FANOUT", "merge")
    monkeypatch.setattr(bwt_dev, "MERGE_MAX_LANES", 1024)
    got, msgs = _warned(assemble_bwt_dev, *args, device="cpu", want_sa=True,
                        want_rssa=True)
    assert "PFBWT_FANOUT=merge ineligible (nsuf_b + total_b >= 2^30); " \
        "using the scatter engine" in msgs
    _assert_result_equal(got, want)


@pytest.mark.parametrize("seed,w,p", [(31, 4, 10), (32, 10, 100)])
def test_parse_bwt_radix_maps_to_the_default(monkeypatch, seed, w, p):
    """PFBWT_SORT_IMPL=radix in the JAX parse-BWT (radix doubling and
    ilist argsort) gives the port's bytes, which ignore it."""
    rng = np.random.default_rng(seed)
    res = parse_records([("s", rng.choice(ACGT, size=20000))],
                        JParams(w=w, p=p, get_sai=True))
    got = t_pbwt(res.parse_ranks, res.last, res.sai, device="cpu")
    monkeypatch.setenv("PFBWT_SORT_IMPL", "radix")
    want = bwt_of_parse_device(res.parse_ranks, res.last, res.sai)
    for f in ("bwlast", "ilist", "bwsai"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("value,host", [("host", True), ("numpy", True),
                                        ("jax", False), (None, False)])
def test_dict_impl_selects_the_dedup(monkeypatch, value, host):
    """PFBWT_DICT_IMPL, read at each call: host or numpy runs the native
    host dedup, jax or none the device dedup; the parse equals the JAX
    package's either way."""
    if value is None:
        monkeypatch.delenv("PFBWT_DICT_IMPL", raising=False)
    else:
        monkeypatch.setenv("PFBWT_DICT_IMPL", value)
    calls = []
    real = dict_union.dedup_rank_device

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(dict_union, "dedup_rank_device", counted)
    rng = np.random.default_rng(33)
    recs = [("a", rng.choice(ACGT, size=4000)),
            ("b", rng.choice(ACGT, size=2500))]
    got = engine.parse_records(recs, ParserParams(w=4, p=10, get_sai=True),
                               device="cpu")
    want = parse_records(recs, JParams(w=4, p=10, get_sai=True))
    assert bool(calls) != host
    assert np.array_equal(got.dict_flat(), want.dict_flat())
    assert np.array_equal(got.parse_ranks, want.parse_ranks)
    assert np.array_equal(np.asarray(got.occs, np.int64),
                          np.asarray(want.occs, np.int64))


@pytest.mark.parametrize("value,host", [("numpy", True), ("jax", False),
                                        (None, False)])
def test_ma_backend_selects_the_permute(monkeypatch, tmp_path, value, host):
    """PFBWT_MA_BACKEND, read at each call: numpy runs the host permute,
    jax or none the device permute; the .ma equals the JAX package's
    under the same setting."""
    from pfbwtf_tpu_torch.markers import mps

    if value is None:
        monkeypatch.delenv("PFBWT_MA_BACKEND", raising=False)
    else:
        monkeypatch.setenv("PFBWT_MA_BACKEND", value)
    calls = []
    real = tma.marker_array_from_sa

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tma, "marker_array_from_sa", counted)
    rng = np.random.default_rng(67)
    edges = np.sort(rng.choice(np.arange(1, 900), size=40, replace=False))
    lists = [np.array(rng.integers(1, 1 << 50, size=k), np.uint64)
             for k in (1, 2)]
    with open(tmp_path / "x.mps", "wb") as f:
        mps.write_mps_runs(f, edges[0::2].astype(np.uint64),
                           edges[1::2].astype(np.uint64),
                           [lists[i % 2] for i in range(20)])
    sa = rng.permutation(1000).astype(np.uint64)
    tma.write_marker_array(str(tmp_path / "x.mps"), sa,
                           str(tmp_path / "port.ma"), device="cpu")
    jax_write_ma(str(tmp_path / "x.mps"), sa, str(tmp_path / "jax.ma"))
    assert bool(calls) == host
    want = (tmp_path / "jax.ma").read_bytes()
    assert len(want) > 0 and (tmp_path / "port.ma").read_bytes() == want
