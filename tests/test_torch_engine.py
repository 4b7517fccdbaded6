"""The staged build's stages in the port (pfbwtf_tpu_torch/engine.py and
the modules under it) against pfbwtf_tpu's engine: its numpy (host)
paths and its JAX device paths, on the CPU."""

import numpy as np
import pytest

from pfbwtf_tpu import engine as jax_engine
from pfbwtf_tpu.ops import bwt as jax_bwt
from pfbwtf_tpu.ops import parse as jax_parse
from pfbwtf_tpu.ops.bwt_jax import assemble_bwt_jax
from pfbwtf_tpu.ops.parse_bwt import bwt_of_parse
from pfbwtf_tpu.ops.parse_bwt import bwt_of_parse_device as jax_pb_device
from pfbwtf_tpu.parallel import dict_union as jax_du
from pfbwtf_tpu_torch import engine
from pfbwtf_tpu_torch.ops import parse as port_parse
from pfbwtf_tpu_torch.ops.bwt_dev import assemble_bwt_dev
from pfbwtf_tpu_torch.ops.parse_bwt import bwt_of_parse_device
from pfbwtf_tpu_torch.parallel.dict_union import dedup_rank_device

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _records(seed, unit_len=3000, copies=4, nmut=30):
    """A small pan-genome: mutated copies of one random unit, one record
    each, the first with lower case and 'N'."""
    rng = np.random.default_rng(seed)
    unit = rng.choice(ACGT, size=unit_len)
    recs = []
    for i in range(copies):
        hap = unit.copy()
        pos = rng.integers(0, hap.size, size=nmut)
        hap[pos] = ACGT[rng.integers(0, 4, size=nmut)]
        if i == 0:
            hap[:20] = np.frombuffer(b"acgtn" * 4, np.uint8)
        recs.append((f"hap{i}", hap))
    return recs


CASES = [(11, 10, 100), (12, 6, 17), (13, 4, 7)]


def _assert_parse_equal(got, want):
    assert got.n == want.n and got.nseqs == want.nseqs
    for f in ("text", "dict_starts", "dict_lens", "occs", "parse_ranks",
              "last", "sai"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        assert np.array_equal(a, b), f
    assert got.doc_names == want.doc_names
    assert got.doc_starts == want.doc_starts
    assert np.array_equal(got.dict_flat(), want.dict_flat())


@pytest.mark.parametrize("seed,w,p", CASES)
def test_parse_records_equals_jax_engine(seed, w, p):
    """Dict starts and lengths, occs, ranks, last and sai: the port's
    device parse (cut scan + device dedup) against the JAX engine's host
    path and its device path."""
    params = port_parse.ParserParams(w=w, p=p, get_sai=True, store_docs=True)
    jparams = jax_parse.ParserParams(w=w, p=p, get_sai=True, store_docs=True)
    recs = _records(seed)
    got = engine.parse_records(recs, params, device="cpu")
    _assert_parse_equal(got, jax_engine.parse_records(recs, jparams,
                                                      backend="numpy"))
    _assert_parse_equal(got, jax_engine.parse_records(recs, jparams,
                                                      backend="jax"))


@pytest.mark.parametrize("seed,w,p", CASES)
def test_dedup_rank_device_equals_jax(seed, w, p):
    C, _, _ = jax_parse.build_stream(_records(seed),
                                     jax_parse.ParserParams(w=w, p=p))
    starts, ends = jax_parse.parse_stream_np(C, jax_parse.ParserParams(w=w,
                                                                       p=p))
    T = jax_parse._tprime(C, w)
    info = {}
    got = dedup_rank_device(T, starts, ends, device="cpu", info=info)
    want = jax_du.dedup_rank_device(T, starts, ends)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # and the port's host dedup (native rank or numpy) agrees
    for a, b in zip(port_parse._dedup_and_rank(T, starts, ends), want):
        assert np.array_equal(a, b)
    lens = ends - starts + 1
    assert info["dedup_ncols"] == -(-int(lens.max()) // 8)
    assert info["dedup_rows_bytes"] == starts.shape[0] * info["dedup_ncols"] * 8


def test_host_dedup_numpy_path_equals_native(monkeypatch):
    """Without the native kernel the numpy dedup gives the same arrays."""
    from pfbwtf_tpu_torch import native

    w, p = 6, 17
    C, _, _ = jax_parse.build_stream(_records(14),
                                     jax_parse.ParserParams(w=w, p=p))
    starts, ends = jax_parse.parse_stream_np(C, jax_parse.ParserParams(w=w,
                                                                       p=p))
    T = jax_parse._tprime(C, w)
    want = jax_du.dedup_rank_device(T, starts, ends)
    monkeypatch.setattr(native, "available", lambda: False)
    for a, b in zip(port_parse._dedup_and_rank(T, starts, ends), want):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("seed,w,p", CASES)
@pytest.mark.parametrize("get_sai", [True, False])
def test_bwt_of_parse_device_equals_jax(seed, w, p, get_sai):
    res = jax_parse.parse_records(_records(seed),
                                  jax_parse.ParserParams(w=w, p=p))
    got = bwt_of_parse_device(res.parse_ranks, res.last, res.sai,
                              get_sai=get_sai, device="cpu")
    for want in (
        jax_pb_device(res.parse_ranks, res.last, res.sai, get_sai=get_sai),
        bwt_of_parse(res.parse_ranks, res.last, res.sai, get_sai=get_sai),
    ):
        for f in ("bwlast", "ilist", "bwsai", "bwt_sym"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype, f
            assert np.array_equal(a, b), f


@pytest.mark.parametrize("seed,w,p", CASES)
def test_engine_parse_bwt_takes_a_parse_result(seed, w, p):
    params = port_parse.ParserParams(w=w, p=p, get_sai=True)
    res = engine.parse_records(_records(seed), params, device="cpu")
    got = engine.parse_bwt(res, device="cpu")
    want = bwt_of_parse(res.parse_ranks, res.last, res.sai)
    assert np.array_equal(got.ilist, want.ilist)
    assert np.array_equal(got.bwsai, want.bwsai)


def _stage3_inputs(seed, w, p):
    res = jax_parse.parse_records(_records(seed),
                                  jax_parse.ParserParams(w=w, p=p))
    pb = bwt_of_parse(res.parse_ranks, res.last, res.sai)
    return (res.dict_flat(), w, res.occs.astype(np.int64), pb.bwlast,
            pb.ilist, pb.bwsai, res.n)


@pytest.mark.parametrize("seed,w,p", CASES)
@pytest.mark.parametrize("want_sa,want_rssa,sa_dtype", [
    (True, True, np.uint64), (True, False, np.uint32),
    (False, True, np.uint32), (False, False, np.uint64),
], ids=["sa-rssa-u64", "sa-u32", "rssa-u32", "bwt-only"])
def test_assemble_bwt_dev_equals_jax_and_numpy(seed, w, p, want_sa,
                                               want_rssa, sa_dtype):
    args = _stage3_inputs(seed, w, p)
    kw = dict(want_sa=want_sa, want_rssa=want_rssa, sa_dtype=sa_dtype)
    got = assemble_bwt_dev(*args, device="cpu", **kw)
    for want in (assemble_bwt_jax(*args, **kw),
                 jax_bwt.assemble_bwt(*args, **kw)):
        assert got.nruns == want.nruns
        assert np.array_equal(got.bwt, want.bwt)
        for f in ("sa", "ssa", "esa"):
            a, b = getattr(got, f), getattr(want, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert a.dtype == b.dtype, f
                assert np.array_equal(a, b), f


def test_assemble_bwt_dev_without_bwsai():
    """bwsai=None (a build without -s/-r) gives the same BWT."""
    dict_flat, w, occs, bwlast, ilist, bwsai, n = _stage3_inputs(11, 10, 100)
    got = assemble_bwt_dev(dict_flat, w, occs, bwlast, ilist, None, n,
                           device="cpu")
    want = jax_bwt.assemble_bwt(dict_flat, w, occs, bwlast, ilist, bwsai, n)
    assert np.array_equal(got.bwt, want.bwt) and got.sa is None


def test_assemble_bwt_dev_rejects_an_unterminated_dict():
    with pytest.raises(ValueError, match="separator"):
        assemble_bwt_dev(np.frombuffer(b"ACGT", np.uint8), 2,
                         np.ones(1, np.int64), np.zeros(2, np.uint8),
                         np.arange(2), None, 3, device="cpu")
