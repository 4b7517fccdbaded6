"""pfbwtf_tpu's engine variables below the builds, which the port does
not read: the JAX package's dict doubling under its subset schedule and
its staged device assembly under each fan-out, sort engine and key
packing write the port's one engine's output.  Then the stage variables
of the dedup, the parse-BWT and the SA->MA permute, each against
pfbwtf_tpu with the same variable set.  All on the CPU; every comparison
is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfbwtf_tpu.markers.ma import write_marker_array as jax_write_ma
from pfbwtf_tpu.ops import bwt_jax
from pfbwtf_tpu.ops import suffix as jsuf
from pfbwtf_tpu.ops.bwt_jax import assemble_bwt_jax
from pfbwtf_tpu.ops.parse import ParserParams as JParams, parse_records
from pfbwtf_tpu.ops.parse_bwt import bwt_of_parse_device
from pfbwtf_tpu_torch import engine
from pfbwtf_tpu_torch.markers import ma as tma
from pfbwtf_tpu_torch.ops import bwt_dev, suffix as tsuf
from pfbwtf_tpu_torch.ops.bwt_dev import assemble_bwt_dev
from pfbwtf_tpu_torch.ops.parse import ParserParams
from pfbwtf_tpu_torch.ops.parse_bwt import bwt_of_parse_device as t_pbwt
from pfbwtf_tpu_torch.parallel import dict_union

from .torch_inputs import ACGT, repeat_dict, stage3_inputs


@pytest.mark.parametrize("div", [2, 4, 8])
def test_full_width_doubling_equals_jax_subset_schedule(monkeypatch, div):
    """Under PFBWT_DBL_SUBSET=N the JAX package runs full-width rounds
    until at most max(n // N, 4096) lanes are unresolved, then subset
    rounds; its (order, rank, C1, C2) are the port's full-width ones."""
    dfp = repeat_dict()
    keys, k0 = tsuf.packed_dict_keys(torch.from_numpy(dfp), 10)
    suf_len = bwt_dev.dict_sort_part(torch.from_numpy(dfp), 10)[3]
    got = tsuf.doubling_with_captures(keys, suf_len, k0)
    monkeypatch.setenv("PFBWT_DBL_SUBSET", str(div))
    want = jsuf.doubling_with_captures(
        jnp.asarray(keys.numpy()), None, jnp.asarray(suf_len.numpy()), k0=k0)
    for g, x in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(x))


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
def test_assemble_bwt_dev_equals_jax_under_its_engines(monkeypatch, env):
    """The port's stage 3 against the JAX package's under each of its
    engine variables, set for the JAX call alone."""
    args = stage3_inputs()
    got = assemble_bwt_dev(*args, device="cpu", want_sa=True, want_rssa=True)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    if "PFBWT_DICT_KEYS" in env:
        assert bwt_jax.dict_alphabet_of_bytes(args[0]) == "acgt3"
    want = assemble_bwt_jax(*args, want_sa=True, want_rssa=True)
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
