"""The host assembly path of the port (stages 2 and 3 on the host, as
pfbwtf_tpu runs them by default) against pfbwtf_tpu's host path, and the
backend selection of engine.parse_bwt / engine.assemble_bwt.  Exact
equality throughout."""

import numpy as np
import pytest

from pfbwtf_tpu import native as jax_native
from pfbwtf_tpu.cli import pfbwt_f as jax_cli
from pfbwtf_tpu.ops import bwt as jax_bwt
from pfbwtf_tpu.ops import parse_bwt as jax_parse_bwt
from pfbwtf_tpu.ops import suffix as jax_suffix
from pfbwtf_tpu_torch import engine, native
from pfbwtf_tpu_torch.cli import pfbwt_f
from pfbwtf_tpu_torch.ops import bwt as host_bwt
from pfbwtf_tpu_torch.ops import parse_bwt
from pfbwtf_tpu_torch.ops.bwt_dev import assemble_bwt_dev
from pfbwtf_tpu_torch.ops.parse import ParserParams
from pfbwtf_tpu_torch.ops.suffix_np import suffix_array_ints_np

from .ref_fixtures import random_fasta

ACGT = np.frombuffer(b"ACGT", np.uint8)
BACKEND_VARS = ("PFBWT_BACKEND", "PFBWT_ASSEMBLE_BACKEND")


def _records(seed, unit_len=2500, copies=4, nmut=25):
    rng = np.random.default_rng(seed)
    unit = rng.choice(ACGT, size=unit_len)
    recs = []
    for i in range(copies):
        hap = unit.copy()
        pos = rng.integers(0, hap.size, size=nmut)
        hap[pos] = ACGT[rng.integers(0, 4, size=nmut)]
        recs.append((f"hap{i}", hap))
    return recs


def _int_seq(seed, n, k):
    """n ints in [1, k] and a 0 terminator; small k gives long repeats."""
    rng = np.random.default_rng(seed)
    return np.concatenate((rng.integers(1, k + 1, size=n), [0]))


SEQS = [(1, 1, 1), (2, 7, 1), (3, 500, 2), (4, 3000, 4), (5, 2000, 300)]


@pytest.mark.parametrize("seed,n,k", SEQS)
def test_suffix_array_ints_np_equals_jax(seed, n, k):
    seq = _int_seq(seed, n, k)
    got = suffix_array_ints_np(seq)
    assert np.array_equal(got, jax_suffix.suffix_array_ints_np(seq))
    assert got[0] == n


@pytest.mark.parametrize("seed,n,k", SEQS)
def test_suffix_array_ints_native_equals_jax(seed, n, k):
    if not (native.available() and jax_native.available()):
        pytest.skip("g++ cannot build native/sais.cpp")
    seq = _int_seq(seed, n, k)
    got = native.suffix_array_ints_native(seq)
    assert got.dtype == np.int64
    assert np.array_equal(got, jax_native.suffix_array_ints_native(seq))
    assert np.array_equal(got, suffix_array_ints_np(seq))


@pytest.mark.parametrize("seed", [21, 22])
def test_dict_suffix_sort_native_equals_jax(seed):
    if not (native.available() and jax_native.available()):
        pytest.skip("g++ cannot build native/sais.cpp")
    res = engine.parse_records(_records(seed), ParserParams(w=8, p=11),
                               device="cpu")
    flat = res.dict_flat()
    got = native.dict_suffix_sort_native(flat)
    want = jax_native.dict_suffix_sort_native(flat)
    for a, b in zip(got[:3], want[:3]):
        assert np.array_equal(a, b)
    assert got[3] == want[3]


@pytest.mark.parametrize("seed,w,p", [(23, 8, 11), (24, 10, 100), (25, 4, 5)])
def test_suffix_group_ids_np_equals_jax(seed, w, p):
    """The hash-and-verify suffix groups of a real dict (the staged
    mesh's and the host path's) equal pfbwtf_tpu's."""
    from pfbwtf_tpu_torch.ops.suffix_np import (dict_suffix_sort_np,
                                                suffix_group_ids_np)

    flat = engine.parse_records(_records(seed), ParserParams(w=w, p=p),
                                device="cpu").dict_flat()
    sa, _, suf_len, _ = dict_suffix_sort_np(flat)
    kept = sa[suf_len[sa] > w]
    got = suffix_group_ids_np(flat, kept, suf_len)
    assert np.array_equal(got, jax_suffix.suffix_group_ids_np(flat, kept,
                                                               suf_len))
    assert got[-1] < kept.shape[0] - 1  # some suffixes share a group


# (suffix starts, lengths): every pair of neighbours has one length, so
# with the hashes forced equal each pair is claimed equal and only the
# byte check decides; "ACGTA"/"ACGTC" differ at the last byte of the
# longest pair, "GA"/"GC" at the last byte of the shortest
_TEXT = b"#ACGTA#ACGTA#ACGTC#GA#GA#GC#"
_VERIFY = {
    "equal": ([1, 7, 19, 22], [5, 5, 2, 2], None),
    "longest_last_byte": ([1, 13, 19, 22], [5, 5, 2, 2], AssertionError),
    "shortest_last_byte": ([1, 7, 19, 25], [5, 5, 2, 2], AssertionError),
    "first_byte": ([2, 19], [2, 2], AssertionError),
}


@pytest.mark.parametrize("name", list(_VERIFY))
def test_suffix_group_ids_np_verifies_every_byte(monkeypatch, name):
    """With every hash forced equal, a claimed-equal pair that differs in
    any byte up to its last raises, as pfbwtf_tpu's does, and truly equal
    pairs share their group."""
    from pfbwtf_tpu_torch.ops import suffix_np

    flat = np.frombuffer(_TEXT, np.uint8)
    starts, lens, err = _VERIFY[name]
    suf_len = np.zeros(flat.shape[0], np.int64)
    suf_len[starts] = lens
    kept = np.asarray(starts, np.int64)

    def zero(dict_flat, sl, base):
        return np.zeros(dict_flat.shape[0], np.uint64)

    for mod in (suffix_np, jax_suffix):
        monkeypatch.setattr(mod, "_segmented_suffix_hashes_np", zero)
        if err is None:
            gid = mod.suffix_group_ids_np(flat, kept, suf_len)
            assert gid.tolist() == [0, 0, 1, 1]
        else:
            with pytest.raises(err, match="collision"):
                mod.suffix_group_ids_np(flat, kept, suf_len)


CASES = [(31, 10, 100), (32, 6, 17), (33, 4, 7)]


def _parse(seed, w, p):
    return engine.parse_records(
        _records(seed), ParserParams(w=w, p=p, get_sai=True), device="cpu")


@pytest.mark.parametrize("seed,w,p", CASES)
@pytest.mark.parametrize("get_sai", [True, False])
def test_bwt_of_parse_equals_jax(seed, w, p, get_sai):
    res = _parse(seed, w, p)
    got = parse_bwt.bwt_of_parse(res.parse_ranks, res.last, res.sai,
                                 get_sai=get_sai)
    want = jax_parse_bwt.bwt_of_parse(res.parse_ranks, res.last, res.sai,
                                      get_sai=get_sai)
    for f in ("bwlast", "ilist", "bwsai", "bwt_sym"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    # the numpy doubling gives the same parse-BWT as the native SA-IS
    dbl = parse_bwt.bwt_of_parse(res.parse_ranks, res.last, res.sai,
                                 get_sai=get_sai, sa_fn=suffix_array_ints_np)
    assert np.array_equal(dbl.ilist, got.ilist)


def _stage3_args(res):
    pb = jax_parse_bwt.bwt_of_parse(res.parse_ranks, res.last, res.sai)
    return (res.dict_flat(), res.params.w, res.occs.astype(np.int64),
            pb.bwlast, pb.ilist, pb.bwsai, res.n)


@pytest.mark.parametrize("seed,w,p", CASES)
@pytest.mark.parametrize("want_sa,want_rssa", [(True, True), (True, False),
                                               (False, True),
                                               (False, False)])
@pytest.mark.parametrize("sa_dtype", [np.uint64, np.uint32])
def test_host_assemble_equals_jax_and_device(seed, w, p, want_sa, want_rssa,
                                             sa_dtype):
    args = _stage3_args(_parse(seed, w, p))
    kw = dict(want_sa=want_sa, want_rssa=want_rssa, sa_dtype=sa_dtype)
    got = host_bwt.assemble_bwt(*args, **kw)
    for want in (jax_bwt.assemble_bwt(*args, **kw),
                 assemble_bwt_dev(*args, device="cpu", **kw)):
        assert got.nruns == want.nruns
        for f in ("bwt", "sa", "ssa", "esa"):
            a, b = getattr(got, f), getattr(want, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("seed,w,p", CASES[:1])
def test_host_assemble_int64_path_equals_int32(monkeypatch, seed, w, p):
    """The wide index path (taken past 2**31 - 8 parse-BWT entries) gives
    the same arrays as the int32 one."""
    args = _stage3_args(_parse(seed, w, p))
    want = host_bwt.assemble_bwt(*args, want_sa=True, want_rssa=True)
    layout = host_bwt.suffix_layout
    monkeypatch.setattr(host_bwt, "suffix_layout",
                        lambda *a, **k: layout(*a, **{**k,
                                                      "small_hint": False}))
    got = host_bwt.assemble_bwt(*args, want_sa=True, want_rssa=True)
    for f in ("bwt", "sa", "ssa", "esa"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


# (argument, PFBWT_ASSEMBLE_BACKEND, PFBWT_BACKEND) -> stage 2 / stage 3 on
# the host
SELECTION = [
    ((None, None, None), (False, False)),
    (("numpy", None, None), (True, True)),
    (("jax", "numpy", "numpy"), (False, False)),
    ((None, "numpy", None), (False, True)),
    ((None, None, "numpy"), (True, True)),
    ((None, "jax", "numpy"), (True, False)),
    ((None, None, "jax"), (False, False)),
    (("NumPy", None, None), (True, True)),
]


@pytest.mark.parametrize("setting,host", SELECTION)
def test_backend_selection(monkeypatch, setting, host):
    """The argument, then PFBWT_ASSEMBLE_BACKEND (stage 3 only), then
    PFBWT_BACKEND decide; only "numpy" means the host, and with nothing
    set both stages run on the device."""
    arg, asm_env, env = setting
    for name, value in zip(BACKEND_VARS, (env, asm_env)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    calls = []
    for mod, name in ((parse_bwt, "bwt_of_parse"),
                      (parse_bwt, "bwt_of_parse_device"),
                      (host_bwt, "assemble_bwt")):
        fn = getattr(mod, name)
        monkeypatch.setattr(
            mod, name, lambda *a, _fn=fn, _n=name, **k: (calls.append(_n),
                                                         _fn(*a, **k))[1])
    res = _parse(31, 10, 100)
    pb = engine.parse_bwt(res, device="cpu", backend=arg)
    out = engine.assemble_bwt(res.dict_flat(), 10, res.occs.astype(np.int64),
                              pb.bwlast, pb.ilist, pb.bwsai, res.n,
                              want_sa=True, device="cpu", backend=arg)
    assert calls[0] == ("bwt_of_parse" if host[0] else "bwt_of_parse_device")
    assert ("assemble_bwt" in calls) == host[1]
    want = jax_bwt.assemble_bwt(*_stage3_args(res), want_sa=True)
    assert np.array_equal(out.bwt, want.bwt)
    assert np.array_equal(out.sa, want.sa)


def test_default_backend_is_the_card_without_one(monkeypatch):
    """Nothing set: stage 2 goes to the device given, which raises with
    no card rather than falling back to the host."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for name in BACKEND_VARS:
        monkeypatch.delenv(name, raising=False)
    res = _parse(31, 10, 100)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.parse_bwt(res)
    monkeypatch.setenv("PFBWT_BACKEND", "numpy")
    assert engine.parse_bwt(res).ilist.shape[0] == res.parse_ranks.shape[0] + 1


ELEVEN = ("dict", "occ", "parse", "n", "bwlast", "ilist", "bwsai", "bwt",
          "sa", "ssa", "esa")


@pytest.mark.parametrize("extra", [["-s", "-r"], ["-s", "-r", "--u32"],
                                   ["-r", "--chunk-mb", "1"]])
def test_staged_cli_host_backend_equals_default(monkeypatch, tmp_path, extra):
    """The staged CLI under PFBWT_BACKEND=numpy (stages 2 and 3 on the
    host) writes the default run's files, and pfbwtf_tpu's."""
    fa = random_fasta(str(tmp_path / "in.fa"), np.random.default_rng(41),
                      nrecords=3, length=1500)
    for name in BACKEND_VARS + ("PFBWT_DICT_IMPL", "PFBWT_MA_BACKEND"):
        monkeypatch.delenv(name, raising=False)
    args = ["-p", "10", *extra]
    assert pfbwt_f.main([fa, "-o", str(tmp_path / "dev"), *args],
                        device="cpu") == 0
    assert jax_cli.main([fa, "-o", str(tmp_path / "jax"), *args]) == 0
    monkeypatch.setenv("PFBWT_BACKEND", "numpy")
    assert pfbwt_f.main([fa, "-o", str(tmp_path / "host"), *args],
                        device="cpu") == 0
    seen = 0
    for ext in ELEVEN:
        want = tmp_path / f"dev.{ext}"
        for other in ("host", "jax"):
            got = tmp_path / f"{other}.{ext}"
            assert got.exists() == want.exists(), (other, ext)
            if want.exists():
                assert got.read_bytes() == want.read_bytes(), (other, ext)
        seen += want.exists()
    assert seen >= 9


def test_pipeline_backend_keyword_equals_default(monkeypatch, tmp_path):
    """``backend="numpy"`` through run_parser / PfbwtConfig and through
    VcfToBwtConfig writes the device run's files."""
    from pfbwtf_tpu_torch.pipeline import PfbwtConfig, run_parser, run_pfbwt
    from pfbwtf_tpu_torch.vcf.pipeline import VcfToBwtConfig, vcf_to_bwt

    from .vcf_gen import random_vcf

    for name in BACKEND_VARS:
        monkeypatch.delenv(name, raising=False)
    rng = np.random.default_rng(43)
    fa = random_fasta(str(tmp_path / "in.fa"), rng, nrecords=2, length=1500)
    vcf = str(tmp_path / "p.vcf")
    from pfbwtf_tpu_torch.io.fasta import read_fasta_bytes

    random_vcf(vcf, read_fasta_bytes(fa), rng, nsamples=2, density=0.02)
    params = ParserParams(w=10, p=10, get_sai=True)
    for backend in (None, "numpy"):
        pre = str(tmp_path / f"st_{backend}")
        n = run_parser(fa, pre, params, device="cpu", backend=backend)
        run_pfbwt(PfbwtConfig(prefix=pre, sa=True, rssa=True, device="cpu",
                              backend=backend), n)
        vcf_to_bwt(VcfToBwtConfig(fasta=fa, vcfs=[vcf], mod=10, sa=True,
                                  rssa=True, ma=True, device="cpu",
                                  backend=backend,
                                  output=str(tmp_path / f"v_{backend}")))
    for ext in ELEVEN:
        assert ((tmp_path / f"st_numpy.{ext}").read_bytes()
                == (tmp_path / f"st_None.{ext}").read_bytes()), ext
    for ext in ELEVEN + ("ma", "mps"):
        assert ((tmp_path / f"v_numpy.{ext}").read_bytes()
                == (tmp_path / f"v_None.{ext}").read_bytes()), ext
