"""The port's fused build (pfbwtf_tpu_torch/ops/fused.py) against the JAX
package's fused build, stage by stage, and against the host path.  All
on the CPU; every comparison is exact."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pfbwtf_tpu.ops import fused as jfused
from pfbwtf_tpu.ops.bwt import assemble_bwt
from pfbwtf_tpu.ops.bwt_jax import _bucket as j_bucket
from pfbwtf_tpu.ops.parse import ParserParams as JParams, parse_records
from pfbwtf_tpu.ops.parse_bwt import bwt_of_parse
from pfbwtf_tpu_torch.ops import fused as tfused
from pfbwtf_tpu_torch.ops.bwt_dev import assemble_core
from pfbwtf_tpu_torch.ops.parse import ParserParams, build_stream
from pfbwtf_tpu_torch.utils.errors import PfbwtError

from . import torch_inputs

ACGT = np.frombuffer(b"ACGT", np.uint8)
MASK64 = (1 << 64) - 1


def _case(name):
    """(records, w, p) of the test_fused.py inputs."""
    if name == "random":
        rng = np.random.default_rng(11)
        return [("s", rng.choice(ACGT, size=6000))], 4, 10
    if name == "multi_record":
        rng = np.random.default_rng(12)
        return [
            ("a", rng.choice(ACGT, size=2500)),
            ("b", rng.choice(ACGT, size=1700)),
            ("c", rng.choice(ACGT, size=900)),
        ], 4, 8
    if name == "repetitive":
        rng = np.random.default_rng(13)
        seq = np.tile(rng.choice(ACGT, size=800), 12)
        muts = rng.integers(0, seq.size, size=30)
        seq[muts] = ACGT[rng.integers(0, 4, size=30)]
        return [("r", seq)], 4, 12
    if name == "repeats":
        return torch_inputs.records("repeats")
    if name == "n_runs":
        # runs of N (hashed and sorted as their own byte) in two records
        rng = np.random.default_rng(18)
        a = rng.choice(ACGT, size=3000)
        b = rng.choice(ACGT, size=2000)
        for seq, starts in ((a, (100, 1500, 2980)), (b, (0, 700))):
            for s0 in starts:
                seq[s0: s0 + int(rng.integers(5, 60))] = ord("N")
        return [("a", a), ("b", b)], 4, 10
    if name == "mixed_to_a":
        # every byte class of the tables in a tenth of the sites of two
        # repetitive records: lowercase, N/n, '-', other letters, digits,
        # punctuation, bytes past ASCII; run with --non-acgt-to-a
        rng = np.random.default_rng(19)
        unit = rng.choice(ACGT, size=600)
        recs = []
        for r in ("a", "b"):
            seq = np.tile(unit, 5)
            at = rng.integers(0, seq.size, size=seq.size // 10)
            seq[at] = rng.choice(torch_inputs.MIXED, size=at.size)
            recs.append((r, seq))
        return recs, 4, 10
    rng = np.random.default_rng(14)
    return [("s", rng.choice(ACGT, size=30000))], 10, 100


CASES = ["random", "multi_record", "repetitive", "default_params",
         "repeats", "n_runs"]
# cases built with --non-acgt-to-a; their bytes die without it
TO_A = ["mixed_to_a"]


def _host_reference(records, w, p, to_a=False):
    res = parse_records(records, JParams(w=w, p=p, get_sai=True,
                                         non_acgt_to_a=to_a))
    pb = bwt_of_parse(res.parse_ranks, res.last, res.sai, get_sai=True)
    return assemble_bwt(
        res.dict_flat(), w, res.occs.astype(np.int64), pb.bwlast,
        pb.ilist, pb.bwsai, res.n, want_sa=True, want_rssa=True,
    )


def _assert_same(got, want):
    assert got.bwt.tobytes() == want.bwt.tobytes()
    assert np.array_equal(got.sa, want.sa)
    assert got.nruns == want.nruns
    assert np.array_equal(got.ssa, want.ssa)
    assert np.array_equal(got.esa, want.esa)


def _j2_inputs(records, w, p):
    C, _, _ = build_stream(records, ParserParams(w=w, p=p))
    C_len = C.shape[0]
    n_b = tfused._bucket(max(C_len, 1), 1 << 16)
    chars_p = np.full(n_b, ord("A"), np.uint8)
    chars_p[:C_len] = C
    nph_b = tfused._bucket(tfused.speculative_nphrases(C_len, p))
    return chars_p, C_len, nph_b


def _jax_j2(chars_p, C_len, w, p, nph_b):
    fn = jax.jit(partial(jfused._parse_core, w=w, p=p, nph_b=nph_b,
                         scan_impl="xla"))
    return tuple(np.asarray(a) for a in fn(jnp.asarray(chars_p),
                                           jnp.int64(C_len)))


@pytest.mark.parametrize("name", CASES)
def test_j2_matches_jax_lane_for_lane(name):
    records, w, p = _case(name)
    chars_p, C_len, nph_b = _j2_inputs(records, w, p)
    want = _jax_j2(chars_p, C_len, w, p, nph_b)
    got = tfused._parse_core(torch.from_numpy(chars_p), C_len, w, p, nph_b)
    got_np = tfused.parse_state_to_numpy(got)
    for g, x in zip(got_np, want):
        assert g.dtype == x.dtype
        assert np.array_equal(g, x)


def test_substring_hashes_match_jax():
    """h1/h2 of J2's dedup are bit-equal to JAX's uint64 hashes."""
    rng = np.random.default_rng(31)
    Tp = rng.integers(0, 256, size=9000, dtype=np.uint8)
    starts = rng.integers(0, 9000, size=500)
    lens = rng.integers(0, 40, size=500)
    for base in (tfused._HB1, tfused._HB2):
        got = tfused._substring_hashes_dev(
            torch.from_numpy(Tp), torch.from_numpy(starts),
            torch.from_numpy(lens), base,
        ).numpy().view(np.uint64)
        want = jfused._substring_hashes_dev(
            jnp.asarray(Tp), jnp.asarray(starts), jnp.asarray(lens),
            np.uint64(base),
        )
        assert np.array_equal(got, np.asarray(want))


def _j3_sizes(meta, n, w):
    ncuts, D, dict_total, max_len = (int(x) for x in meta)
    nsuf = (dict_total - 1 - D) - D * w
    return dict(
        nphrases=ncuts + 1, D=D, dict_total=dict_total, nsuf_true=nsuf,
        total_true=n + 1, dict_b=jfused._bucket(dict_total),
        nsuf_b=jfused._bucket(nsuf), total_b=jfused._bucket(n + 1),
        n_levels=jfused.capture_levels(max_len, w),
    )


@pytest.mark.parametrize("name", CASES)
def test_port_j3_on_jax_j2_matches_jax_j3(name):
    """The J2 -> J3 state carried across as numpy arrays isolates J3."""
    records, w, p = _case(name)
    chars_p, C_len, nph_b = _j2_inputs(records, w, p)
    state = _jax_j2(chars_p, C_len, w, p, nph_b)
    sz = _j3_sizes(state[-1], C_len, w)
    scal = (sz["nphrases"], sz["D"], sz["dict_total"], sz["nsuf_true"],
            sz["total_true"])
    j3 = jax.jit(partial(
        jfused._final_core, w=w, dict_b=sz["dict_b"], nsuf_b=sz["nsuf_b"],
        total_b=sz["total_b"], impl="lax", fanout="fill",
        n_levels=sz["n_levels"], alphabet="byte",
    ))
    want = j3(*(jnp.asarray(a) for a in state[:-1]),
              *(jnp.int64(s) for s in scal))
    tstate = tfused.parse_state_from_numpy(state, "cpu")
    bwtc, sa_vals, checksum = tfused._final_core(
        *tstate[:-1], *scal, w, sz["dict_b"], sz["nsuf_b"], sz["total_b"],
        n_levels=sz["n_levels"],
    )
    assert np.array_equal(bwtc.numpy(), np.asarray(want[0]))
    assert np.array_equal(sa_vals.numpy().view(np.uint64),
                          np.asarray(want[1]))
    assert int(checksum) & MASK64 == int(want[2])


@pytest.mark.parametrize("name", CASES + TO_A)
def test_whole_port_matches_jax_and_host(name):
    records, w, p = _case(name)
    to_a = name in TO_A
    got, info = tfused.pfbwt_fused_records(
        records, ParserParams(w=w, p=p, non_acgt_to_a=to_a), device="cpu",
        want_sa=True, want_rssa=True,
    )
    want_jax, _ = jfused.pfbwt_fused_records(
        records, JParams(w=w, p=p, non_acgt_to_a=to_a), want_sa=True,
        want_rssa=True
    )
    _assert_same(got, want_jax)
    _assert_same(got, _host_reference(records, w, p, to_a))
    assert info["r"] == got.nruns and info["j2_runs"] == 1


@pytest.mark.parametrize("size", [4000, 4100, 5000])
def test_bucketed_shapes_reused(size):
    rng = np.random.default_rng(15 + size)
    records = [("s", rng.choice(ACGT, size=size))]
    got, _ = tfused.pfbwt_fused_records(
        records, ParserParams(w=4, p=10), device="cpu", want_sa=True,
        want_rssa=True,
    )
    _assert_same(got, _host_reference(records, 4, 10))


def test_single_phrase_dies():
    seq = np.full(50, ord("A"), np.uint8)
    with pytest.raises(PfbwtError, match="smaller p"):
        tfused.pfbwt_fused_records(
            [("s", seq)], ParserParams(w=4, p=(1 << 20) - 1), device="cpu"
        )


def test_invalid_char_dies():
    seq = np.frombuffer(b"ACGTBACGT" * 20, np.uint8)
    with pytest.raises(PfbwtError, match="invalid character"):
        tfused.pfbwt_fused_records([("s", seq)], ParserParams(w=4, p=10),
                                   device="cpu")


def test_speculative_overflow_reruns_until_it_holds(monkeypatch):
    """A phrase bucket that is too small re-runs J2 at the exact bucket."""
    monkeypatch.setattr(tfused, "speculative_nphrases", lambda C_len, p: 8)
    rng = np.random.default_rng(17)
    records, w, p = [("s", rng.choice(ACGT, size=20000))], 4, 2
    got, info = tfused.pfbwt_fused_records(
        records, ParserParams(w=w, p=p), device="cpu", want_sa=True,
        want_rssa=True,
    )
    assert info["j2_runs"] == 2
    _assert_same(got, _host_reference(records, w, p))


def test_checksum_matches_jax():
    """The J3 checksum (wrapping uint64 sum of the padded BWT and SA
    buffers) equals the one JAX's no-fetch run returns."""
    rng = np.random.default_rng(16)
    records = [("s", rng.choice(ACGT, size=4000))]
    _, info = tfused.pfbwt_fused_records(records, ParserParams(w=4, p=10),
                                         device="cpu")
    _, want = jfused.pfbwt_fused_records(records, JParams(w=4, p=10),
                                         fetch=False)
    assert info["checksum"] == want
    assert info["stream_s"] >= 0


@pytest.mark.parametrize("name", ["random5000", "repeats"])
@pytest.mark.parametrize("wide", [True, False])
def test_assemble_wide_emission_sort(wide, name):
    """wide=True takes the scatter fan-out with the two-key (gid, j) sort
    that the JAX path takes past 63 key bits; byte parity with the host
    assembly either way."""
    if name == "repeats":
        records, w, p = _case(name)
    else:
        rng = np.random.default_rng(23)
        records, w, p = [("s", rng.choice(ACGT, size=5000))], 4, 9
    res = parse_records(records, JParams(w=w, p=p, get_sai=True))
    pb = bwt_of_parse(res.parse_ranks, res.last, res.sai, get_sai=True)
    dict_flat = res.dict_flat()
    want = assemble_bwt(dict_flat, w, res.occs.astype(np.int64), pb.bwlast,
                        pb.ilist, pb.bwsai, res.n, want_sa=True)
    D, dwords, m = dict_flat.shape[0], res.occs.shape[0], pb.ilist.shape[0]
    nsuf, total = (D - 1 - dwords) - dwords * w, res.n + 1

    def pad(a, dtype):
        out = np.zeros(j_bucket(a.shape[0]), dtype=dtype)
        out[: a.shape[0]] = a
        return torch.from_numpy(out)

    bwtc, sa_vals = assemble_core(
        pad(dict_flat, np.uint8), pad(res.occs, np.int64),
        pad(pb.bwlast, np.uint8), pad(pb.ilist, np.int64),
        pad(pb.bwsai.view(np.int64), np.int64), nsuf, total, w,
        j_bucket(nsuf), j_bucket(total), wide=wide,
    )
    assert bwtc[:total].numpy().tobytes() == want.bwt.tobytes()
    sa = sa_vals[:total].numpy().view(np.uint64).copy()
    sa[0] = res.n
    assert np.array_equal(sa, want.sa)


def test_state_round_trip():
    records, w, p = _case("random")
    chars_p, C_len, nph_b = _j2_inputs(records, w, p)
    state = tfused._parse_core(torch.from_numpy(chars_p), C_len, w, p, nph_b)
    back = tfused.parse_state_from_numpy(tfused.parse_state_to_numpy(state),
                                         "cpu")
    for a, b in zip(state, back):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_bwt_sa_convention_of_chip_smoke():
    """chip_smoke.check_bwt_sa holds on the port's output and catches a
    corrupted BWT or SA."""
    records = chip_smoke.pangenome_records(1, seed=99)
    records = [(n, s[:3000]) for n, s in records]
    params = ParserParams(w=10, p=20)
    res, _ = tfused.pfbwt_fused_records(records, params, device="cpu",
                                        want_sa=True)
    C, _, _ = build_stream(records, params)
    chip_smoke.check_bwt_sa(C, res.bwt, res.sa, "cpu")
    bad = res.bwt.copy()
    bad[5] ^= 1
    with pytest.raises(AssertionError):
        chip_smoke.check_bwt_sa(C, bad, res.sa, "cpu")
    bad_sa = res.sa.copy()
    bad_sa[3] = bad_sa[4]
    with pytest.raises(AssertionError, match="permutation"):
        chip_smoke.check_bwt_sa(C, res.bwt, bad_sa, "cpu")
    # two adjacent entries swapped together with their BWT chars: still a
    # permutation and LF-consistent, but out of suffix order
    sa = res.sa.astype(np.int64)
    i = next(k for k in range(len(sa) // 2, len(sa) - 1)
             if C[sa[k]: sa[k] + 32].tobytes() != C[sa[k + 1]: sa[k + 1] + 32]
             .tobytes())
    swapped_sa, swapped_bwt = res.sa.copy(), res.bwt.copy()
    swapped_sa[[i, i + 1]] = swapped_sa[[i + 1, i]]
    swapped_bwt[[i, i + 1]] = swapped_bwt[[i + 1, i]]
    with pytest.raises(AssertionError, match="suffix order"):
        chip_smoke.check_bwt_sa(C, swapped_bwt, swapped_sa, "cpu")


@pytest.mark.parametrize("shared", [64, 256])
def test_chip_smoke_check_catches_swap_among_repeats(shared):
    """Adjacent suffixes of repeated copies that agree on their first
    ``shared`` bytes, swapped together with their BWT chars, still fail
    the exact order test."""
    records = chip_smoke.pangenome_records(1, seed=98)
    records = [(n, s[:3000]) for n, s in records]
    params = ParserParams(w=10, p=20)
    res, _ = tfused.pfbwt_fused_records(records, params, device="cpu",
                                        want_sa=True)
    C, _, _ = build_stream(records, params)
    sa = res.sa.astype(np.int64)
    i = next(k for k in range(1, len(sa) - 1)
             if C[sa[k]: sa[k] + shared].tobytes()
             == C[sa[k + 1]: sa[k + 1] + shared].tobytes()
             and sa[k] + shared <= len(C) and sa[k + 1] + shared <= len(C))
    swapped_sa, swapped_bwt = res.sa.copy(), res.bwt.copy()
    swapped_sa[[i, i + 1]] = swapped_sa[[i + 1, i]]
    swapped_bwt[[i, i + 1]] = swapped_bwt[[i + 1, i]]
    with pytest.raises(AssertionError, match="suffix order"):
        chip_smoke.check_bwt_sa(C, swapped_bwt, swapped_sa, "cpu")
