"""The port's suffix sorting (pfbwtf_tpu_torch/ops/suffix.py and
bwt_dev.dict_sort_part) against the JAX package's, on the dicts of the
fused-path test inputs.  Every comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfbwtf_tpu.ops import bwt_jax, suffix as jsuf
from pfbwtf_tpu.ops.parse import ParserParams, parse_records
from pfbwtf_tpu_torch.ops import bwt_dev, suffix as tsuf

from .torch_inputs import repeat_dict

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _records(name):
    rng = np.random.default_rng({"random": 11, "repetitive": 13,
                                 "default": 14}[name])
    if name == "random":
        return [("s", rng.choice(ACGT, size=6000))], 4, 10
    if name == "repetitive":
        seq = np.tile(rng.choice(ACGT, size=800), 12)
        muts = rng.integers(0, seq.size, size=30)
        seq[muts] = ACGT[rng.integers(0, 4, size=30)]
        return [("r", seq)], 4, 12
    return [("s", rng.choice(ACGT, size=30000))], 10, 100


def _padded_dict(name):
    records, w, p = _records(name)
    res = parse_records(records, ParserParams(w=w, p=p))
    df = res.dict_flat()
    out = np.zeros(bwt_jax._bucket(df.shape[0]), np.uint8)
    out[: df.shape[0]] = df
    return df, out, w


@pytest.mark.parametrize("name", ["random", "repetitive", "default"])
def test_dict_sort_part_matches_jax(name):
    """sa_all, C1, C2, suf_len and word_id equal JAX's lane for lane."""
    _, dfp, w = _padded_dict(name)
    want = jax.jit(lambda d: bwt_jax.dict_sort_part(d, w, n_levels=8))(
        jnp.asarray(dfp)
    )
    got = bwt_dev.dict_sort_part(torch.from_numpy(dfp), w, n_levels=8)
    for g, x in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(x))


@pytest.mark.parametrize("name", ["random", "repetitive", "default"])
def test_dict_sort_order_matches_np(name):
    """The suffix strings in sa_all order are those of dict_suffix_sort_np.
    Within a group of equal suffix strings the two orders may differ: the
    packed byte keys (here and in the JAX package) break such ties by the
    bytes after the separator, numpy by word index; the emission only
    uses the groups."""
    df, dfp, w = _padded_dict(name)
    sa_all = bwt_dev.dict_sort_part(torch.from_numpy(dfp), w)[0].numpy()
    sa_np = jsuf.dict_suffix_sort_np(df)[0]
    real = df.shape[0] - 1  # the terminator and the pads sort first
    sa_all = sa_all[sa_all < real]
    sa_np = sa_np[sa_np < real]
    seps = np.flatnonzero(df <= 1)
    end = seps[np.searchsorted(seps, np.arange(df.shape[0]))]

    def strings(sa):
        return [df[i: end[i] + 1].tobytes() for i in sa]

    assert strings(sa_all) == strings(sa_np)


@pytest.mark.parametrize("n", [2, 17, 128, 1000, 5000])
def test_parse_doubling_matches_jax_and_np(n):
    rng = np.random.default_rng(n)
    seq = np.concatenate((rng.integers(1, 6, size=n), [0]))
    order, rank = tsuf._doubling(torch.from_numpy(seq))
    j_order, j_rank = jsuf._doubling_jax(jnp.asarray(seq))
    assert np.array_equal(order.numpy(), np.asarray(j_order))
    assert np.array_equal(rank.numpy(), np.asarray(j_rank))
    assert np.array_equal(order.numpy(), jsuf.suffix_array_ints_np(seq))


@pytest.mark.parametrize("size", [5, 300, 4096])
def test_compact_indices_matches_jax(size):
    rng = np.random.default_rng(size)
    mask = rng.random(1000) < 0.2
    got = tsuf.compact_indices(torch.from_numpy(mask), size, fill=-7)
    want = jsuf.compact_indices_jax(jnp.asarray(mask), size, fill=-7)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("w", [1, 3, 4, 10])
def test_packed_dict_keys_match_jax(w):
    _, dfp, _ = _padded_dict("random")
    got, k0 = tsuf.packed_dict_keys(torch.from_numpy(dfp), w)
    want, jk0, _ = jsuf.packed_dict_keys(jnp.asarray(dfp), w)
    assert k0 == jk0
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_levels", [None, 4, 1])
def test_doubling_with_captures_matches_jax(n_levels):
    """Including a table too short for the longest suffixes, where the
    uncaptured queries keep their sentinels."""
    _, dfp, w = _padded_dict("repetitive")
    keys, k0 = tsuf.packed_dict_keys(torch.from_numpy(dfp), w)
    suf_len = bwt_dev.dict_sort_part(torch.from_numpy(dfp), w)[3]
    got = tsuf.doubling_with_captures(keys, suf_len, k0, n_levels=n_levels)
    want = jsuf.doubling_with_captures(
        jnp.asarray(keys.numpy()), None, jnp.asarray(suf_len.numpy()),
        k0=k0, n_levels=n_levels,
    )
    for g, x in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(x))


def _captures(dfp, w, n_levels=None):
    """The port's and the JAX package's doubling_with_captures outputs on
    the same keys and capture lengths."""
    keys, k0 = tsuf.packed_dict_keys(torch.from_numpy(dfp), w)
    suf_len = bwt_dev.dict_sort_part(torch.from_numpy(dfp), w)[3]
    got = tsuf.doubling_with_captures(keys, suf_len, k0, n_levels=n_levels)
    want = jsuf.doubling_with_captures(
        jnp.asarray(keys.numpy()), None, jnp.asarray(suf_len.numpy()),
        k0=k0, n_levels=n_levels,
    )
    return got, want


@pytest.mark.parametrize("n_levels", [None, 3])
@pytest.mark.parametrize("w", [4, 10])
def test_doubling_with_captures_on_repeats_matches_jax(w, n_levels):
    """Words with long shared prefixes: several full-width rounds, and
    with n_levels=3 a table too short for the longest suffixes."""
    got, want = _captures(repeat_dict(w=w), w, n_levels)
    for g, x in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(x))
    assert tsuf.rounds["dict_sa"] >= 2


@pytest.mark.parametrize("w", [4, 10, 15])
def test_dict_sort_part_on_repeats_matches_jax(w):
    dfp = repeat_dict(w=w)
    n_levels = tsuf.capture_levels(90, w)
    want = jax.jit(lambda d: bwt_jax.dict_sort_part(d, w,
                                                    n_levels=n_levels))(
        jnp.asarray(dfp))
    got = bwt_dev.dict_sort_part(torch.from_numpy(dfp), w,
                                 n_levels=n_levels)
    for g, x in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(x))
