"""The port's streamed J2 (pfbwtf_tpu_torch/ops/fused._parse_core_stream)
against the JAX package's, lane for lane with all five meta scalars, and
against the port's own monolithic J2.  All on the CPU; every comparison
is exact."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfbwtf_tpu.ops import fused as jfused
from pfbwtf_tpu_torch.ops import fused as tfused
from pfbwtf_tpu_torch.ops.hash import wang_hash
from pfbwtf_tpu_torch.ops.parse import ParserParams, build_stream

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _inputs(records, w, p):
    C, _, _ = build_stream(records, ParserParams(w=w, p=p))
    C_len = C.shape[0]
    n_b = tfused._bucket(max(C_len, 1), 1 << 16)
    chars_p = np.full(n_b, ord("A"), np.uint8)
    chars_p[:C_len] = C
    nph_b = tfused._bucket(tfused.speculative_nphrases(C_len, p))
    return chars_p, C_len, nph_b


def _jax_stream(chars_p, C_len, w, p, nph_b, n_chunks, m_max):
    fn = jax.jit(partial(jfused._parse_core_stream, w=w, p=p, nph_b=nph_b,
                         n_chunks=n_chunks, m_max=m_max, scan_impl="xla"))
    return tuple(np.asarray(a) for a in fn(jnp.asarray(chars_p),
                                           jnp.int64(C_len)))


def _assert_state_equal(got, want, n_meta):
    got_np = tfused.parse_state_to_numpy(got)
    for g, x in zip(got_np[:-1], want[:-1]):
        assert g.dtype == x.dtype and np.array_equal(g, x)
    assert np.array_equal(got_np[-1][:n_meta], want[-1][:n_meta])


def _stream_case(name):
    if name == "multi_record":
        rng = np.random.default_rng(78)
        recs = [("a", rng.choice(ACGT, size=9000)),
                ("b", rng.choice(ACGT, size=4000)),
                ("c", rng.choice(ACGT, size=13000))]
        return recs, 6, 25, 5
    rng = np.random.default_rng(77)
    return [("s", rng.choice(ACGT, size=50_000))], 4, 10, int(name)


@pytest.mark.parametrize("name", ["1", "3", "7", "multi_record"])
def test_stream_j2_matches_jax_and_monolithic(name):
    records, w, p, n_chunks = _stream_case(name)
    chars_p, C_len, nph_b = _inputs(records, w, p)
    m_max = tfused.speculative_chunk_phrases(-(-chars_p.shape[0] // n_chunks),
                                             p)
    want = _jax_stream(chars_p, C_len, w, p, nph_b, n_chunks, m_max)
    got = tfused._parse_core_stream(torch.from_numpy(chars_p), C_len, w, p,
                                    nph_b, n_chunks, m_max)
    assert got[-1].shape == (5,)
    _assert_state_equal(got, want, 5)
    mono = tfused._parse_core(torch.from_numpy(chars_p), C_len, w, p, nph_b)
    for a, b in zip(mono[:-1], got[:-1]):
        assert torch.equal(a, b)
    assert torch.equal(mono[-1], got[-1][:4])


def test_small_window_overflow_matches_jax_and_reruns(monkeypatch):
    """m_max = 8 overflows with the same meta[4] as JAX's, and
    run_parse_stream, started from that window, re-runs once at a window
    that holds and returns the monolithic state."""
    rng = np.random.default_rng(79)
    records, w, p = [("s", rng.choice(ACGT, size=30_000))], 4, 10
    chars_p, C_len, nph_b = _inputs(records, w, p)
    chars = torch.from_numpy(chars_p)
    want = _jax_stream(chars_p, C_len, w, p, nph_b, 4, 8)
    got = tfused._parse_core_stream(chars, C_len, w, p, nph_b, 4, 8)
    assert int(want[-1][4]) > 8
    _assert_state_equal(got, want, 5)
    monkeypatch.setattr(tfused, "speculative_chunk_phrases", lambda L, p: 8)
    state, meta, runs = tfused.run_parse_stream(
        chars, C_len, w, p, nph_b, chunk_target=chars_p.shape[0] // 4)
    assert runs == 2
    assert int(state[-1][4]) == int(want[-1][4])
    mono = tfused._parse_core(chars, C_len, w, p, nph_b)
    for a, b in zip(mono[:-1], state[:-1]):
        assert torch.equal(a, b)
    assert meta == mono[-1].tolist()


def test_double_overflow_returns_the_exact_monolithic_state():
    """Every position of an all-A text cuts (p is the Wang hash of the
    all-A k-mer), while speculative_nphrases sizes for 1/p of them.  The
    first run overflows the phrase bucket, so its per-chunk count sees
    only the truncated cuts; the second overflows the window it sized
    from that count.  The driver must re-check both and run a third
    time."""
    w = 4
    p = int(wang_hash(torch.zeros(1, dtype=torch.int64))[0]) % (1 << 64)
    C = np.full(20_000, ord("A"), np.uint8)
    C_len = C.shape[0]
    n_b = tfused._bucket(C_len, 1 << 16)
    chars_p = np.full(n_b, ord("A"), np.uint8)
    chars = torch.from_numpy(chars_p)
    nph_b = tfused._bucket(tfused.speculative_nphrases(C_len, p))
    assert nph_b < C_len // 2
    state, meta, runs = tfused.run_parse_stream(chars, C_len, w, p, nph_b,
                                                chunk_target=1 << 14)
    assert runs == 3
    ncuts = meta[0]
    assert ncuts == C_len - w
    exact = tfused._bucket(ncuts + 1)
    assert state[1].shape[0] == exact
    mono = tfused._parse_core(chars, C_len, w, p, exact)
    for a, b in zip(mono[:-1], state[:-1]):
        assert torch.equal(a, b)
    assert meta == mono[-1].tolist()
