"""The port's collective dictionary rank and mesh parse
(pfbwtf_tpu_torch/parallel/dict_union.py) in 2- and 3-rank gloo worlds,
against pfbwtf_tpu's on its 8-device CPU mesh, the host rank and the
port's single-device parse: equal ranks and ParseResults field by field
(the dict bytes, occs, parse ranks, last, sai, docs), with tiny and
empty-shard inputs and the exact stream fallback for a phrase longer
than a block."""

import numpy as np
import pytest

from tests.torch_worlds import run_world

SIZES = (2, 3)
RANK_CASES = [(5000, 3, 50), (777, 1, 777), (64, 5, 3), (3, 2, 2)]
# name -> (n, w, p, records split, seed); "fallback" has phrases longer
# than a block of T' at 2 and 3 ranks (seed chosen for it)
PARSE_CASES = {
    "random_w10": (60_000, 10, 17, True, 11),
    "random_w4": (9_999, 4, 5, True, 12),
    "tiny": (300, 4, 40, False, 13),
    "empty_shards": (300, 4, 5, False, 14),
    "fallback": (4000, 8, 1000, False, 38),
}
FIELDS = ("dict_starts", "dict_lens", "occs", "parse_ranks", "last", "sai")


def _rank_rows(N, ncols, card):
    rng = np.random.default_rng(N * 10 + ncols)
    pool = rng.integers(0, np.iinfo(np.int64).max, size=(card, ncols))
    cols = pool[rng.integers(0, card, size=N)].astype(np.uint64)
    cols[:, 0] >>= np.uint64(8)  # phrase rows never start with 0xFF
    return cols


def _records(name):
    n, w, p, split, seed = PARSE_CASES[name]
    chars = np.random.default_rng(seed).choice(
        np.frombuffer(b"ACGT", np.uint8), size=n)
    if split:
        return [("chr1", chars[: n // 2]), ("chr2", chars[n // 2:])], w, p
    return [("c", chars)], w, p


def _view(res):
    """A ParseResult as plain arrays (the dict bytes included)."""
    out = {f: np.asarray(getattr(res, f)) for f in FIELDS}
    out.update(dict_flat=res.dict_flat(), pos=res.pos, n=res.n,
               doc_names=res.doc_names, doc_starts=res.doc_starts,
               nseqs=res.nseqs)
    return out


def _world_cases(mesh):
    from pfbwtf_tpu_torch.ops.parse import ParserParams
    from pfbwtf_tpu_torch.parallel.dict_union import (
        distributed_parse_records, distributed_rank_rows)

    out = {}
    for N, ncols, card in RANK_CASES:
        out["rank", N] = distributed_rank_rows(_rank_rows(N, ncols, card),
                                               mesh)
    for name in PARSE_CASES:
        recs, w, p = _records(name)
        info = {}
        before = mesh.stats["stream_fallbacks"]
        res = distributed_parse_records(
            recs, ParserParams(w=w, p=p, store_docs=True), mesh, info)
        out["parse", name] = (_view(res), info["stream_fallback"],
                              mesh.stats["stream_fallbacks"] - before)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {n: run_world(n, _world_cases, tmp_path_factory.mktemp(f"w{n}"))
            for n in SIZES}


def _host_rank_rows(cols):
    N, ncols = cols.shape
    order = np.lexsort(tuple(cols[:, j] for j in range(ncols - 1, -1, -1)))
    s = cols[order]
    head = np.ones(N, dtype=bool)
    head[1:] = np.any(s[1:] != s[:-1], axis=1)
    ranks = np.empty(N, dtype=np.int64)
    ranks[order] = np.cumsum(head)
    return ranks


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("N,ncols,card", RANK_CASES)
def test_distributed_rank_rows_equals_jax(worlds, size, N, ncols, card):
    from pfbwtf_tpu.parallel.dict_union import distributed_rank_rows
    from pfbwtf_tpu.parallel.sharded import make_parse_mesh

    got, D = worlds[size][0]["rank", N]
    for r in worlds[size][1:]:
        assert np.array_equal(r["rank", N][0], got) and r["rank", N][1] == D
    cols = _rank_rows(N, ncols, card)
    want = _host_rank_rows(cols)
    assert np.array_equal(got, want) and D == int(want.max())
    jax_got, jax_D = distributed_rank_rows(cols, make_parse_mesh())
    assert np.array_equal(got, jax_got) and D == jax_D


def _jax_view(res):
    from pfbwtf_tpu.pipeline import dict_flat_from_phrases

    out = {f: np.asarray(getattr(res, f)) for f in FIELDS}
    out.update(dict_flat=dict_flat_from_phrases(res.phrases), pos=res.pos,
               n=res.n, doc_names=res.doc_names, doc_starts=res.doc_starts,
               nseqs=res.nseqs)
    return out


def _assert_same(got, want):
    assert got.keys() == want.keys()
    for k in got:
        if isinstance(got[k], np.ndarray):
            assert np.array_equal(got[k], want[k]), k
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", list(PARSE_CASES))
def test_distributed_parse_equals_jax(worlds, size, name):
    """Field for field the JAX mesh parse's, the port's single-device
    parse's and on every rank the same; the fallback case must have
    taken the stream fallback, and the others must not."""
    from pfbwtf_tpu.ops.parse import ParserParams as JaxParams
    from pfbwtf_tpu.parallel.dict_union import (
        distributed_parse_records as jax_parse)
    from pfbwtf_tpu.parallel.sharded import make_parse_mesh
    from pfbwtf_tpu_torch import engine
    from pfbwtf_tpu_torch.ops.parse import ParserParams

    got, fell_back, counted = worlds[size][0]["parse", name]
    for r in worlds[size][1:]:
        _assert_same(r["parse", name][0], got)
    assert fell_back == (name == "fallback")
    assert counted == int(name == "fallback")
    recs, w, p = _records(name)
    want = engine.parse_records(recs, ParserParams(w=w, p=p,
                                                   store_docs=True),
                                device="cpu")
    _assert_same(got, _view(want))
    _assert_same(got, _jax_view(jax_parse(
        recs, JaxParams(w=w, p=p, store_docs=True), make_parse_mesh())))
