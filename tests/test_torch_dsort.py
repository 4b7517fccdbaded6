"""The port's distributed sort and gather primitives and its distributed
doubling (pfbwtf_tpu_torch/parallel/dsort.py) in 2- and 3-rank gloo
worlds, against pfbwtf_tpu's on its 8-device CPU mesh and numpy's stable
order.  Inputs are blocked as the JAX tests block them: W = the share of
max(N, 64) rounded up to 64, padding last."""

import numpy as np
import pytest

from tests.torch_worlds import run_world

SIZES = (2, 3)
SORT_N = (10, 1000, 5000)
DENSE_N, ROUTE_N, GATHER = 3000, 2000, (1500, 900)
DOUBLING = [(500, 4), (4000, 100), (257, 2)]


def _blocks(arr, n_dev, fill):
    n = arr.shape[0]
    W = -(-max(n, 64) // n_dev)
    W = -(-W // 64) * 64
    out = np.full(n_dev * W, fill, dtype=np.int64)
    out[:n] = arr
    return out.reshape(n_dev, W), W


def _sort_keys(N):
    return np.random.default_rng(N).integers(0, 50, size=N)


def _dense_keys():
    return np.sort(np.random.default_rng(7).integers(0, 40, size=DENSE_N))


def _route_input():
    rng = np.random.default_rng(8)
    return rng.permutation(ROUTE_N), rng.integers(0, 10**9, size=ROUTE_N)


def _gather_input():
    N, M = GATHER
    rng = np.random.default_rng(9)
    return rng.integers(0, 10**9, size=N), rng.integers(0, N, size=M)


def _doubling_seq(N, card):
    seq = np.random.default_rng(N + card).integers(1, card + 1, size=N)
    seq[-1] = 0  # unique minimum terminator
    return seq.astype(np.int64)


def _world_cases(mesh):
    """Every case in this world; each rank passes its row of the blocks
    and the results are gathered to every rank."""
    import torch

    from pfbwtf_tpu_torch.parallel.dsort import (
        _I64MAX, dense_ranks, dist_gather, distributed_doubling,
        dsort_blocks, route_to_slots)
    from pfbwtf_tpu_torch.parallel.sharded import gather_ragged

    n, r = mesh.size, mesh.rank

    def row(arr, fill):
        blk, W = _blocks(arr, n, fill)
        return torch.from_numpy(blk[r].copy()), W

    out = {}
    for N in SORT_N:
        pos, _ = row(np.arange(N), -1)
        keys, _ = row(_sort_keys(N), _I64MAX)
        sk, spos = dsort_blocks(mesh, keys, pos)
        out["sort", N] = (gather_ragged(mesh, sk).numpy(),
                          gather_ragged(mesh, spos).numpy())
    keys, _ = row(_dense_keys(), _I64MAX)
    out["dense"] = gather_ragged(mesh, dense_ranks(mesh, keys)).numpy()
    perm, vals = _route_input()
    pb, W = row(perm, -1)
    vb, _ = row(vals, -1)
    out["route"] = gather_ragged(mesh, route_to_slots(mesh, pb, vb, W)).numpy()
    table, idx = _gather_input()
    tb, W = row(table, 0)
    ib, out_W = row(idx, -1)
    tagb, _ = row(np.arange(idx.shape[0]), -1)
    out["gather"] = gather_ragged(
        mesh, dist_gather(mesh, tb, ib, tagb, W, out_W)).numpy()
    for N, card in DOUBLING:
        out["doubling", N] = distributed_doubling(_doubling_seq(N, card),
                                                  mesh)
    out["stats"] = dict(mesh.stats)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {n: run_world(n, _world_cases, tmp_path_factory.mktemp(f"w{n}"))
            for n in SIZES}


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        assert np.array_equal(r[key], ranks[0][key])
    return ranks[0][key]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("N", SORT_N)
def test_dsort_blocks_equals_jax(worlds, size, N):
    from pfbwtf_tpu.parallel.dsort import dsort_blocks
    from pfbwtf_tpu.parallel.sharded import make_parse_mesh

    sk, spos = worlds[size][0]["sort", N]
    _same_on_every_rank(worlds[size], ("sort", N))
    keys = _sort_keys(N)
    order = np.lexsort((np.arange(N), keys))  # stable
    assert np.array_equal(spos, order)
    assert np.array_equal(sk, keys[order])
    mesh = make_parse_mesh()
    pos, _ = _blocks(np.arange(N), mesh.devices.size, -1)
    kb, _ = _blocks(keys, mesh.devices.size, -1)
    jk, jpos = (np.asarray(a).reshape(-1) for a in dsort_blocks(
        mesh, "dp", kb.astype(np.uint64), pos))
    assert np.array_equal(spos, jpos[jpos >= 0])
    assert np.array_equal(sk, jk[jpos >= 0].astype(np.int64))


@pytest.mark.parametrize("size", SIZES)
def test_dense_ranks_equals_jax(worlds, size):
    from pfbwtf_tpu.parallel.dsort import dense_ranks
    from pfbwtf_tpu.parallel.sharded import make_parse_mesh

    got = _same_on_every_rank(worlds[size], "dense")
    keys = _dense_keys()
    want = np.unique(keys, return_inverse=True)[1]
    assert np.array_equal(got[:DENSE_N], want)
    mesh = make_parse_mesh()
    kb, _ = _blocks(keys, mesh.devices.size, -1)
    jax_gid = np.asarray(dense_ranks(mesh, "dp", kb.astype(np.uint64)))
    assert np.array_equal(got[:DENSE_N], jax_gid.reshape(-1)[:DENSE_N])


@pytest.mark.parametrize("size", SIZES)
def test_route_to_slots_equals_jax(worlds, size):
    from pfbwtf_tpu.parallel.dsort import route_to_slots
    from pfbwtf_tpu.parallel.sharded import make_parse_mesh

    got = _same_on_every_rank(worlds[size], "route")
    perm, vals = _route_input()
    want = np.zeros(got.shape[0], dtype=np.int64)
    want[perm] = vals
    assert np.array_equal(got, want)
    mesh = make_parse_mesh()
    pb, W = _blocks(perm, mesh.devices.size, -1)
    vb, _ = _blocks(vals, mesh.devices.size, -1)
    jax_out = np.asarray(route_to_slots(mesh, "dp", pb, vb, W)).reshape(-1)
    assert np.array_equal(got[:ROUTE_N], jax_out[:ROUTE_N])


@pytest.mark.parametrize("size", SIZES)
def test_dist_gather_equals_jax(worlds, size):
    from pfbwtf_tpu.parallel.dsort import dist_gather
    from pfbwtf_tpu.parallel.sharded import make_parse_mesh

    got = _same_on_every_rank(worlds[size], "gather")
    table, idx = _gather_input()
    M = idx.shape[0]
    assert np.array_equal(got[:M], table[idx])
    mesh = make_parse_mesh()
    n_dev = mesh.devices.size
    tb, W = _blocks(table, n_dev, 0)
    ib, _ = _blocks(idx, n_dev, -1)
    tagb, _ = _blocks(np.arange(M), n_dev, -1)
    jax_out = np.asarray(
        dist_gather(mesh, "dp", tb, ib, tagb, W, ib.shape[1])).reshape(-1)
    assert np.array_equal(got[:M], jax_out[:M])


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("N,card", DOUBLING)
def test_distributed_doubling_equals_jax(worlds, size, N, card):
    from pfbwtf_tpu.ops.suffix import suffix_array_ints_np
    from pfbwtf_tpu.parallel.dsort import distributed_doubling
    from pfbwtf_tpu.parallel.sharded import make_parse_mesh

    got = _same_on_every_rank(worlds[size], ("doubling", N))
    seq = _doubling_seq(N, card)
    assert np.array_equal(got, suffix_array_ints_np(seq))
    assert np.array_equal(got, distributed_doubling(seq, make_parse_mesh()))


@pytest.mark.parametrize("size", SIZES)
def test_mesh_stats_count_the_exchanges(worlds, size):
    """Every rank counts the same exchanges and doubling rounds."""
    stats = [r["stats"] for r in worlds[size]]
    assert all(s["exchanges"] == stats[0]["exchanges"] for s in stats)
    assert all(s["rounds"] == stats[0]["rounds"] for s in stats)
    assert len(stats[0]["rounds"]) == len(DOUBLING)
    assert stats[0]["exchanges"] > 0
