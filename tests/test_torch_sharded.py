"""The port's sharded cut scan and phrase sketch
(pfbwtf_tpu_torch/parallel/sharded.py) in 2- and 3-rank gloo worlds
against pfbwtf_tpu's on its 8-device CPU mesh and the host scan: equal
masks, counts and sketches, for w from 1 to 32 and for shards shorter
than the halo."""

import numpy as np
import pytest

from tests.torch_worlds import run_world

SIZES = (2, 3)
# (n, w, p); the last has shards shorter than the w-code halo
CUT_CASES = [(100_000, 10, 17), (37_777, 4, 5), (8_192, 32, 100),
             (5_000, 1, 3), (40, 32, 3)]
SKETCH = (64_008, 10, 17, 12)  # n a multiple of 2, 3 and 8: no padding


def _chars(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n)


def _codes(chars):
    from pfbwtf_tpu_torch.utils.tables import NTOA_TABLE

    return NTOA_TABLE[chars]


def _world_cases(mesh):
    """Every case in this world; runs on each rank."""
    from pfbwtf_tpu_torch.parallel.sharded import (
        _blocks_of, sharded_cut_mask, sharded_parse_step,
        sharded_phrase_sketch)

    out = {}
    for i, (n, w, p) in enumerate(CUT_CASES):
        codes = _codes(_chars(n, 100 + i))
        out["cut", i] = sharded_cut_mask(codes, w, p, mesh)
        blk, shard_len = _blocks_of(codes, mesh)
        cut, total = sharded_parse_step(w, p, mesh, shard_len)(blk)
        out["step", i] = (cut.numpy(), int(total), shard_len)
    n, w, p, bits = SKETCH
    out["sketch"] = sharded_phrase_sketch(_codes(_chars(n, 200)), w, p,
                                          mesh, sketch_bits=bits)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {n: run_world(n, _world_cases, tmp_path_factory.mktemp(f"w{n}"))
            for n in SIZES}


def _padded_cut(chars, w, p, size):
    """The host scan over the stream padded with 'A' to a multiple of
    ``size`` (the count the collective sums)."""
    from pfbwtf_tpu.ops.hash import hash_scan_np

    L = -(-chars.shape[0] // size)
    pad = np.full(size * L, ord("A"), np.uint8)
    pad[: chars.shape[0]] = chars
    return hash_scan_np(pad, w, p)[2]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("case", range(len(CUT_CASES)))
def test_sharded_cut_mask_equals_jax(worlds, size, case):
    from pfbwtf_tpu.ops.hash import hash_scan_np
    from pfbwtf_tpu.parallel.sharded import make_parse_mesh, sharded_cut_mask

    n, w, p = CUT_CASES[case]
    chars = _chars(n, 100 + case)
    ranks = worlds[size]
    cut, total = ranks[0]["cut", case]
    for r in ranks[1:]:
        assert np.array_equal(r["cut", case][0], cut)
        assert r["cut", case][1] == total
    want = hash_scan_np(chars, w, p)[2]
    assert np.array_equal(cut, want)
    assert total == int(_padded_cut(chars, w, p, size).sum())
    mesh = make_parse_mesh()
    if -(-n // mesh.devices.size) >= w - 1:
        # pfbwtf_tpu's halo comes from one shard back: it needs shards of
        # at least w - 1 codes, the port's does not
        jax_cut, _ = sharded_cut_mask(_codes(chars), w, p, mesh)
        assert np.array_equal(cut, jax_cut)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("case", range(len(CUT_CASES)))
def test_sharded_parse_step_blocks(worlds, size, case):
    """Each rank's step returns its block of the global mask and the
    global count."""
    n, w, p = CUT_CASES[case]
    padded = _padded_cut(_chars(n, 100 + case), w, p, size)
    for rank, res in enumerate(worlds[size]):
        cut, total, L = res["step", case]
        assert np.array_equal(cut, padded[rank * L: (rank + 1) * L])
        assert total == int(padded.sum())


@pytest.mark.parametrize("size", SIZES)
def test_sharded_phrase_sketch_equals_jax(worlds, size):
    from pfbwtf_tpu.ops.hash import wang_hash_np, window_kmers_np
    from pfbwtf_tpu.parallel.sharded import (make_parse_mesh,
                                             sharded_phrase_sketch)

    n, w, p, bits = SKETCH
    chars = _chars(n, 200)
    got = worlds[size][0]["sketch"]
    for r in worlds[size][1:]:
        assert np.array_equal(r["sketch"], got)
    cut = _padded_cut(chars, w, p, size)
    L = cut.shape[0]
    pad = np.zeros(L, np.uint8)
    pad[:n] = _codes(chars)
    h = wang_hash_np(window_kmers_np(pad, w))
    bucket = (h >> np.uint64(40)).astype(np.int64) % (1 << bits)
    assert np.array_equal(got, np.bincount(bucket[cut], minlength=1 << bits))
    assert np.array_equal(got, sharded_phrase_sketch(
        _codes(chars), w, p, make_parse_mesh(), sketch_bits=bits))
