"""The port's fused mesh build (pfbwtf_tpu_torch/parallel/fused_mesh.py)
in 2- and 3-rank gloo worlds, against pfbwtf_tpu's fused mesh build on
its 8-device CPU mesh and the port's single-device fused build: equal
.bwt/.sa/.ssa/.esa and run counts, on rank 0 (None elsewhere); and the
staged mesh fallback where the packed key passes its bit budget, entered
on both sides by narrowing the budget."""

import functools

import numpy as np
import pytest

from tests.torch_worlds import run_world

SIZES = (2, 3)
ACGT = np.frombuffer(b"ACGT", np.uint8)
CASES = ("random_w10", "random_w4", "repetitive", "one_record_small_p",
         "key_bits_fallback")


def _records(name):
    """(records, w, p) as tests/test_fused_mesh.py builds them, from a
    seed of each case's own."""
    rng = np.random.default_rng(CASES.index(name) + 31)
    if name == "repetitive":
        unit = rng.choice(ACGT, size=700)
        recs = []
        for i in range(8):
            hap = unit.copy()
            pos = rng.integers(0, hap.size, size=6)
            hap[pos] = ACGT[rng.integers(0, 4, size=6)]
            recs.append((f"h{i}", hap))
        return recs, 4, 11
    if name == "one_record_small_p":
        return [("one", rng.choice(ACGT, size=4097))], 4, 5
    n, w, p = (20_000, 10, 17) if name == "random_w10" else (6_000, 4, 8)
    return [("c1", rng.choice(ACGT, size=n // 2)),
            ("c2", rng.choice(ACGT, size=n - n // 2))], w, p


def _outputs(bw):
    return {"bwt": bw.bwt, "sa": bw.sa, "ssa": bw.ssa, "esa": bw.esa,
            "nruns": bw.nruns}


def _world_cases(mesh):
    import warnings

    from pfbwtf_tpu_torch.ops.parse import ParserParams
    from pfbwtf_tpu_torch.parallel import fused_mesh

    out = {}
    for name in CASES:
        recs, w, p = _records(name)
        budget = fused_mesh._KEY_BITS
        if name == "key_bits_fallback":
            fused_mesh._KEY_BITS = 0
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                bw = fused_mesh.pfbwt_fused_mesh_records(
                    recs, ParserParams(w=w, p=p), mesh, want_sa=True,
                    want_rssa=True)
        finally:
            fused_mesh._KEY_BITS = budget
        out[name] = (None if bw is None else _outputs(bw),
                     any("exceeds 63 bits" in str(x.message) for x in seen))
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {n: run_world(n, _world_cases, tmp_path_factory.mktemp(f"w{n}"))
            for n in SIZES}


class _WideCeil:
    """numpy with ``ceil`` 30 higher: pfbwtf_tpu's fused mesh build sizes
    its key's bit fields (and nothing else) with np.ceil, so its 63-bit
    budget is passed."""

    def __getattr__(self, name):
        return getattr(np, name)

    @staticmethod
    def ceil(x):
        return np.ceil(x) + 30


@functools.lru_cache(maxsize=None)
def _expected(name):
    """(the port's single-device fused build, pfbwtf_tpu's fused mesh
    build), once a case for both world sizes."""
    from pfbwtf_tpu.ops.parse import ParserParams as JaxParams
    from pfbwtf_tpu.parallel import fused_mesh as jax_fused_mesh
    from pfbwtf_tpu.parallel.sharded import make_parse_mesh
    from pfbwtf_tpu_torch.ops.fused import pfbwt_fused_records
    from pfbwtf_tpu_torch.ops.parse import ParserParams

    recs, w, p = _records(name)
    single, _ = pfbwt_fused_records(recs, ParserParams(w=w, p=p),
                                    device="cpu", want_sa=True,
                                    want_rssa=True)
    jax_args = (recs, JaxParams(w=w, p=p, get_sai=True), make_parse_mesh())
    if name == "key_bits_fallback":
        with pytest.MonkeyPatch.context() as mp, \
                pytest.warns(UserWarning, match="exceeds 63 bits"):
            mp.setattr(jax_fused_mesh, "np", _WideCeil())
            jbw = jax_fused_mesh.pfbwt_fused_mesh_records(
                *jax_args, want_sa=True, want_rssa=True)
    else:
        jbw = jax_fused_mesh.pfbwt_fused_mesh_records(
            *jax_args, want_sa=True, want_rssa=True)
    return _outputs(single), _outputs(jbw)


def _assert_same(got, want):
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert np.array_equal(got[k], v), k
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", CASES)
def test_fused_mesh_equals_jax_and_single_device(worlds, size, name):
    got, warned = worlds[size][0][name]
    assert warned == (name == "key_bits_fallback")
    for res, warned_r in (r[name] for r in worlds[size][1:]):
        assert res is None and warned_r == warned
    single, jax_mesh = _expected(name)
    _assert_same(got, single)
    _assert_same(got, jax_mesh)
