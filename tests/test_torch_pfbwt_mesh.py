"""The port's stages 2-3 over the mesh (pfbwtf_tpu_torch/parallel/
pfbwt_mesh.py) in 2- and 3-rank gloo worlds: the mesh parse, then
mesh_parse_bwt and mesh_assemble_bwt, against pfbwtf_tpu's mesh stages
on its 8-device CPU mesh and the port's single-device stages (equal
.bwlast/.ilist/.bwsai and .bwt/.sa/.ssa/.esa, run counts)."""

import functools

import numpy as np
import pytest

from tests.torch_worlds import run_world

SIZES = (2, 3)
ACGT = np.frombuffer(b"ACGT", np.uint8)
CASES = ("random_w10", "random_w4", "repetitive")


def _records(name):
    """(records, w, p) of a case, as tests/test_pfbwt_mesh.py builds
    them, from a seed of its own."""
    rng = np.random.default_rng(CASES.index(name) + 21)
    if name == "repetitive":
        seq = np.tile(rng.choice(ACGT, size=700), 10)
        muts = rng.integers(0, seq.size, size=25)
        seq[muts] = ACGT[rng.integers(0, 4, size=25)]
        return [("r", seq)], 4, 11
    n, w, p = (20_000, 10, 17) if name == "random_w10" else (6_000, 4, 8)
    return [("c1", rng.choice(ACGT, size=n // 2)),
            ("c2", rng.choice(ACGT, size=n - n // 2))], w, p


def _outputs(pb, bw):
    return {"bwlast": pb.bwlast, "ilist": pb.ilist, "bwsai": pb.bwsai,
            "bwt": bw.bwt, "sa": bw.sa, "ssa": bw.ssa, "esa": bw.esa,
            "nruns": bw.nruns}


def _world_cases(mesh):
    from pfbwtf_tpu_torch.ops.parse import ParserParams
    from pfbwtf_tpu_torch.parallel.dict_union import (
        distributed_parse_records)
    from pfbwtf_tpu_torch.parallel.pfbwt_mesh import (mesh_assemble_bwt,
                                                      mesh_parse_bwt)

    out = {}
    for name in CASES:
        recs, w, p = _records(name)
        res = distributed_parse_records(
            recs, ParserParams(w=w, p=p, get_sai=True), mesh)
        pb = mesh_parse_bwt(res.parse_ranks, res.last, res.sai, mesh)
        bw = mesh_assemble_bwt(
            res.dict_flat(), w, res.occs.astype(np.int64), pb.bwlast,
            pb.ilist, pb.bwsai, res.n, mesh, want_sa=True, want_rssa=True)
        out[name] = _outputs(pb, bw)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {n: run_world(n, _world_cases, tmp_path_factory.mktemp(f"w{n}"))
            for n in SIZES}


def _assert_same(got, want):
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert np.array_equal(got[k], v), k
        else:
            assert got[k] == v, k


@functools.lru_cache(maxsize=None)
def _expected(name):
    """(the port's single-device outputs, pfbwtf_tpu's mesh outputs), once
    a case for both world sizes."""
    from pfbwtf_tpu.ops.parse import ParserParams as JaxParams
    from pfbwtf_tpu.parallel.dict_union import (
        distributed_parse_records as jax_parse)
    from pfbwtf_tpu.parallel.pfbwt_mesh import (
        mesh_assemble_bwt as jax_assemble, mesh_parse_bwt as jax_parse_bwt)
    from pfbwtf_tpu.parallel.sharded import make_parse_mesh
    from pfbwtf_tpu_torch import engine
    from pfbwtf_tpu_torch.ops.parse import ParserParams

    recs, w, p = _records(name)
    res = engine.parse_records(recs, ParserParams(w=w, p=p, get_sai=True),
                               device="cpu")
    pb = engine.parse_bwt(res, device="cpu")
    bw = engine.assemble_bwt(res.dict_flat(), w, res.occs.astype(np.int64),
                             pb.bwlast, pb.ilist, pb.bwsai, res.n,
                             want_sa=True, want_rssa=True, device="cpu")
    mesh = make_parse_mesh()
    jres = jax_parse(recs, JaxParams(w=w, p=p, get_sai=True), mesh)
    jpb = jax_parse_bwt(jres.parse_ranks, jres.last, jres.sai, mesh)
    jbw = jax_assemble(
        jres.dict_flat(), w, jres.occs.astype(np.int64), jpb.bwlast,
        jpb.ilist, jpb.bwsai, jres.n, mesh, want_sa=True, want_rssa=True)
    return _outputs(pb, bw), _outputs(jpb, jbw)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", CASES)
def test_mesh_stages_equal_jax_and_single_device(worlds, size, name):
    got = worlds[size][0][name]
    for r in worlds[size][1:]:
        _assert_same(r[name], got)
    single, jax_mesh = _expected(name)
    _assert_same(got, single)
    _assert_same(got, jax_mesh)
