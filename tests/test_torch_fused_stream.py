"""The port's streamed build (pfbwtf_tpu_torch/ops/fused_stream.py) against
the JAX package's streamed build, stage by stage, and against the host
path.  All on the CPU; every comparison is exact."""

import io
import json
import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfbwtf_tpu.ops import fused as jfused
from pfbwtf_tpu.ops import fused_stream as jstream
from pfbwtf_tpu.ops.bwt import assemble_bwt
from pfbwtf_tpu.ops.parse import ParserParams as JParams, parse_records
from pfbwtf_tpu.ops.parse_bwt import bwt_of_parse
from pfbwtf_tpu_torch.ops import fused as tfused
from pfbwtf_tpu_torch.ops import fused_stream as tstream
from pfbwtf_tpu_torch.ops.parse import ParserParams, build_stream
from pfbwtf_tpu_torch.ops.suffix import capture_levels
from pfbwtf_tpu_torch.utils.errors import PfbwtError

ACGT = np.frombuffer(b"ACGT", np.uint8)
MASK64 = (1 << 64) - 1
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _case(name):
    """(records, w, p, chunk_target) of the tests/test_fused_stream.py
    inputs."""
    if name == "many_chunks":
        rng = np.random.default_rng(21)
        return [("s", rng.choice(ACGT, size=6000))], 4, 10, 256
    if name == "single_chunk":
        rng = np.random.default_rng(22)
        return [("s", rng.choice(ACGT, size=3000))], 4, 10, 1 << 24
    if name == "oversized_groups":
        rng = np.random.default_rng(23)
        seq = np.tile(rng.choice(ACGT, size=500), 20)
        muts = rng.integers(0, seq.size, size=25)
        seq[muts] = ACGT[rng.integers(0, 4, size=25)]
        return [("r", seq)], 4, 12, 64
    if name == "multi_record":
        rng = np.random.default_rng(24)
        return [("a", rng.choice(ACGT, size=2500)),
                ("b", rng.choice(ACGT, size=1500))], 4, 8, 512
    rng = np.random.default_rng(25)  # checksum_only
    return [("s", rng.choice(ACGT, size=4000))], 4, 10, 512


def _host_reference(records, w, p):
    res = parse_records(records, JParams(w=w, p=p, get_sai=True))
    pb = bwt_of_parse(res.parse_ranks, res.last, res.sai, get_sai=True)
    return assemble_bwt(
        res.dict_flat(), w, res.occs.astype(np.int64), pb.bwlast,
        pb.ilist, pb.bwsai, res.n, want_sa=True, want_rssa=True,
    )


def _stream_files(fn, C, w, p, **kw):
    bwt_fp, sa_fp = io.BytesIO(), io.BytesIO()
    out = fn(C, w, p, bwt_fp=bwt_fp, sa_fp=sa_fp, want_rssa=True, **kw)
    return bwt_fp.getvalue(), sa_fp.getvalue(), out


@pytest.mark.parametrize("name", ["many_chunks", "single_chunk",
                                  "oversized_groups", "multi_record",
                                  "checksum_only"])
def test_whole_stream_matches_jax_and_host(name):
    records, w, p, ct = _case(name)
    C, _, _ = build_stream(records, ParserParams(w=w, p=p))
    want = _host_reference(records, w, p)
    want_ck = int(want.bwt.astype(np.uint64).sum()
                  + want.sa.astype(np.uint64).sum()) & MASK64
    if name == "checksum_only":
        got = tstream.pfbwt_fused_stream(C, w, p, chunk_target=ct,
                                         device="cpu")
        assert got == jstream.pfbwt_fused_stream(C, w, p, chunk_target=ct)
        assert got == (None, want.bwt.shape[0], want_ck)
        return
    info = {}
    bwt, sa, out = _stream_files(tstream.pfbwt_fused_stream, C, w, p,
                                 chunk_target=ct, device="cpu", info=info)
    jbwt, jsa, jout = _stream_files(jstream.pfbwt_fused_stream, C, w, p,
                                    chunk_target=ct)
    assert bwt == jbwt and sa == jsa
    assert out[:3] == jout[:3]
    assert np.array_equal(out[3], jout[3]) and np.array_equal(out[4], jout[4])
    assert bwt == want.bwt.tobytes()
    assert sa == want.sa.astype("<u8").tobytes()
    assert out[:3] == (want.nruns, want.bwt.shape[0], want_ck)
    assert np.array_equal(out[3], want.ssa)
    assert np.array_equal(out[4], want.esa)
    assert info["n_chunks"] >= (8 if name == "many_chunks" else 1)
    assert info["j2_stream"] is False and info["j2_runs"] == 1


def _j2_state(records, w, p):
    """JAX's monolithic J2 state (numpy) and the J3a sizes."""
    C, _, _ = build_stream(records, ParserParams(w=w, p=p))
    C_len = C.shape[0]
    n_b = tfused._bucket(C_len, 1 << 16)
    chars_p = np.full(n_b, ord("A"), np.uint8)
    chars_p[:C_len] = C
    nph_b = tfused._bucket(tfused.speculative_nphrases(C_len, p))
    fn = jax.jit(partial(jfused._parse_core, w=w, p=p, nph_b=nph_b,
                         scan_impl="xla"))
    state = tuple(np.asarray(a)
                  for a in fn(jnp.asarray(chars_p), jnp.int64(C_len)))
    ncuts, D, dict_total, max_len = (int(x) for x in state[-1])
    nsuf = (dict_total - 1 - D) - D * w
    sizes = dict(n=C_len, nphrases=ncuts + 1, D=D, dict_total=dict_total,
                 nsuf=nsuf, dict_b=tfused._bucket(dict_total),
                 nsuf_b=tfused._bucket(nsuf),
                 n_levels=capture_levels(max_len, w))
    return state, sizes


@pytest.mark.parametrize("name", ["many_chunks", "oversized_groups"])
def test_j3a_and_j3e_match_jax(name):
    """One J2 state through both J3a's: the chunk table is equal, the
    dict-scale arrays equal on their valid lanes; then every chunk's
    [:m_c] BWT and SA and its checksum are equal."""
    records, w, p, ct = _case(name)
    state, sz = _j2_state(records, w, p)
    max_chunks = 256
    jfn = jax.jit(partial(
        jstream._dict_state_core, w=w, dict_b=sz["dict_b"],
        nsuf_b=sz["nsuf_b"], max_chunks=max_chunks, impl="lax",
        n_levels=sz["n_levels"], alphabet="byte",
    ))
    jout = jfn(*(jnp.asarray(a) for a in state[:-1]),
               *(jnp.int64(v) for v in (sz["nphrases"], sz["D"],
                                        sz["dict_total"], sz["nsuf"], ct)))
    (dict_flat, sa_kept, gid, u, ls, emis_prefix, seg_start, bwlast, ilist,
     bwsai, prev_sep, jtable) = (np.asarray(a) for a in jout)
    st, table = tstream._dict_state_core(
        *tfused.parse_state_from_numpy(state, "cpu")[:-1], sz["nphrases"],
        sz["D"], sz["dict_total"], sz["nsuf"], ct, w, sz["dict_b"],
        sz["nsuf_b"], max_chunks, n_levels=sz["n_levels"],
    )
    assert table.tolist() == jtable.tolist()
    ns, nph1 = sz["nsuf"], sz["nphrases"] + 1
    t = {k: v.numpy() for k, v in st.items()}
    assert np.array_equal(t["dict_flat"][: sz["dict_total"]],
                          dict_flat[: sz["dict_total"]])
    for key, want in (("sa_kept", sa_kept), ("gid", gid), ("u", u),
                      ("ls", ls), ("first", emis_prefix)):
        assert np.array_equal(t[key][:ns], want[:ns]), key
    assert np.array_equal(t["seg_start"][: sz["D"]], seg_start[: sz["D"]])
    assert np.array_equal(t["seg_u"][:ns], seg_start[u[:ns]])
    prevch = np.concatenate(([0], dict_flat[:-1])).astype(np.int64)
    want_flags = (prev_sep.astype(np.int64) << 8) | prevch
    assert np.array_equal(t["flags"][:ns], want_flags[sa_kept[:ns]])
    assert np.array_equal(t["bwlast"][:nph1], bwlast[:nph1])
    assert np.array_equal(t["ilist"][:nph1], ilist[:nph1])
    assert np.array_equal(t["bwsai"][:nph1].view(np.uint64), bwsai[:nph1])

    tbl = table.tolist()
    s_starts = tbl[: max_chunks + 1]
    bases = tbl[max_chunks + 1: 2 * (max_chunks + 1)]
    chunk_b = tfused._bucket(max(tbl[-2], 1))
    jchunk = jax.jit(partial(jstream._chunk_core, chunk_b=chunk_b,
                             impl="lax"))
    chunks = 0
    for c in range(max_chunks):
        m_c = bases[c + 1] - bases[c]
        if m_c == 0:
            continue
        scal = (s_starts[c], s_starts[c + 1], bases[c], m_c, sz["n"])
        jb, jsa, jck, jbad = (np.asarray(a) for a in jchunk(
            *(jnp.asarray(a) for a in jout[:11]),
            *(jnp.int64(v) for v in scal)))
        bwtc, sa_vals, ck, bad = tstream._chunk_core(
            **{k: st[k] for k in tstream._CHUNK_KEYS}, s0=scal[0],
            s1=scal[1], base=scal[2], m_true=m_c, n_text=sz["n"],
            chunk_b=chunk_b,
        )
        assert np.array_equal(bwtc[:m_c].numpy(), jb[:m_c])
        assert np.array_equal(sa_vals[:m_c].numpy().view(np.uint64),
                              jsa[:m_c])
        assert int(ck) & MASK64 == int(jck)
        assert int(bad) == int(jbad) == 0
        chunks += 1
    assert chunks >= 8


def test_max_chunks_exceeded_dies():
    rng = np.random.default_rng(26)
    C, _, _ = build_stream([("s", rng.choice(ACGT, size=6000))],
                           ParserParams(w=4, p=10))
    with pytest.raises(PfbwtError, match="more than"):
        tstream.pfbwt_fused_stream(C, 4, 10, chunk_target=16, max_chunks=4,
                                   device="cpu")


def test_streamed_j2_gives_the_same_bytes():
    rng = np.random.default_rng(80)
    C, _, _ = build_stream([("s", rng.choice(ACGT, size=40_000))],
                           ParserParams(w=4, p=10))
    a_info, b_info = {}, {}
    a = _stream_files(tstream.pfbwt_fused_stream, C, 4, 10, device="cpu",
                      info=a_info)
    b = _stream_files(tstream.pfbwt_fused_stream, C, 4, 10, device="cpu",
                      j2_stream=True, j2_chunk=1 << 14, info=b_info)
    assert a[:2] == b[:2] and a[2][:3] == b[2][:3]
    assert np.array_equal(a[2][3], b[2][3])
    assert np.array_equal(a[2][4], b[2][4])
    assert not a_info["j2_stream"] and b_info["j2_stream"]


def test_sa_dtype_of_4_bytes():
    records, w, p, ct = _case("multi_record")
    C, _, _ = build_stream(records, ParserParams(w=w, p=p))
    u4 = np.dtype("<u4")
    bwt, sa, out = _stream_files(tstream.pfbwt_fused_stream, C, w, p,
                                 chunk_target=ct, sa_dtype=u4, device="cpu")
    jbwt, jsa, jout = _stream_files(jstream.pfbwt_fused_stream, C, w, p,
                                    chunk_target=ct, sa_dtype=u4)
    want = _host_reference(records, w, p)
    assert bwt == jbwt and sa == jsa == want.sa.astype(u4).tobytes()
    assert out[3].dtype == u4 and np.array_equal(out[3], jout[3])
    assert np.array_equal(out[4], want.esa.astype(u4))


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    C = np.frombuffer(b"ACGTTGCA" * 100, np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstream.pfbwt_fused_stream(C, 4, 10)


def test_profile_trace_reads_by_stage(tmp_path):
    """PFBWT_PROFILE=<dir>: the -m CLI's stages are named ranges of the
    Chrome trace written at exit."""
    fa = tmp_path / "in.fa"
    rng = np.random.default_rng(27)
    fa.write_bytes(b">r\n" + rng.choice(ACGT, size=3000).tobytes() + b"\n")
    code = ("import sys; from pfbwtf_tpu_torch.cli.pfbwt_f import main; "
            "sys.exit(main(sys.argv[1:], device='cpu'))")
    env = dict(os.environ, PYTHONPATH=REPO,
               PFBWT_PROFILE=str(tmp_path / "prof"))
    proc = subprocess.run(
        [sys.executable, "-c", code, str(fa), "-o", str(tmp_path / "o"),
         "--fused", "-m", "-p", "20"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    traces = list((tmp_path / "prof").glob("pfbwt_*.json"))
    assert len(traces) == 1
    names = {ev.get("name") for ev in json.loads(traces[0].read_text())
             ["traceEvents"]}
    for stage in ("streamed build: J2 parse",
                  "streamed build: J3a dict sort, parse-BWT, chunk table",
                  "streamed build: J3e emission chunks"):
        assert stage in names
