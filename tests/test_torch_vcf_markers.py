"""The port's marker modules (markers/marker, mps, rle_window, ma and the
device SA->MA permute ma_dev) against pfbwtf_tpu's: the same packed
markers, .mps bytes, interval lookups and .ma runs."""

import io

import numpy as np
import pytest

from pfbwtf_tpu.markers import marker as jax_marker
from pfbwtf_tpu.markers import mps as jax_mps
from pfbwtf_tpu.markers.ma import marker_array_from_sa as jax_ma
from pfbwtf_tpu.markers.ma import write_marker_array as jax_write_ma
from pfbwtf_tpu.markers.ma_jax import marker_array_from_sa_jax
from pfbwtf_tpu.markers.rle_window import RleWindowArray as JaxRle
from pfbwtf_tpu_torch.markers import marker, mps
from pfbwtf_tpu_torch.markers.ma import marker_array_from_sa
from pfbwtf_tpu_torch.markers.ma import write_marker_array
from pfbwtf_tpu_torch.markers.ma_dev import marker_array_from_sa_dev
from pfbwtf_tpu_torch.markers.rle_window import RleWindowArray


def _random_runs(rng, nruns=40, span=5000, pool=3):
    """An .mps byte stream of ``nruns`` disjoint increasing runs in
    [1, span), each carrying one of ``pool`` marker lists."""
    edges = np.sort(rng.choice(np.arange(1, span), size=2 * nruns,
                               replace=False)).astype(np.uint64)
    lists = [np.array(rng.integers(1, 1 << 50, size=k), np.uint64)
             for k in range(1, pool + 1)]
    markers = [lists[int(i)] for i in rng.integers(0, pool, nruns)]
    buf = io.BytesIO()
    mps.write_mps_runs(buf, edges[0::2], edges[1::2], markers)
    return buf.getvalue()


def _assert_runs_equal(got, want):
    assert np.array_equal(got[0], want[0]) and got[0].dtype == want[0].dtype
    assert np.array_equal(got[1], want[1]) and got[1].dtype == want[1].dtype
    assert len(got[2]) == len(want[2])
    for a, b in zip(got[2], want[2]):
        assert np.array_equal(a, b) and a.dtype == b.dtype


def test_marker_packing_equals_jax():
    rng = np.random.default_rng(60)
    pos = rng.integers(0, 1 << 46, size=500).astype(np.uint64)
    allele = rng.integers(0, 20, size=500).astype(np.uint64)
    seq = rng.integers(0, 1 << 17, size=500).astype(np.uint64)
    got = marker.create_marker(pos, allele, seq)
    want = jax_marker.create_marker(pos, allele, seq)
    assert np.array_equal(got, want)
    for fn in ("get_pos", "get_seq", "get_allele"):
        assert np.array_equal(getattr(marker, fn)(got),
                              getattr(jax_marker, fn)(want))
    assert marker.DELIM == jax_marker.DELIM


@pytest.mark.parametrize("writer", ["MarkerPositionsWriter",
                                    "BatchMarkerPositionsWriter"])
def test_mps_writers_equal_jax(writer):
    """Random marker streams over three sequences, wsizes 1-11."""
    rng = np.random.default_rng(61)
    for trial in range(20):
        wsize = int(rng.integers(1, 12))
        bufs = []
        for mod in (mps, jax_mps):
            rng_t = np.random.default_rng(trial)
            buf = io.BytesIO()
            w = getattr(mod, writer)(wsize, buf)
            base = 0
            for seqid in range(3):
                n = int(rng_t.integers(0, 40))
                pos = base + np.cumsum(rng_t.integers(1, wsize + 3, size=n))
                for i in range(n):
                    w.update(int(pos[i]), int(rng_t.integers(0, 50)),
                             int(rng_t.integers(0, 3)), seqid)
                w.finish_sequence()
                base = int(pos[-1]) + 1 if n else base
            bufs.append(buf.getvalue())
        assert bufs[0] == bufs[1], (writer, trial, wsize)


def test_mps_and_rle_window_round_trips_equal_jax(tmp_path):
    """read/write_mps_runs, RleWindowArray's lookups and its serialize /
    load round trip give pfbwtf_tpu's bytes and answers."""
    rng = np.random.default_rng(62)
    raw = _random_runs(rng, nruns=60)
    runs, jruns = mps.read_mps_runs(raw), jax_mps.read_mps_runs(raw)
    _assert_runs_equal(runs, jruns)
    buf = io.BytesIO()
    mps.write_mps_runs(buf, *runs)
    assert buf.getvalue() == raw
    a, b = RleWindowArray(raw), JaxRle(raw)
    q = rng.integers(0, 5200, size=3000)
    assert np.array_equal(a.run_index(q), b.run_index(q))
    assert np.array_equal(a.content_ids(), b.content_ids())
    for p in q[:50]:
        assert np.array_equal(a.at(int(p)), b.at(int(p)))
        assert np.array_equal(a.at_range(int(p), int(p) + 300),
                              b.at_range(int(p), int(p) + 300))
    n1 = a.serialize(str(tmp_path / "port.rlwa"))
    n2 = b.serialize(str(tmp_path / "jax.rlwa"))
    assert n1 == n2
    assert ((tmp_path / "port.rlwa").read_bytes()
            == (tmp_path / "jax.rlwa").read_bytes())
    c = RleWindowArray.load(str(tmp_path / "jax.rlwa"))
    assert np.array_equal(c.starts, a.starts) and np.array_equal(c.ends, a.ends)


def test_merge_mps_equals_jax(tmp_path):
    rng = np.random.default_rng(63)
    prefixes = []
    for i, n in enumerate((700, 1500, 900)):
        p = tmp_path / f"h{i}"
        (tmp_path / f"h{i}.mps").write_bytes(_random_runs(rng, 10, n - 10))
        (tmp_path / f"h{i}.n").write_text(f"{n}\n")
        prefixes.append(str(p))
    mps.merge_mps(str(tmp_path / "port.mps"), prefixes)
    jax_mps.merge_mps(str(tmp_path / "jax.mps"), prefixes)
    got = (tmp_path / "port.mps").read_bytes()
    assert len(got) > 0 and got == (tmp_path / "jax.mps").read_bytes()


# SA inputs: a permutation of [0, n], values past every run, and runs on
# an .mps with no runs at all
SA_CASES = ("permutation", "past_runs", "empty_mps", "empty_sa")


@pytest.mark.parametrize("case", SA_CASES)
def test_marker_array_from_sa_equals_jax(case):
    """ma.marker_array_from_sa (host numpy) and marker_array_from_sa_dev
    on the CPU device against pfbwtf_tpu's host and JAX permutes."""
    rng = np.random.default_rng(64)
    raw = _random_runs(rng, nruns=80, span=6000, pool=4)
    sa = rng.permutation(6001).astype(np.uint64)
    if case == "past_runs":
        sa = np.concatenate((sa, rng.integers(6000, 1 << 40, size=500)
                             .astype(np.uint64)))
    elif case == "empty_mps":
        raw = b""
    elif case == "empty_sa":
        sa = sa[:0]
    mai, jmai = RleWindowArray(raw), JaxRle(raw)
    if case == "empty_mps":
        # pfbwtf_tpu's host permute indexes an empty content table here
        # (a fault the port does not copy); its JAX permute gives no runs
        with pytest.raises(IndexError):
            jax_ma(sa, jmai)
        want = marker_array_from_sa_jax(sa, jmai)
        assert len(want[2]) == 0
    else:
        want = jax_ma(sa, jmai)
    _assert_runs_equal(marker_array_from_sa(sa, mai), want)
    _assert_runs_equal(marker_array_from_sa_dev(sa, mai, device="cpu"), want)
    if len(sa):
        _assert_runs_equal(marker_array_from_sa_jax(sa, jmai), want)
    if case == "permutation":
        assert len(want[2]) > 10


def test_marker_array_dev_takes_tensors_and_int64():
    """The device permute takes an int64 array or a tensor of the SA."""
    import torch

    rng = np.random.default_rng(65)
    raw = _random_runs(rng)
    sa = rng.permutation(5001)
    mai = RleWindowArray(raw)
    want = jax_ma(sa, JaxRle(raw))
    _assert_runs_equal(marker_array_from_sa_dev(sa, mai, device="cpu"), want)
    _assert_runs_equal(
        marker_array_from_sa_dev(torch.from_numpy(sa), mai, device="cpu"),
        want)


def test_write_marker_array_equals_jax(tmp_path):
    """mps_to_ma's core: .sa file and array inputs, the same .ma bytes."""
    rng = np.random.default_rng(66)
    (tmp_path / "x.mps").write_bytes(_random_runs(rng, nruns=30, span=900))
    sa = rng.permutation(1000).astype(np.uint64)
    (tmp_path / "x.sa").write_bytes(sa.tobytes())
    jax_write_ma(str(tmp_path / "x.mps"), str(tmp_path / "x.sa"),
                 str(tmp_path / "jax.ma"))
    write_marker_array(str(tmp_path / "x.mps"), str(tmp_path / "x.sa"),
                       str(tmp_path / "port.ma"), device="cpu")
    write_marker_array(str(tmp_path / "x.mps"), sa, str(tmp_path / "arr.ma"),
                       device="cpu")
    want = (tmp_path / "jax.ma").read_bytes()
    assert len(want) > 0
    assert (tmp_path / "port.ma").read_bytes() == want
    assert (tmp_path / "arr.ma").read_bytes() == want
