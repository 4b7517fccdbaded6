"""The plain versions of kernels K2-K4 (pfbwtf_tpu_torch/ops/gather.py)
against the TPU gather probe's Pallas kernels (benchmarks/gather_probe.py)
run in interpret mode on the CPU, and the dispatch by device.

The probe's K2 body ``_k_take`` and its baseline ``xla_take`` call
``jnp.take(..., mode="promise_in_bounds")``, which the installed JAX
rejects ("Invalid mode 'promise_in_bounds' for np.take") in interpret
mode and outside it.  K2's plain version is therefore held against numpy
``table[idx]`` and ``jnp.take(table, idx)`` on in-range indices.  K3 and
K4 run as the probe wrote them, with ``pl.pallas_call(...,
interpret=True)``, on a 4096-entry table and 65,536 indices (a multiple
of the probe's (8, 1024) block)."""

import functools
import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfbwtf_tpu_torch.ops import gather
from pfbwtf_tpu_torch.ops.cuda import gather as kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, N = 4096, 65536


@pytest.fixture
def probe(monkeypatch):
    """benchmarks/gather_probe.py, loaded with a clean ``sys.argv`` (it
    reads its sizes from argv at import) and with its pallas_call in
    interpret mode."""
    monkeypatch.setattr(sys, "argv", ["gather_probe.py"])
    spec = importlib.util.spec_from_file_location(
        "tpu_gather_probe", os.path.join(REPO, "benchmarks", "gather_probe.py"))
    gp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gp)
    monkeypatch.setattr(gp.pl, "pallas_call",
                        functools.partial(gp.pl.pallas_call, interpret=True))
    return gp


def _inputs(seed, lo, hi):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 1 << 30, size=T, dtype=np.int32)
    idx = rng.integers(lo, hi, size=N, dtype=np.int32)
    return table, idx


def test_take_plain_equals_numpy_and_jnp_take():
    table, idx = _inputs(0, 0, T)
    got = gather.take(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), table[idx])
    assert np.array_equal(got.numpy(), np.asarray(jnp.take(table, idx)))


@pytest.mark.parametrize("lo,hi", [(0, T), (-T, 2 * T), (-3 * T, 3 * T)],
                         ids=["in-range", "wrap-and-fill", "far"])
def test_take_along_plain_equals_pallas_tala(probe, lo, hi):
    table, idx = _inputs(1, lo, hi)
    want = np.asarray(probe.pallas_tala(jnp.asarray(table), jnp.asarray(idx)))
    got = gather.take_along(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    if lo < 0:
        # the measured semantics: [-T, 0) wraps, the rest is INT32_MIN
        wraps = (idx < 0) & (idx >= -T)
        assert np.array_equal(want[wraps], table[idx[wraps] + T])
        assert (want[(idx >= T) | (idx < -T)] == gather.INT32_MIN).all()


@pytest.mark.parametrize("lo,hi", [(0, T), (-T, 2 * T)],
                         ids=["in-range", "clip"])
def test_take_rows_plain_equals_pallas_rows(probe, lo, hi):
    table, idx = _inputs(2, lo, hi)
    want = np.asarray(probe.pallas_rows(jnp.asarray(table), jnp.asarray(idx)))
    got = gather.take_rows(torch.from_numpy(table), torch.from_numpy(idx))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, table[np.clip(idx, 0, T - 1)])


def test_cpu_tensor_takes_the_plain_version(monkeypatch):
    """A CPU tensor never reaches a kernel wrapper."""
    def boom(*_):
        raise AssertionError("kernel wrapper called for a CPU tensor")

    for name in ("take", "take_along", "take_rows"):
        monkeypatch.setattr(kernels, name, boom)
    table, idx = _inputs(3, 0, T)
    tt, it = torch.from_numpy(table), torch.from_numpy(idx)
    for fn in (gather.take, gather.take_along, gather.take_rows):
        assert np.array_equal(fn(tt, it).numpy(), table[idx])
    assert kernels.launches == {"take": 0, "take_along": 0, "take_rows": 0}


@pytest.mark.parametrize("name", ["take", "take_along", "take_rows"])
def test_wrapper_rejects_bad_input(name):
    wrapper = getattr(kernels, name)
    t32 = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        wrapper(t32, torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="int32"):
        wrapper(t32.to(torch.int64), torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(t32, torch.zeros(8, dtype=torch.int32)[::2])
    with pytest.raises(ValueError, match="unsupported device"):
        wrapper(t32, torch.zeros(4, dtype=torch.int32))


def test_probe_main_on_cpu_matches(capsys):
    from pfbwtf_tpu_torch.probes.gather_probe import main

    res = main(["1000", "20000"], device="cpu")
    assert set(res) == {"torch.take", "K2 take", "K3 take_along",
                        "K4 take_rows"}
    assert all(ok for label, (_, ok) in res.items() if label != "torch.take")
    out = capsys.readouterr().out
    assert out.count("matches torch.take: True") == 3
