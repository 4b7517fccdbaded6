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


# the limit an NVIDIA H100 80GB HBM3 reports: 232,448 opt-in bytes less
# 12 for an offset table's shift
H100_LIMIT = 232_436


@pytest.mark.parametrize("table_bytes,tier", [
    (H100_LIMIT - 4, "smem"), (H100_LIMIT, "smem"), (H100_LIMIT + 4, "l2"),
    (4, "smem"), (4 << 20, "l2")],
    ids=["limit-4", "limit", "limit+4", "T=1", "probe"])
def test_gather_tier(table_bytes, tier):
    assert kernels.gather_tier(table_bytes, H100_LIMIT) == tier


def test_gather_tier_is_monotone_in_the_limit():
    for limit in (0, 4, 4096, H100_LIMIT):
        tiers = [kernels.gather_tier(b, limit)
                 for b in range(4, limit + 64, max(limit // 64, 4))]
        assert tiers == sorted(tiers, key=("smem", "l2").index)


def test_output_like_an_aligned_index_is_plain_storage():
    idx = torch.zeros(1001, dtype=torch.int32)
    assert idx.data_ptr() % 16 == 0
    out = kernels.output_like(idx)
    assert out._base is None and out.is_contiguous()
    assert out.shape == idx.shape and out.dtype == torch.int32
    assert out.untyped_storage().nbytes() == 4 * 1001


@pytest.mark.parametrize("dtype,off", [(torch.int32, 1), (torch.int32, 2),
                                       (torch.int32, 3), (torch.int64, 1)])
@pytest.mark.parametrize("n", [1, 5, 1000])
def test_output_like_an_offset_view_shares_its_address_mod_16(dtype, off, n):
    """K2-K4's int32 indices at 4, 8 and 12 bytes off a 16-byte boundary,
    and K5's int64 lanes at 8."""
    buf = torch.zeros(n + off, dtype=dtype)
    idx = buf[off:]
    assert idx.data_ptr() % 16 == idx.element_size() * off
    out = kernels.output_like(idx)
    assert out.data_ptr() % 16 == idx.data_ptr() % 16
    assert out.shape == idx.shape and out.dtype == dtype
    assert out._base is not None and out.is_contiguous()


class _StandInFunction:
    """A C function of a stand-in library: records each setting of its
    argtypes and restype, and each call."""

    def __init__(self, symbol, log, value):
        object.__setattr__(self, "symbol", symbol)
        object.__setattr__(self, "log", log)
        object.__setattr__(self, "value", value)

    def __setattr__(self, key, value):
        self.log.append((self.symbol, key))
        object.__setattr__(self, key, value)

    def __call__(self, *args):
        self.log.append((self.symbol, "call"))
        return self.value


class _StandInLibrary:
    def __init__(self, log, value=H100_LIMIT):
        self._log, self._value = log, value

    def __getattr__(self, symbol):
        self._log.append((symbol, "resolve"))
        return _StandInFunction(symbol, self._log, self._value)


@pytest.mark.parametrize("module", ["gather", "hash_scan"])
def test_functions_resolve_each_symbol_once_per_library_load(
        monkeypatch, module):
    """The cached handle: over several launches' worth of lookups each
    symbol is resolved, and its argtypes and restype set, once; a new
    library load resolves again."""
    from pfbwtf_tpu_torch.ops.cuda import build
    from pfbwtf_tpu_torch.ops.cuda import hash_scan

    signatures = {"gather": kernels.SIGNATURES,
                  "hash_scan": hash_scan.SIGNATURES}[module]
    log = []
    libs = {module: _StandInLibrary(log)}
    monkeypatch.setattr(build, "load", lambda name: libs[name])
    monkeypatch.setattr(build, "_functions", {})
    first = build.functions(module, signatures)
    for _ in range(5):
        assert build.functions(module, signatures) is first
    assert sorted(first) == sorted(signatures)
    for symbol, (argtypes, restype) in signatures.items():
        assert log.count((symbol, "resolve")) == 1
        assert log.count((symbol, "argtypes")) == 1
        assert log.count((symbol, "restype")) == 1
        assert first[symbol].argtypes == argtypes
        assert first[symbol].restype == restype
    libs[module] = _StandInLibrary(log)
    second = build.functions(module, signatures)
    assert second is not first
    assert all(log.count((s, "resolve")) == 2 for s in signatures)


def test_smem_limit_is_read_once_per_card(monkeypatch):
    from pfbwtf_tpu_torch.ops.cuda import build

    log = []
    lib = _StandInLibrary(log)
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(build, "_functions", {})
    monkeypatch.setattr(kernels, "_smem_limits", {})
    for _ in range(4):
        assert kernels.smem_limit(0) == H100_LIMIT
        assert kernels.smem_limit(1) == H100_LIMIT
    calls = log.count(("pfbwt_gather_smem_limit", "call"))
    assert calls == 2


def test_smem_limit_raises_on_a_cuda_error(monkeypatch):
    from pfbwtf_tpu_torch.ops.cuda import build

    lib = _StandInLibrary([], value=-101)  # cudaErrorInvalidDevice
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(build, "_functions", {})
    monkeypatch.setattr(kernels, "_smem_limits", {})
    with pytest.raises(RuntimeError, match="CUDA error 101"):
        kernels.smem_limit(7)


@pytest.mark.parametrize("t", [1, 3])
def test_plain_equals_pallas_at_tiny_tables(probe, t):
    """The smallest tables, where every lane of [-2T, 2T) wraps, fills
    or clips, through the probe's K3 and K4 kernels in interpret mode."""
    rng = np.random.default_rng(t)
    table = rng.integers(0, 1 << 30, size=t, dtype=np.int32)
    idx = rng.integers(-2 * t, 2 * t, size=8 * 1024, dtype=np.int32)
    tt, it = torch.from_numpy(table), torch.from_numpy(idx)
    want = np.asarray(probe.pallas_tala(jnp.asarray(table), jnp.asarray(idx)))
    assert np.array_equal(gather.take_along(tt, it).numpy(), want)
    want = np.asarray(probe.pallas_rows(jnp.asarray(table), jnp.asarray(idx)))
    assert np.array_equal(gather.take_rows(tt, it).numpy(), want)
