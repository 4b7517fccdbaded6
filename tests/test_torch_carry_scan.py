"""The plain versions of kernel K5 (pfbwtf_tpu_torch/ops/carry.py), the
dispatch by device, and the checks the kernel's wrapper
(ops/cuda/carry_scan.py) makes before it touches a card.  The kernel
itself is held to the plain versions on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from pfbwtf_tpu_torch.ops import bwt_dev, carry, suffix
from pfbwtf_tpu_torch.ops.cuda import carry_scan as kernels

from .torch_inputs import repeat_dict

I64_MIN = -(1 << 63)
I64_MAX = (1 << 63) - 1


def _values(n: int, seed: int) -> np.ndarray:
    """Random int64 lanes with -1 in every seventh lane and the extremes
    and large negatives sprinkled in."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-(1 << 40), 1 << 40, size=n, dtype=np.int64)
    x[::7] = -1
    if n > 3:
        x[rng.integers(0, n, size=3)] = (I64_MIN, I64_MAX, -(1 << 62))
    return x


def _accumulate(x: np.ndarray, op: str, reverse: bool) -> np.ndarray:
    f = np.maximum if op == "max" else np.minimum
    if reverse:
        return f.accumulate(x[::-1])[::-1] if x.size else x.copy()
    return f.accumulate(x) if x.size else x.copy()


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4095, 4096, 4097, 5000])
@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize("reverse", [False, True])
def test_carry_plain_equals_running_extreme(n, op, reverse):
    x = _values(n, n * 4 + (op == "min") * 2 + reverse)
    entry = carry.carry_max if op == "max" else carry.carry_min
    got = entry(torch.from_numpy(x), reverse=reverse)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), _accumulate(x, op, reverse))
    t = torch.from_numpy(x)
    scan = torch.cummax if op == "max" else torch.cummin
    want = (scan(t.flip(0), 0).values.flip(0) if reverse
            else scan(t, 0).values)
    assert torch.equal(got, want)


def test_carry_plain_all_negative_and_constant():
    x = torch.full((100,), -1, dtype=torch.int64)
    assert torch.equal(carry.carry_max(x), x)
    assert torch.equal(carry.carry_min(x, reverse=True), x)
    x = torch.arange(-100, 0)
    assert torch.equal(carry.carry_max(x), x)
    assert torch.equal(carry.carry_min(x), torch.full_like(x, -100))
    assert torch.equal(carry.carry_min(x, reverse=True), x)
    assert torch.equal(carry.carry_max(x, reverse=True),
                       torch.full_like(x, -1))


def _groups(seed: int, n_groups: int):
    """Sorted keys of n_groups groups of 1 to 1000 equal keys (gaps of 1
    to 5 between groups) and a random permutation."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 1001, size=n_groups)
    vals = np.cumsum(rng.integers(1, 6, size=n_groups)) - (1 << 30)
    cks = np.repeat(vals, sizes).astype(np.int64)
    order = rng.permutation(cks.shape[0]).astype(np.int64)
    return torch.from_numpy(cks), torch.from_numpy(order)


def _posrank_before(cks, order, idx):
    """A dict doubling round's positional ranks as the port computed them
    before kernel K5: changed flags, a where, cummax and a scatter."""
    n = cks.shape[0]
    changed = torch.ones(n, dtype=torch.bool)
    changed[1:] = cks[1:] != cks[:-1]
    headpos = torch.cummax(torch.where(changed, idx, 0), 0).values
    out = torch.empty_like(headpos)
    out[order] = headpos
    return out, changed.sum().reshape(1)


@pytest.mark.parametrize("seed,n_groups", [(0, 1), (1, 2), (2, 17),
                                           (3, 200), (4, 1000)])
def test_posrank_plain_equals_the_round_before(seed, n_groups):
    cks, order = _groups(seed, n_groups)
    idx = torch.arange(cks.shape[0])
    rank, counts = carry.posrank(cks, order)
    want_rank, want_counts = _posrank_before(cks, order, idx)
    assert torch.equal(rank, want_rank)
    assert torch.equal(counts, want_counts)
    assert int(counts) == n_groups


@pytest.mark.parametrize("w", [4, 10])
def test_dict_doubling_rounds_are_posrank(monkeypatch, w):
    """Every round of the dict doubling, the first included, takes its
    ranks and group count from carry.posrank, and the sort is the one of
    the rounds as they were before kernel K5."""
    dfp = torch.from_numpy(repeat_dict(w=w))
    want = bwt_dev.dict_sort_part(dfp, w)
    calls = []

    def counted(cks, order):
        calls.append(1)
        return _posrank_before(cks, order, torch.arange(cks.shape[0]))

    monkeypatch.setattr(suffix, "posrank", counted)
    got = bwt_dev.dict_sort_part(dfp, w)
    assert len(calls) == suffix.rounds["dict_sa"] + 1 >= 3
    for g, x in zip(got, want):
        assert torch.equal(g, x)


def test_posrank_plain_empty():
    e = torch.empty(0, dtype=torch.int64)
    rank, counts = carry.posrank(e, e)
    assert rank.shape == (0,) and counts.tolist() == [0]


def test_cpu_tensors_launch_nothing():
    before = dict(kernels.launches)
    x = torch.arange(10)
    carry.carry_max(x)
    carry.carry_min(x, reverse=True)
    carry.posrank(x, x)
    assert kernels.launches == before


@pytest.mark.parametrize("bad,why", [
    (torch.zeros(10, dtype=torch.int32), "int64"),
    (torch.zeros((2, 5), dtype=torch.int64), "1-D"),
    (torch.zeros(20, dtype=torch.int64)[::2], "contiguous"),
    (torch.zeros(10, dtype=torch.int64), "device"),
])
def test_kernel_wrapper_checks_before_any_card(bad, why):
    with pytest.raises(ValueError, match=why):
        kernels.carry(bad, "max")
    with pytest.raises(ValueError, match=why):
        kernels.posrank(bad, bad)
    with pytest.raises(ValueError, match=why):
        kernels.posrank(torch.zeros(10, dtype=torch.int64), bad)


def test_kernel_wrapper_refuses_an_unknown_op():
    with pytest.raises(ValueError, match="op"):
        kernels.carry(torch.zeros(4, dtype=torch.int64), "sum")
