"""The fused build's device tail, ops/bwt_dev.bwt_result_dev, against the
host tail ops/bwt.bwt_result on CPU tensors: the run count, the BWT, the
SA and the .ssa/.esa pairs byte for byte, and what the tail counts."""

import numpy as np
import pytest
import torch

from pfbwtf_tpu_torch.ops.bwt import bwt_result
from pfbwtf_tpu_torch.ops.bwt_dev import bwt_result_dev
from pfbwtf_tpu_torch.utils import timer

PAD = 5  # the device buffers are longer than the result, as J3's buckets


def _bwt(case: str, rng) -> np.ndarray:
    if case == "one symbol":
        return np.array([7], np.uint8)
    if case == "one run":
        return np.full(1000, 65, np.uint8)
    if case == "all different":
        return rng.permutation(256).astype(np.uint8)
    lens = rng.integers(1, 9, size=600)  # random runs, equal runs adjacent
    return np.repeat(rng.choice(np.frombuffer(b"\0ACGT", np.uint8),
                                size=lens.shape[0]), lens)


@pytest.mark.parametrize("sa_dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("want_sa,want_rssa", [(False, False), (True, False),
                                               (False, True), (True, True)])
@pytest.mark.parametrize("case", ["one symbol", "one run", "all different",
                                  "random runs"])
def test_device_tail_equals_host_tail(case, want_sa, want_rssa, sa_dtype):
    rng = np.random.default_rng(len(case))
    bwtc = _bwt(case, rng)
    total = bwtc.shape[0]
    n = total - 1
    sa = rng.permutation(total).astype(np.uint64)
    sa[0] = n
    want = bwt_result(bwtc.copy(), sa.copy(), want_sa, want_rssa, sa_dtype)

    bwt_d = torch.from_numpy(np.concatenate((bwtc, np.full(PAD, 3, np.uint8))))
    sa_d = torch.from_numpy(np.concatenate(
        (sa, np.full(PAD, 9, np.uint64))).view(np.int64))
    sa_d[0] = -1  # set to n by the tail where the SA is used
    info, got_info = {}, {}
    with timer.build(info):
        got = bwt_result_dev(bwt_d, sa_d, total, n, want_sa, want_rssa,
                             sa_dtype, info=got_info)

    assert got.nruns == want.nruns
    assert got.bwt.dtype == np.uint8 and got.bwt.tobytes() == bwtc.tobytes()
    for field in ("sa", "ssa", "esa"):
        g, w = getattr(got, field), getattr(want, field)
        if w is None:
            assert g is None, field
        else:
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), field
    if want_rssa:
        assert got.ssa.dtype == np.dtype(sa_dtype)
        assert got.ssa.shape == got.esa.shape == (2 * want.nruns,)

    # the run count's read and the one wait; the count's 8 bytes and every
    # byte brought back; no pinned block off the card
    out_bytes = total + want_sa * 8 * total + want_rssa * 2 * (
        2 * want.nruns * np.dtype(sa_dtype).itemsize)
    assert info["counts"] == {"sample_dev": 1, "syncs": 2,
                              "d2h_bytes": 8 + out_bytes}
    assert [s[0] for s in info["spans"]] == ["fetch.sample", "fetch.download"]
    assert set(got_info) == {"sample_s", "download_s"}
