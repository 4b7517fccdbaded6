"""Kernel K1 and the fused build on a CUDA card, against the plain
PyTorch version and the CPU run.  Marked ``cuda``: each test skips when
no card is present.  On the card: ``python -m pytest -m cuda tests/``."""

import io

import numpy as np
import pytest
import torch

from pfbwtf_tpu_torch.ops.cuda import hash_scan as k1
from pfbwtf_tpu_torch.ops.fused import pfbwt_fused_records
from pfbwtf_tpu_torch.ops.fused_stream import pfbwt_fused_stream
from pfbwtf_tpu_torch.ops.hash import hash_scan
from pfbwtf_tpu_torch.ops.parse import ParserParams, build_stream
from pfbwtf_tpu_torch.testing import plant_cuts

pytestmark = pytest.mark.cuda

ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


BIG_P = (1, 2, 64, 1 << 32, 1 << 63, (1 << 63) + 29, (1 << 64) - 1)


@pytest.mark.parametrize("w,p", [(10, 100), (1, 3), (16, 511), (17, 97),
                                 (32, 97), (10, (1 << 15) + 3),
                                 (4, (1 << 20) - 1), (12, (1 << 31) + 11)]
                         + [(w, p) for w in (31, 32) for p in BIG_P])
def test_k1_equals_plain_on_card(card, w, p):
    """Ragged, short and aligned lengths, each also as a view that starts
    off a 16-byte boundary; planted k-mers must cut."""
    rng = np.random.default_rng(w * 1000 + p % 1000)
    for n in (1, 15, 16, 17, max(w - 1, 1), 2047, 2049, 300_007):
        for off in (0, 1, 15):
            buf = rng.integers(0, 4, size=n + off, dtype=np.uint8)
            pos = plant_cuts(buf[off:], w, p)
            codes = torch.from_numpy(buf).to(card)[off:]
            assert codes.data_ptr() % 16 == off
            before = k1.launches
            got = k1.cut_scan(codes, w, p)
            torch.cuda.synchronize()
            assert k1.launches == before + 1
            want = hash_scan(codes, w, p)
            assert torch.equal(got, want), (n, off)
            assert bool(want[pos].all()), (n, off)


def test_k1_rejects_bad_input(card):
    with pytest.raises(ValueError):
        k1.cut_scan(torch.zeros(10, dtype=torch.int32, device=card), 4, 10)
    with pytest.raises(ValueError):
        k1.cut_scan(torch.zeros(10, dtype=torch.uint8, device=card), 33, 10)
    with pytest.raises(ValueError):
        k1.cut_scan(torch.zeros(20, dtype=torch.uint8, device=card)[::2], 4, 10)


def test_fused_card_equals_cpu(card):
    rng = np.random.default_rng(5)
    records = [("s", rng.choice(ACGT, size=40000))]
    kw = dict(want_sa=True, want_rssa=True)
    got, _ = pfbwt_fused_records(records, ParserParams(), device="cuda", **kw)
    want, _ = pfbwt_fused_records(records, ParserParams(), device="cpu", **kw)
    for field in ("bwt", "sa", "ssa", "esa"):
        assert np.array_equal(getattr(got, field), getattr(want, field))


def test_fused_stream_card_equals_cpu(card):
    """The streamed build with the streamed J2 and many emission chunks:
    the same files on the card as on the CPU, and K1 launched."""
    rng = np.random.default_rng(6)
    C, _, _ = build_stream([("s", rng.choice(ACGT, size=40000))],
                           ParserParams())
    outs = []
    for device in ("cuda", "cpu"):
        bwt_fp, sa_fp, info = io.BytesIO(), io.BytesIO(), {}
        before = k1.launches
        out = pfbwt_fused_stream(C, 10, 100, bwt_fp=bwt_fp, sa_fp=sa_fp,
                                 want_rssa=True, chunk_target=1 << 12,
                                 j2_stream=True, j2_chunk=1 << 14,
                                 device=device, info=info)
        assert info["n_chunks"] >= 8
        if device == "cuda":
            assert k1.launches > before
        outs.append((bwt_fp.getvalue(), sa_fp.getvalue(), out))
    (gb, gs, go), (cb, cs, co) = outs
    assert gb == cb and gs == cs and go[:3] == co[:3]
    assert np.array_equal(go[3], co[3]) and np.array_equal(go[4], co[4])
