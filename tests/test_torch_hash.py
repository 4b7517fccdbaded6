"""The port's cut scan (pfbwtf_tpu_torch/ops/hash.py, the plain version of
kernel K1) against the JAX package's numpy, XLA and Pallas (interpret)
cut scans.  Every comparison is exact."""

import numpy as np
import pytest
import torch

from pfbwtf_tpu.ops import hash as jhash
from pfbwtf_tpu.ops.pallas.hash_scan import hash_scan_pallas
from pfbwtf_tpu.utils.tables import NTOA_TABLE
from pfbwtf_tpu_torch.ops import hash as thash
from pfbwtf_tpu_torch.ops.cuda import hash_scan as k1
from pfbwtf_tpu_torch.testing import plant_cuts, wang_inverse
from pfbwtf_tpu_torch.utils.tables import ntoa_codes

ACGT = np.frombuffer(b"ACGT", np.uint8)
GRID = ((10, 100), (1, 3), (16, 511), (17, 97), (32, 97))
WIDE_P = ((1 << 15) + 3, (1 << 20) - 1, (1 << 31) + 11)
HUGE_P = (1 << 63, (1 << 63) + 29, (1 << 64) - 1)
U64 = (1 << 64) - 1


def _t(a_u64):
    return torch.from_numpy(np.ascontiguousarray(a_u64).view(np.int64))


def _u64(t):
    return t.numpy().view(np.uint64)


def test_wang_hash_known_values():
    def wang_py(key):
        M = (1 << 64) - 1
        key = ((~key & M) + ((key << 21) & M)) & M
        key ^= key >> 24
        key = (key + ((key << 3) & M) + ((key << 8) & M)) & M
        key ^= key >> 14
        key = (key + ((key << 2) & M) + ((key << 4) & M)) & M
        key ^= key >> 28
        key = (key + ((key << 31) & M)) & M
        return key

    keys = np.array([0, 1, 2, 0xDEADBEEF, (1 << 64) - 1, 0x123456789ABCDEF0,
                     1 << 63], dtype=np.uint64)
    expect = np.array([wang_py(int(k)) for k in keys], dtype=np.uint64)
    assert np.array_equal(_u64(thash.wang_hash(_t(keys))), expect)
    rng = np.random.default_rng(5)
    many = rng.integers(0, 2**63, size=4000, dtype=np.uint64) * np.uint64(2) \
        + rng.integers(0, 2, size=4000, dtype=np.uint64)
    assert np.array_equal(
        _u64(thash.wang_hash(_t(many))), jhash.wang_hash_np(many)
    )


@pytest.mark.parametrize("w", [1, 10, 16, 17, 32])
def test_window_kmers_match_np(w):
    rng = np.random.default_rng(w)
    codes = rng.integers(0, 4, size=777, dtype=np.uint8)
    got = thash.window_kmers(torch.from_numpy(codes), w)
    assert np.array_equal(_u64(got), jhash.window_kmers_np(codes, w))


@pytest.mark.parametrize("p", [1, 3, 100, (1 << 15) + 3, (1 << 20) - 1,
                               (1 << 31) + 11, (1 << 62) + 7, (1 << 63) - 1,
                               *HUGE_P])
def test_mod_p_unsigned(p):
    rng = np.random.default_rng(p % 1000)
    h = rng.integers(0, 2**63, size=5000, dtype=np.uint64) * np.uint64(2) \
        + rng.integers(0, 2, size=5000, dtype=np.uint64)
    h[:6] = [0, (1 << 64) - 1, 1 << 63, (1 << 63) - 1, p, p - 1]
    got = _u64(thash.mod_p(_t(h), p))
    assert np.array_equal(got, h % np.uint64(p))


def test_mod_p_rejects_out_of_range():
    with pytest.raises(ValueError):
        thash.mod_p(torch.zeros(3, dtype=torch.int64), 0)
    with pytest.raises(ValueError):
        thash.mod_p(torch.zeros(3, dtype=torch.int64), 1 << 64)


@pytest.mark.parametrize("n", [3 * 4096 + 123, 2 * 4096])
@pytest.mark.parametrize("w,p", GRID)
def test_hash_scan_matches_np_jax_pallas(n, w, p):
    """Ragged and whole-block lengths over the Pallas kernel's test grid."""
    rng = np.random.default_rng(1000 * w + p)
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    chars = ACGT[codes]
    got = thash.hash_scan(torch.from_numpy(codes), w, p).numpy()
    _, _, want_np = jhash.hash_scan_np(chars, w, p)
    _, want_jax = jhash.hash_scan_jax(codes, w, p)
    want_pallas = hash_scan_pallas(codes, w, p, blk=4096, interpret=True)
    assert got.dtype == np.bool_
    assert np.array_equal(got, want_np)
    assert np.array_equal(got, np.asarray(want_jax))
    assert np.array_equal(got, want_pallas)


@pytest.mark.parametrize("p", WIDE_P)
def test_hash_scan_wide_p_matches_np_jax(p):
    """p >= 2**15 (past the Pallas kernel's limit): the XLA path's answer,
    h % uint64(p).  Low-entropy codes give repeated k-mers, so some hashes
    divide even the large moduli."""
    rng = np.random.default_rng(p % 997)
    codes = rng.integers(0, 4, size=20011, dtype=np.uint8)
    for w in (3, 10, 32):
        chars = ACGT[codes]
        got = thash.hash_scan(torch.from_numpy(codes), w, p).numpy()
        _, _, want_np = jhash.hash_scan_np(chars, w, p)
        _, want_jax = jhash.hash_scan_jax(codes, w, p)
        assert np.array_equal(got, want_np)
        assert np.array_equal(got, np.asarray(want_jax))
    # a k-mer chosen so its hash divides p exactly: the cut must show up
    km = np.arange(1 << 20, dtype=np.uint64)
    hits = km[jhash.wang_hash_np(km) % np.uint64(p) == 0]
    if hits.size:
        w = 10
        k = int(hits[0])
        tail = np.array([(k >> (2 * t)) & 3 for t in range(w - 1, -1, -1)],
                        dtype=np.uint8)
        codes2 = np.concatenate((codes[:50], tail))
        got = thash.hash_scan(torch.from_numpy(codes2), w, p).numpy()
        assert got[-1]
        _, _, want_np = jhash.hash_scan_np(ACGT[codes2], w, p)
        assert np.array_equal(got, want_np)


@pytest.mark.parametrize("p", HUGE_P)
def test_hash_scan_huge_p_matches_np_jax(p):
    """p >= 2**63: u mod p is u or u - p.  Random codes never hit, so
    k-mers whose hashes are exactly 0 and p are planted (at w = 32 every
    64-bit key is a k-mer); each must cut, and nothing else."""
    rng = np.random.default_rng(p % 991)
    codes = rng.integers(0, 4, size=5003, dtype=np.uint8)
    pos = plant_cuts(codes, 32, p)
    kms = [sum(int(codes[i - t]) << (2 * t) for t in range(32)) for i in pos]
    h = jhash.wang_hash_np(np.array(kms, dtype=np.uint64))
    assert sorted(int(x) for x in h) == [0, p]
    for w in (10, 31, 32):
        got = thash.hash_scan(torch.from_numpy(codes), w, p).numpy()
        _, _, want_np = jhash.hash_scan_np(ACGT[codes], w, p)
        _, want_jax = jhash.hash_scan_jax(codes, w, p)
        assert np.array_equal(got, want_np)
        assert np.array_equal(got, np.asarray(want_jax))
        if w == 32:
            assert np.flatnonzero(got).tolist() == sorted(pos)


def test_wang_inverse_roundtrip():
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 2**63, size=300, dtype=np.uint64) * np.uint64(2)
    keys[:4] = [0, U64, 1 << 63, 12345]
    hashed = jhash.wang_hash_np(keys)
    assert [wang_inverse(int(x)) for x in hashed] == \
        [int(k) for k in keys]


def _rotr64(y: int, s: int) -> int:
    return ((y >> s) | (y << (64 - s))) & U64


@pytest.mark.parametrize("p", [1, 2, 3, 64, 100, 97, (1 << 15) + 3,
                               1 << 32, (1 << 32) + 15, 3 << 40, *HUGE_P])
def test_divisibility_constants_match_remainder(p):
    """K1's host constants: rotr64(h * qinv, s) <= limit iff h % p == 0,
    over random 64-bit h, multiples of p and the edges."""
    qinv, s, limit = k1.divisibility_constants(p)
    assert (p >> s) & 1 == 1 and (p >> s) * qinv & U64 == 1
    rng = np.random.default_rng(p % 1009)
    hs = [int(x) for x in rng.integers(0, 2**63, size=2000, dtype=np.uint64)]
    hs = [h * 2 + (h & 1) for h in hs]
    hs += [(h // p) * p for h in hs[:500]]
    hs += [0, 1, p - 1, p, p + 1, 2 * p, U64, U64 - U64 % p, U64 // 2]
    for h in hs:
        h &= U64
        assert (_rotr64(h * qinv & U64, s) <= limit) == (h % p == 0), h
    with pytest.raises(ValueError):
        k1.divisibility_constants(0)
    with pytest.raises(ValueError):
        k1.divisibility_constants(1 << 64)


_M32 = (1 << 32) - 1


def _fshl(lo, hi, s):  # __funnelshift_l, s in [0, 32)
    return ((hi << s) | (lo >> (32 - s))) & _M32


def _fshr(lo, hi, s):  # __funnelshift_r, s in [0, 32)
    return ((lo >> s) | (hi << (32 - s))) & _M32


def _kernel_windows(codes: np.ndarray, w: int, off: int) -> torch.Tensor:
    """Plain model of K1's index and shift layout (csrc/hash_scan.cu).
    The input lies ``off`` bytes past a 16-byte boundary; bytes outside it
    read as 0.  Each 16-byte chunk packs into a 32-bit word through x *
    0x40100401 and three byte permutations (first code highest).  Thread g
    owns positions [32g, 32g + 32): it takes chunks 2g-2 .. 2g+2, realigns
    them by a funnel shift of 2*off bits, and reads the k-mer of position
    32g + k as two funnel shifts by 2*(15 - k % 16) and a mask.  Returns
    the k-mers as int64 (uint64 bits)."""
    n = codes.shape[0]
    T = -(-n // 32)
    buf = torch.zeros(32 + 32 * T + 64, dtype=torch.int64)  # chunk -2 first
    buf[32 + off: 32 + off + n] = torch.from_numpy(codes.astype(np.int64))
    ch = buf.view(-1, 16)
    top = []
    for j in range(4):  # bytes 4j..4j+3 little-endian, times the gather
        x = sum(ch[:, 4 * j + b] << (8 * b) for b in range(4))
        top.append(((x * 0x40100401) & _M32) >> 24)
    P = (top[0] << 24) | (top[1] << 16) | (top[2] << 8) | top[3]
    g = torch.arange(T)
    Wd = [_fshl(P[2 * g + j + 1], P[2 * g + j], 2 * off) for j in range(4)]
    mask = (1 << (2 * w)) - 1
    mlo, mhi = mask & _M32, mask >> 32
    km = torch.empty(T, 32, dtype=torch.int64)
    for k in range(32):
        a, b, c = Wd[k // 16: k // 16 + 3]
        r = 2 * (15 - k % 16)
        klo = _fshr(c, b, r) & mlo
        khi = _fshr(b, a, r) & mhi
        km[:, k] = (khi << 32) | klo
    return km.reshape(-1)[:n]


@pytest.mark.parametrize("off", [0, 1, 7, 15])
@pytest.mark.parametrize("w", [1, 10, 16, 17, 31, 32])
def test_kernel_window_layout_matches_window_kmers(w, off):
    rng = np.random.default_rng(31 * w + off)
    for n in (1, 15, 16, 17, w - 1, 1000, 1027):
        if n < 1:
            continue
        codes = rng.integers(0, 4, size=n, dtype=np.uint8)
        want = thash.window_kmers(torch.from_numpy(codes), w)
        assert torch.equal(_kernel_windows(codes, w, off), want), n


def test_kernel_flag_layout():
    """K1 gathers the flags of 16 positions as the bits of one word (bit
    k: position k) and spreads each nibble to 4 bytes by x * 0x00204081 &
    0x01010101: every pattern of 16 flags must come out as its bytes."""
    acc = torch.arange(1 << 16, dtype=torch.int64)
    got = torch.stack(
        [(((((acc >> (4 * j)) & 0xF) * 0x00204081) & 0x01010101) >> (8 * b))
         & 0xFF for j in range(4) for b in range(4)], 1)
    assert torch.equal(got, (acc[:, None] >> torch.arange(16)) & 1)


def test_cut_mask_cpu_dispatch_is_plain_version():
    """On a CPU tensor the main path's cut scan is the plain version and
    launches nothing."""
    rng = np.random.default_rng(3)
    codes = torch.from_numpy(rng.integers(0, 4, size=5000, dtype=np.uint8))
    before = k1.launches
    got = thash.cut_mask(codes, 10, 100)
    assert torch.equal(got, thash.hash_scan(codes, 10, 100))
    assert k1.launches == before


def test_kernel_wrapper_refuses_cpu_tensor():
    """K1's wrapper launches on a card or raises; it has no CPU path."""
    codes = torch.zeros(100, dtype=torch.uint8)
    before = k1.launches
    with pytest.raises(ValueError, match="unsupported device"):
        k1.cut_scan(codes, 10, 100)
    assert k1.launches == before


def test_ntoa_codes_match_table():
    valid = np.array([c for c in range(256) if NTOA_TABLE[c] <= 3],
                     dtype=np.uint8)
    got = ntoa_codes(torch.from_numpy(valid)).numpy()
    assert np.array_equal(got, NTOA_TABLE[valid])
