"""Test inputs for the cut scan: k-mers whose Wang hashes are multiples of
p.  Used by the tests and by chip_smoke.py; nothing on the build path
imports this module.

Without planted k-mers a large p leaves a comparison of two cut scans
all False, and so proves nothing about the divisibility test.
"""

_U64_LIMIT = 1 << 64


def wang_inverse(h: int) -> int:
    """The 64-bit key whose Wang mix (ops/hash.wang_hash) is ``h``; the
    mix is a bijection of the 64-bit words."""
    m = _U64_LIMIT - 1

    def unxorshift(x: int, k: int) -> int:
        y = x
        for _ in range(64 // k):
            y = x ^ (y >> k)
        return y

    h = h * pow(1 + (1 << 31), -1, _U64_LIMIT) & m
    h = unxorshift(h, 28)
    h = h * pow(21, -1, _U64_LIMIT) & m
    h = unxorshift(h, 14)
    h = h * pow(265, -1, _U64_LIMIT) & m
    h = unxorshift(h, 24)
    # ~k + (k << 21) = k * (2**21 - 1) - 1
    return (h + 1) * pow((1 << 21) - 1, -1, _U64_LIMIT) & m


def plant_cuts(codes, w: int, p: int) -> list:
    """Write into ``codes`` (a uint8 array of codes, in place), back to
    back from the end, up to three k-mers whose Wang hashes are multiples
    of p (0, p, 2p, ...) and fit 2w bits; returns their positions, each of
    which must cut."""
    kms = [wang_inverse(m * p) for m in range(64) if m * p < _U64_LIMIT]
    kms = [k for k in kms if k < 4 ** w][:3]
    pos = list(range(len(codes) - 1, w - 1, -w))[:len(kms)]
    for i, km in zip(pos, kms):
        for t in range(w):
            codes[i - t] = (km >> (2 * t)) & 3
    return pos
