"""Wang hash over the rolling 2-bit k-mer window, and the cut scan.

The reference rolls one char at a time through a stateful hasher
(hash.hpp:23-43).  Here the k-mer ending at position i depends only on
codes [i-w+1, i], so every position is computed independently.  Bit
layout (hash.hpp:32): the newest code occupies bits [0:2), a code t steps
back bits [2t:2t+2); positions before w-1 pack fewer codes.

The plain functions below carry the reference's uint64 arithmetic in
int64 tensors (torch has no uint64 shifts or remainders on the CPU):
left shifts, adds and xors wrap identically; right shifts are masked to
be logical; ``mod_p`` reduces the unsigned value.  ``cut_mask`` is the
main path's entry: kernel K1 (csrc/hash_scan.cu) on a CUDA tensor, the
plain ``hash_scan`` on a CPU tensor.
"""

import torch

from ..constants import MAX_W
from .cuda.hash_scan import cut_scan

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)
_U64_LIMIT = 1 << 64


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of the uint64 held in int64 ``x``."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def wang_hash(key: torch.Tensor) -> torch.Tensor:
    """Wang 64-bit integer mix (hash.hpp:12-21), mod 2**64, on int64."""
    key = (~key) + (key << 21)
    key = key ^ _shr(key, 24)
    key = (key + (key << 3)) + (key << 8)
    key = key ^ _shr(key, 14)
    key = (key + (key << 2)) + (key << 4)
    key = key ^ _shr(key, 28)
    key = key + (key << 31)
    return key


def window_kmers(codes: torch.Tensor, w: int) -> torch.Tensor:
    """2-bit packed k-mer ending at each position, as int64."""
    n = codes.shape[0]
    c = codes.to(torch.int64)
    km = torch.zeros(n, dtype=torch.int64, device=codes.device)
    for t in range(min(w, n)):
        km[t:] |= c[: n - t] << (2 * t)
    return km


def mod_p(h: torch.Tensor, p: int) -> torch.Tensor:
    """Unsigned ``h mod p`` for the uint64 held in int64 ``h``, exact for
    every 1 <= p < 2**64.

    For p < 2**63 a negative h stands for h + 2**64 = low + 2**63 with
    low = h & (2**63 - 1); both residues are < p, and their sum is reduced
    without leaving the int64 range.  For p >= 2**63 the unsigned value u
    is below 2p, so u mod p is u when u < p and u - p otherwise; p rides
    in int64 as p - 2**64, and u < p is the signed comparison of both with
    the sign bit flipped."""
    if not 1 <= p < _U64_LIMIT:
        raise ValueError(f"mod_p needs 1 <= p < 2**64, got {p}")
    if p > _I64_MAX:
        below = (h ^ _I64_MIN) < p - (1 << 63)
        return torch.where(below, h, h - (p - _U64_LIMIT))
    r = (h & _I64_MAX) % p
    s = r - (p - (1 << 63) % p)
    return torch.where(h < 0, torch.where(s < 0, s + p, s), r)


def hash_scan(codes: torch.Tensor, w: int, p: int) -> torch.Tensor:
    """Plain version of kernel K1: the cut mask of a code array (values
    0..3).  cut[i] is true iff i >= w and wang(kmer_i) % p == 0 — the
    ``pos_ > w && hash % p == 0`` test of pfparser.hpp:347 for a stream
    without the leading Dollar."""
    if not 1 <= w <= MAX_W:
        raise ValueError(f"window size must be in [1, {MAX_W}], got {w}")
    cut = mod_p(wang_hash(window_kmers(codes, w)), p) == 0
    cut[:w] = False
    return cut


def cut_mask(codes: torch.Tensor, w: int, p: int) -> torch.Tensor:
    """The cut scan of the main path: the plain ``hash_scan`` on a CPU
    tensor, kernel K1 (ops/cuda/hash_scan.py) on any other, which
    launches or raises."""
    if codes.device.type == "cpu":
        return hash_scan(codes, w, p)
    return cut_scan(codes, w, p)
