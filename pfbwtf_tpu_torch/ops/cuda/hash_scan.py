"""ctypes wrapper of kernel K1, the cut scan (csrc/hash_scan.cu).

``cut_scan`` takes a uint8 code tensor on a CUDA card and launches K1 on
the current stream (no synchronisation) or raises.  Its plain version is
ops/hash.py::hash_scan, which ops/hash.py::cut_mask runs for a CPU
tensor.  ``launches`` counts the kernel launches, and each is counted as
``k1_launches`` in the open build (utils/timer).
``divisibility_constants`` is the host half of K1's ``% p == 0`` test and
needs no card.
"""

import ctypes

import torch

from ...constants import MAX_W
from ...utils.timer import count
from . import build

launches = 0

_U64_LIMIT = 1 << 64


def divisibility_constants(p: int) -> tuple[int, int, int]:
    """``(qinv, s, limit)`` with which K1 tests ``h % p == 0``.

    p = 2**s * q with q odd; qinv = q**-1 mod 2**64 and limit =
    (2**64 - 1) // p.  For every 64-bit h, h % p == 0 exactly when
    rotr64(h * qinv mod 2**64, s) <= limit (Hacker's Delight, 10-17):
    a multiple h = p*m gives h * qinv = 2**s * m, which rotates to
    m <= limit; a rotated value <= limit < 2**(64-s) has s low zero bits
    before the rotate, so it is 2**s * m and h = p*m."""
    if not 1 <= p < _U64_LIMIT:
        raise ValueError("p must be in [1, 2**64)")
    s = (p & -p).bit_length() - 1
    return pow(p >> s, -1, _U64_LIMIT), s, (_U64_LIMIT - 1) // p


SIGNATURES = {"pfbwt_cut_scan": ([
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_ulonglong, ctypes.c_int, ctypes.c_ulonglong, ctypes.c_void_p,
], ctypes.c_int)}


def cut_scan(codes: torch.Tensor, w: int, p: int) -> torch.Tensor:
    """Cut mask (torch.bool, same length as ``codes``): cut[i] iff i >= w
    and wang(kmer_i) % p == 0.  ``codes`` may start at any byte (an
    offset view)."""
    global launches
    if codes.device.type != "cuda":
        raise ValueError(f"cut_scan: unsupported device {codes.device}")
    if codes.dtype != torch.uint8 or codes.dim() != 1:
        raise ValueError("cut_scan: codes must be a 1-D uint8 tensor")
    if not codes.is_contiguous():
        raise ValueError("cut_scan: codes must be contiguous")
    if not 1 <= w <= MAX_W:
        raise ValueError(f"cut_scan: window size must be in [1, {MAX_W}]")
    if not 1 <= p < _U64_LIMIT:
        raise ValueError("cut_scan: p must be in [1, 2**64)")
    n = codes.shape[0]
    cut = torch.empty(n, dtype=torch.bool, device=codes.device)
    if n == 0:
        return cut
    qinv, s, limit = divisibility_constants(p)
    fn = build.functions("hash_scan", SIGNATURES)["pfbwt_cut_scan"]
    dev = codes.get_device()
    args = (codes.data_ptr(), cut.data_ptr(), n, w, qinv, s, limit,
            build.current_stream(dev))
    if dev == torch.cuda.current_device():
        rc = fn(*args)
    else:  # a device context only where another card is current
        with torch.cuda.device(dev):
            rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"cut_scan kernel launch failed: CUDA error {rc}")
    launches += 1
    count("k1_launches")
    return cut
