"""ctypes loader of the host C++ kernel ``native/sais.cpp``: the host
dedup's byte-lex substring ranks (``rank_substrings``); for the host
parse-BWT the SA of an integer sequence (``sais_int``, the sacak_int
role); and, for the dict-scale layout of the host and staged -m
assemblies, the generalized dict suffix array with its LCP
(``sais_int_lcp32`` / ``sais_int_lcp``, the gsacak(SA, LCP) role).

The library is built with g++ at first use into
``build/pfbwtf_tpu_torch/libsais-<hash>.so`` at the repository root (the
hash covers the source and the flags), never beside the source.  A
missing compiler or a failed build makes ``available()`` false, and the
host dedup (ops/parse._dedup_and_rank), the parse SA
(ops/parse_bwt._parse_sa_host) and the dict suffix layout
(ops/bwt.suffix_layout) take their numpy paths.
"""

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

from .ops.cuda.build import BUILD_DIR
from .utils.errors import PfbwtError

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "native", "sais.cpp")
_FLAGS = ["-std=c++14", "-O3", "-fPIC", "-shared"]

_lib: Optional[ctypes.CDLL] = None


def _build() -> str:
    try:
        with open(_SRC, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode())
    except OSError as e:
        raise PfbwtError(f"native source missing: {e}")
    out = os.path.join(BUILD_DIR, f"libsais-{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], check=True,
                       capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        raise PfbwtError(f"native sais build failed: {e}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_build())
        lib.rank_substrings.restype = ctypes.c_int
        lib.rank_substrings.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.sais_int.restype = ctypes.c_int
        lib.sais_int.argtypes = [ctypes.POINTER(ctypes.c_int64)] * 2 + [
            ctypes.c_int64] * 2
        for name, ct in (("sais_int_lcp", ctypes.c_int64),
                         ("sais_int_lcp32", ctypes.c_int32)):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.POINTER(ct)] * 3 + [ct, ct]
        _lib = lib
    return _lib


def available() -> bool:
    try:
        load()
        return True
    except PfbwtError:
        return False


def rank_substrings_native(T: np.ndarray, starts: np.ndarray,
                           lens: np.ndarray):
    """1-based byte-lex dense ranks of the substrings T[s:s+l] (equal
    substrings share a rank); returns (ranks, ndistinct)."""
    lib = load()
    T = np.ascontiguousarray(np.asarray(T, dtype=np.uint8))
    starts = np.ascontiguousarray(np.asarray(starts, dtype=np.int64))
    lens = np.ascontiguousarray(np.asarray(lens, dtype=np.int64))
    m = starts.shape[0]
    ranks = np.empty(m, dtype=np.int64)
    nd = ctypes.c_int64(0)
    rc = lib.rank_substrings(
        T.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        T.shape[0],
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        m,
        ranks.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.byref(nd),
    )
    if rc != 0:
        raise PfbwtError(f"rank_substrings failed with code {rc}")
    return ranks, int(nd.value)


def suffix_array_ints_native(seq: np.ndarray) -> np.ndarray:
    """SA of an int sequence with a unique 0 terminator (sacak_int role)."""
    lib = load()
    s = np.ascontiguousarray(np.asarray(seq, dtype=np.int64))
    n = s.shape[0]
    sa = np.empty(n, dtype=np.int64)
    K = int(s.max()) + 1 if n else 1
    rc = lib.sais_int(s.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                      sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                      n, K)
    if rc != 0:
        raise PfbwtError(f"sais_int failed with code {rc}")
    return sa


def dict_suffix_sort_native(dict_flat: np.ndarray):
    """Generalized dict suffix order (gsacak role), without the LCP, over
    the symbol remapping of ops/suffix_np.dict_initial_symbols_np.
    Returns (sa, word_id, suf_len, dwords)."""
    from .ops.suffix_np import dict_initial_symbols_np

    sym, word_id, suf_len, dwords = dict_initial_symbols_np(dict_flat)
    sa = suffix_array_ints_native(sym.astype(np.int64))
    return sa, word_id, suf_len, dwords


def dict_suffix_sort_lcp_native(dict_flat: np.ndarray):
    """Generalized dict SA + LCP (the gsacak(SA, LCP) role).  With distinct
    separator symbols the LCP counts only real matched chars, so suffix
    equality groups are exactly (len equal) & (lcp >= len).  Uses the
    32-bit kernel instantiation whenever sizes fit.  Returns (sa, lcp,
    word_id, suf_len, dwords)."""
    from .ops.suffix_np import dict_initial_symbols_np

    lib = load()
    sym, word_id, suf_len, dwords = dict_initial_symbols_np(dict_flat)
    n = sym.shape[0]
    K = int(sym.max()) + 1 if n else 1
    if n < 2**31 - 2 and K < 2**31 - 2:
        fn, dt, ct = lib.sais_int_lcp32, np.int32, ctypes.c_int32
    else:
        fn, dt, ct = lib.sais_int_lcp, np.int64, ctypes.c_int64
    s = np.ascontiguousarray(sym.astype(dt))
    sa = np.empty(n, dtype=dt)
    lcp = np.empty(n, dtype=dt)
    rc = fn(*(a.ctypes.data_as(ctypes.POINTER(ct)) for a in (s, sa, lcp)),
            n, K)
    if rc != 0:
        raise PfbwtError(f"sais_int_lcp failed with code {rc}")
    return sa, lcp, word_id, suf_len, dwords
