"""Suffix sorting and dict suffix-equality groups on the host, in numpy
(the numpy reference path of pfbwtf_tpu/ops/suffix.py).

The host assembly and the staged -m assembly lay out the dict suffixes
on the host (ops/bwt.suffix_layout): the native SA-IS kernel with its LCP
where it builds (native.py), else the prefix doubling and the
polynomial-hash equality groups below.  The host parse-BWT
(ops/parse_bwt.bwt_of_parse) and simplebwt take the SA of an integer
sequence from ``suffix_array_ints_np`` where the native kernel is absent.
"""

import numpy as np

from ..constants import EndOfDict, EndOfWord

_U64 = np.uint64


def _doubling_np(rank: np.ndarray) -> np.ndarray:
    """Prefix doubling given initial integer keys; returns the suffix order."""
    n = rank.shape[0]
    rank = np.unique(rank, return_inverse=True)[1].astype(np.int64)
    k = 1
    idx = np.arange(n)
    while True:
        if rank[-1] == 0 and n == 1:
            return idx
        key2 = np.full(n, -1, dtype=np.int64)
        if k < n:
            key2[: n - k] = rank[k:]
        order = np.lexsort((key2, rank))
        r1 = rank[order]
        r2 = key2[order]
        changed = np.empty(n, dtype=np.int64)
        changed[0] = 0
        changed[1:] = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        new_rank = np.cumsum(changed)
        rank = np.empty(n, dtype=np.int64)
        rank[order] = new_rank
        if new_rank[-1] == n - 1:
            return order
        k *= 2


def suffix_array_ints_np(seq: np.ndarray) -> np.ndarray:
    """SA of an integer sequence whose last element is the unique minimum."""
    return _doubling_np(np.asarray(seq, dtype=np.int64))


def dict_initial_symbols_np(dict_flat: np.ndarray):
    """Initial doubling keys for the .dict byte array.

    EndOfDict -> 0; the i-th EndOfWord -> 1+i (separators ordered by word);
    real char c -> dwords+1+c.  Also returns per-position word ids and
    suffix lengths (distance to the owning separator).
    """
    dict_flat = np.asarray(dict_flat, dtype=np.uint8)
    D = dict_flat.shape[0]
    idt = np.int32 if D < 2**31 - 2 else np.int64
    is_eow = dict_flat == EndOfWord
    dwords = int(is_eow.sum())
    word_id = np.concatenate(
        (np.zeros(1, idt), np.cumsum(is_eow, dtype=idt)[:-1])
    )
    sym = dict_flat.astype(idt) + idt(dwords + 1)
    sym[is_eow] = idt(1) + word_id[is_eow]
    sym[dict_flat == EndOfDict] = 0
    sep_pos = np.flatnonzero(is_eow | (dict_flat == EndOfDict)).astype(idt)
    pos = np.arange(D, dtype=idt)
    next_sep = sep_pos[np.searchsorted(sep_pos, pos)]
    suf_len = next_sep - pos
    return sym, word_id, suf_len, dwords


def dict_suffix_sort_np(dict_flat: np.ndarray):
    """Generalized suffix order of the dict.

    Returns (sa, word_id, suf_len, dwords): sa over ALL positions.
    """
    sym, word_id, suf_len, dwords = dict_initial_symbols_np(dict_flat)
    sa = _doubling_np(sym)
    return sa, word_id, suf_len, dwords


_HB1 = _U64(0x9E3779B97F4A7C15)  # odd -> invertible mod 2**64
_HB2 = _U64(0xC2B2AE3D27D4EB4F)


def _segmented_suffix_hashes_np(dict_flat: np.ndarray, suf_len: np.ndarray, base):
    """H[i] = polynomial hash of dict_flat[i : i+suf_len[i]] mod 2**64.

    Uses H[i] = (G[i] - G[i+len]) * base^{-i} with G[i] = sum_{j>=i} c_j B^j,
    which vectorizes as two cumulative passes.
    """
    c = dict_flat.astype(_U64)
    D = c.shape[0]
    # powers[i] = base**i mod 2**64, via cumulative product
    b = np.full(D, base, dtype=_U64)
    b[0] = _U64(1)
    powers = np.multiply.accumulate(b)
    terms = c * powers
    G = np.zeros(D + 1, dtype=_U64)
    G[:D] = terms[::-1].cumsum(dtype=_U64)[::-1]
    inv = _U64(pow(int(base), -1, 1 << 64))
    binv = np.full(D, inv, dtype=_U64)
    binv[0] = _U64(1)
    inv_powers = np.multiply.accumulate(binv)
    idx = np.arange(D)
    return (G[idx] - G[idx + suf_len]) * inv_powers


def suffix_group_ids_np(dict_flat, sa_kept, suf_len, verify: bool = True):
    """Group ids (0-based, ascending in sorted order) for equal suffix strings.

    ``sa_kept``: suffix start positions in lexicographic order (already
    filtered to len > w).  Adjacent suffixes are merged into one group iff
    their lengths and two independent 64-bit polynomial hashes agree; with
    ``verify`` the byte equality of each multi-member group is checked
    exactly, making the result fully deterministic rather than
    hash-probabilistic.
    """
    h1 = _segmented_suffix_hashes_np(dict_flat, suf_len, _HB1)
    h2 = _segmented_suffix_hashes_np(dict_flat, suf_len, _HB2)
    ls = suf_len[sa_kept]
    e = (
        (ls[1:] == ls[:-1])
        & (h1[sa_kept][1:] == h1[sa_kept][:-1])
        & (h2[sa_kept][1:] == h2[sa_kept][:-1])
    )
    gid = np.concatenate(([0], np.cumsum(~e))).astype(np.int64)
    if verify and e.any():
        # vectorized byte verification of every claimed-equal adjacent pair,
        # longest first: at offset d only the pairs longer than d, a
        # prefix, are compared, so the work is the pairs' total length
        flat = np.asarray(dict_flat)
        pairs = np.flatnonzero(e)
        L = ls[pairs].astype(np.int64)
        order = np.argsort(-L, kind="stable")
        a = sa_kept[pairs][order].astype(np.int64)
        b = sa_kept[pairs + 1][order].astype(np.int64)
        live = np.searchsorted(-L[order], -np.arange(L.max()), side="left")
        for d, k in enumerate(live):
            if not np.array_equal(flat[a[:k] + d], flat[b[:k] + d]):
                raise AssertionError("suffix hash collision — please report")
    return gid
