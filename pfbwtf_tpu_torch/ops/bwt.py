"""The final BWT result as the host receives it, the run-length sampling
that completes it on the host, the host's dict-scale suffix layout
(shared by the staged -m assembly, ops/bwt_mmap.assemble_bwt_stream), and
the whole final-BWT assembly on the host (pfbwtf_tpu/ops/bwt.py), which
engine.assemble_bwt runs with the ``numpy`` backend.

The assembly is one flat sort: every output position is a pair (dict
suffix s longer than w, parse-BWT position j of the word owning s), n+1
pairs in all, emitted in (suffix group, j) order (pfbwt.hpp:97-194).  Per
emission (pfbwt.hpp:116-181, pfbwt-f.cpp:298-320):

  offset 0             -> char = bwlast[j]
  dict position == 1   -> char = 0 (the leading Dollar stands for the EOS)
  else                 -> char = dict[pos-1]
  sa = bwsai[j] - suf_len   (output index 0 is written as n)
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class BWTResult:
    bwt: np.ndarray  # uint8, n+1
    sa: Optional[np.ndarray]  # uint64, n+1 (first entry already = n)
    nruns: int
    ssa: Optional[np.ndarray] = None  # (pos, sample) pairs flattened
    esa: Optional[np.ndarray] = None


def bwt_result(bwtc: np.ndarray, sa: Optional[np.ndarray], want_sa: bool,
               want_rssa: bool, sa_dtype) -> BWTResult:
    """The host tail of a device assembly: the run count of ``bwtc`` and,
    from ``sa`` (uint64, first entry already n), the full SA and/or the
    (position, sample) pairs at run starts (.ssa) and run ends (.esa)."""
    total = bwtc.shape[0]
    run_start = np.empty(total, dtype=bool)
    run_start[0] = True
    np.not_equal(bwtc[1:], bwtc[:-1], out=run_start[1:])
    nruns = int(np.count_nonzero(run_start))
    ssa = esa = None
    if want_rssa:
        rs = np.flatnonzero(run_start)
        re = np.concatenate((rs[1:] - 1, [total - 1]))
        ssa = np.empty(2 * rs.shape[0], dtype=sa_dtype)
        ssa[0::2] = rs.astype(sa_dtype)
        ssa[1::2] = sa[rs].astype(sa_dtype)
        esa = np.empty(2 * re.shape[0], dtype=sa_dtype)
        esa[0::2] = re.astype(sa_dtype)
        esa[1::2] = sa[re].astype(sa_dtype)
    return BWTResult(bwt=bwtc, sa=sa if want_sa else None, nruns=nruns,
                     ssa=ssa, esa=esa)


def suffix_layout(dict_flat, w, occs, small_hint=True, workspace=None,
                  sa_all=None, word_id=None, suf_len=None):
    """Dict-scale emission layout of the staged -m assembly, on the host
    (pfbwtf_tpu/ops/bwt.py::suffix_layout): kept suffixes (longer than
    w) in lexicographic order, their equality groups, owning words and
    lengths, and each word's ilist segment start.

    The generalized dict suffix array comes from the native SA-IS kernel
    with its LCP where the library builds (equal suffixes are then
    adjacent full-SA entries of equal length whose LCP covers it), else
    from numpy prefix doubling with hash-and-verify groups and no LCP.
    ``workspace(sa_all, lcp_or_none)`` is called with the full gSA right
    after the sort: the hook that spills the reference's .gsa/.glcp files
    (pfbwt.hpp:208-209).  A caller that sorted the dict itself (the
    mesh's distributed doubling) passes its ``sa_all`` with the
    ``word_id`` and ``suf_len`` of suffix_np.dict_initial_symbols_np; the
    groups are then suffix_group_ids_np's hash-and-verify ones.

    Returns (sa_kept, gid, u, suf_len_kept, seg_start, idt)."""
    from .. import native
    from .suffix_np import dict_suffix_sort_np, suffix_group_ids_np

    dict_flat = np.asarray(dict_flat, dtype=np.uint8)
    small = dict_flat.shape[0] < 2**31 - 8 and small_hint
    idt = np.int32 if small else np.int64
    if sa_all is None and native.available():
        sa_all, lcp, word_id, suf_len, _ = (
            native.dict_suffix_sort_lcp_native(dict_flat))
        if workspace is not None:
            workspace(sa_all, lcp)
        sa_all, lcp, word_id, suf_len = (
            a.astype(idt) for a in (sa_all, lcp, word_id, suf_len))
        kidx = np.flatnonzero(suf_len[sa_all] > w).astype(idt)
        sa_kept = sa_all[kidx]
        ls = suf_len[sa_kept]
        eq = ((kidx[1:] == kidx[:-1] + 1) & (ls[1:] == ls[:-1])
              & (lcp[kidx[1:]] >= ls[:-1]))
        gid = np.concatenate((np.zeros(1, idt), np.cumsum(~eq, dtype=idt)))
    else:
        if sa_all is None:
            sa_all, word_id, suf_len, _ = dict_suffix_sort_np(dict_flat)
        sa_all, word_id, suf_len = (
            np.asarray(a).astype(idt) for a in (sa_all, word_id, suf_len))
        if workspace is not None:
            workspace(sa_all, None)
        sa_kept = sa_all[suf_len[sa_all] > w]
        gid = suffix_group_ids_np(dict_flat, sa_kept, suf_len).astype(idt)
    u = word_id[sa_kept]
    # ilist segment starts per word: F[u+1] = 1 + cumsum(occ)[:u]
    occs = np.asarray(occs).astype(idt)
    seg_start = np.concatenate(
        (np.ones(1, idt), (1 + np.cumsum(occs, dtype=np.int64)[:-1]).astype(idt))
    )
    return sa_kept, gid, u, suf_len[sa_kept], seg_start, idt


def _emissions(dict_flat, w, occs, ilist, sa_all=None, word_id=None,
               suf_len=None):
    """Sorted dict suffixes and their emission layout (``sa_all``,
    ``word_id``, ``suf_len``: a dict sort done by the caller, as in
    suffix_layout).

    Returns (sa_kept, gid, word_of_suffix, suf_len_kept, E_suffix, E_j).

    Index arrays are int32 when sizes allow (numpy's 64-bit fancy
    indexing is far slower than its 32-bit one), as in pfbwtf_tpu."""
    ilist = np.asarray(ilist)
    sa_kept, gid, u, suf_len_kept, seg_start, idt = suffix_layout(
        dict_flat, w, occs, small_hint=ilist.shape[0] < 2**31 - 8,
        sa_all=sa_all, word_id=word_id, suf_len=suf_len)
    occs = np.asarray(occs).astype(idt)
    counts = occs[u]
    E_suffix = np.repeat(np.arange(sa_kept.shape[0], dtype=idt), counts)
    # within-suffix occurrence index 0..count-1
    first = np.concatenate(
        (np.zeros(1, idt), np.cumsum(counts, dtype=np.int64)[:-1].astype(idt))
    )
    within = np.arange(E_suffix.shape[0], dtype=idt) - np.repeat(first, counts)
    E_j = ilist.astype(idt)[np.repeat(seg_start[u], counts) + within]
    return sa_kept, gid, u, suf_len_kept, E_suffix, E_j


def assemble_bwt(dict_flat: np.ndarray, w: int, occs: np.ndarray,
                 bwlast: np.ndarray, ilist: np.ndarray,
                 bwsai: Optional[np.ndarray], n: int, want_sa: bool = False,
                 want_rssa: bool = False, sa_dtype=np.uint64) -> BWTResult:
    """The final BWT (and SA, run-length samples) on the host from the
    checkpoint arrays: the emission layout, one lexsort by (suffix group,
    parse-BWT position), and the per-emission gathers."""
    sa_kept, gid, _, suf_len_kept, E_suffix, E_j = _emissions(
        dict_flat, w, occs, ilist)
    total = E_j.shape[0]
    assert total == n + 1, f"emission count {total} != n+1 ({n + 1})"
    idt = E_j.dtype
    # final order: (suffix group, parse-BWT position)
    order = np.lexsort((E_j, gid[E_suffix])).astype(idt)
    s_ord = E_suffix[order]
    j_ord = E_j[order]
    pos_ord = sa_kept[s_ord]  # dict positions of each emission's suffix
    # offset 0: the suffix starts at 0 or right after EndOfWord/EndOfDict
    dict_flat = np.asarray(dict_flat, dtype=np.uint8)
    is_word_start = np.concatenate(([True], dict_flat[:-1] <= 1))
    bwtc = np.where(
        is_word_start[pos_ord],
        np.asarray(bwlast, dtype=np.uint8)[j_ord],
        np.where(pos_ord == 1, np.uint8(0),
                 dict_flat[np.maximum(pos_ord - 1, 0)]),
    ).astype(np.uint8)

    sa_vals = None
    if want_sa or want_rssa:
        bwsai = np.asarray(bwsai)
        if idt == np.int32 and n < 2**32 - 2:
            # 32-bit gather path (values fit: sa <= n); widen at the end
            sa32 = (bwsai.astype(np.uint32)[j_ord]
                    - suf_len_kept[s_ord].astype(np.uint32))
            sa_vals = sa32.astype(np.uint64)
        else:
            sa_vals = (bwsai.astype(np.uint64)[j_ord]
                       - suf_len_kept[s_ord].astype(np.uint64))
        sa_vals[0] = np.uint64(n)
    return bwt_result(bwtc, sa_vals, want_sa, want_rssa, sa_dtype)
