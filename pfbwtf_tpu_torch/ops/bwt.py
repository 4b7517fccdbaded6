"""The final BWT result as the host receives it, the run-length sampling
that completes it on the host, and the host's dict-scale suffix layout of
the staged -m assembly (ops/bwt_mmap.assemble_bwt_stream)."""

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


def suffix_layout(dict_flat, w, occs, small_hint=True, workspace=None):
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
    (pfbwt.hpp:208-209).

    Returns (sa_kept, gid, u, suf_len_kept, seg_start, idt)."""
    from .. import native
    from .suffix_np import dict_suffix_sort_np, suffix_group_ids_np

    dict_flat = np.asarray(dict_flat, dtype=np.uint8)
    small = dict_flat.shape[0] < 2**31 - 8 and small_hint
    idt = np.int32 if small else np.int64
    if native.available():
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
