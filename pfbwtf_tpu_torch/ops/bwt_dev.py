"""Device-side final BWT assembly (the emission-sort formulation of
pfbwtf_tpu/ops/bwt.py, on tensors).

Every output position is one (suffix s, occurrence j) pair, where s is a
dict suffix longer than w and j runs over the parse-BWT positions of its
word.  The output order is (suffix-string group, j), so the whole sweep
of the reference (pfbwt.hpp:97-194) is one sort of n+1 emission keys
followed by gathers for the BWT char and the SA sample.

In the fused build the shapes follow the JAX package's bucket grid
(nsuf_b, total_b) and the true sizes arrive as host integers;
``assemble_bwt_dev``, the staged build's stage 3, runs at the true sizes.
Both finish in ``bwt_result_dev``: the run-length sampling of
ops/bwt.bwt_result on the device, then one download of the outputs.
"""

import numpy as np
import torch

from ..constants import Dollar, EndOfDict, EndOfWord
from ..utils.device import resolve_device
from ..utils.timer import count, host_read, span
from .bwt import BWTResult
from .carry import carry_max, carry_min
from .suffix import (capture_levels, compact_indices, doubling_with_captures,
                     packed_dict_keys)

_I64_MAX = 2**63 - 1


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(x)
    out[1:] = torch.cumsum(x, 0)[:-1]
    return out


def _set_drop(size: int, idx, vals, device) -> torch.Tensor:
    """zeros(size).at[idx].set(vals, mode="drop") for idx in [0, size]:
    lanes sent to index ``size`` go to a spare slot that is cut off."""
    out = torch.zeros(size + 1, dtype=torch.int64, device=device)
    out[idx] = vals
    return out[:size]


def dict_sort_part(dict_flat: torch.Tensor, w: int, n_levels: int = None):
    """Dict suffix sort with exact equality captures and per-position
    metadata.  The suffix length of a position is its distance to the
    next separator (a reverse cummin), computed before the sort so the
    doubling can capture blocks at level floor_pow2(len).
    Returns (sa_all, C1, C2, suf_len, word_id)."""
    D = dict_flat.shape[0]
    iota = torch.arange(D, device=dict_flat.device)
    is_eow = dict_flat == EndOfWord
    is_sep = is_eow | (dict_flat == EndOfDict)
    word_id = _exclusive_cumsum(is_eow.to(torch.int64))
    keys0, k0 = packed_dict_keys(dict_flat, w)
    sep_idx = torch.where(is_sep, iota, D)
    next_sep = carry_min(sep_idx, reverse=True)
    suf_len = next_sep - iota
    sa_all, _, C1, C2 = doubling_with_captures(keys0, suf_len, k0=k0,
                                               n_levels=n_levels)
    return sa_all, C1, C2, suf_len, word_id


def _emit_decode(fl_ord, j_ord, ls_ord, bwlast, bwsai, m_ilist: int):
    """Per-lane flags / j / suffix length in final order -> BWT chars and
    SA samples.  A kept suffix preceded by Dollar can only follow T's
    leading sentinel, and the char before it is the terminator 0x00."""
    whole = (fl_ord >> 8) != 0
    pch = (fl_ord & 255).to(torch.uint8)
    j = torch.clamp(j_ord, 0, m_ilist - 1)
    bwtc = torch.where(
        whole, bwlast[j], torch.where(pch == Dollar, 0, pch)
    )
    # uint64 difference, wrapping as in the JAX package on padded lanes
    sa_vals = bwsai[j] - ls_ord
    return bwtc, sa_vals


def emission_state(dict_flat, occs, nsuf_true: int, w: int, nsuf_b: int,
                   sorted_state, seg_start=None):
    """Nsuf-scale emission bookkeeping: kept suffixes in lexicographic
    order, exact equality groups (length + captured rank blocks), per
    suffix emission counts, first slots, BWT-char flags, the per-group
    suffix length table and the ilist segment start of each kept suffix's
    word.  Returns (sa_kept, suf_valid, ls, gid, u, counts, first, flags,
    ls_tab, seg_u)."""
    dev = dict_flat.device
    D = dict_flat.shape[0]
    dwords = occs.shape[0]
    sa_all, C1, C2, suf_len, word_id = sorted_state
    kept_idx = compact_indices(suf_len[sa_all] > w, nsuf_b, fill=0)
    sa_kept = sa_all[kept_idx]
    suf_valid = torch.arange(nsuf_b, device=dev) < nsuf_true
    prev_sep = torch.ones(D, dtype=torch.int64, device=dev)
    prev_sep[1:] = dict_flat[:-1] <= 1
    prevch = torch.zeros(D, dtype=torch.int64, device=dev)
    prevch[1:] = dict_flat[:-1]
    flags_src = (prev_sep << 8) | prevch
    at = torch.clamp(sa_kept, 0, D - 1)
    ls, c1k, c2k = suf_len[at], C1[at], C2[at]
    u = torch.clamp(word_id[at], 0, max(dwords - 1, 0))
    flags = flags_src[at]
    eq = (
        (ls[1:] == ls[:-1])
        & (c1k[1:] == c1k[:-1])
        & (c2k[1:] == c2k[:-1])
        & suf_valid[1:]
    )
    gid = torch.zeros(nsuf_b, dtype=torch.int64, device=dev)
    gid[1:] = torch.cumsum(~eq, 0)
    occs_n = occs.to(torch.int64)
    if seg_start is None:
        seg_start = 1 + _exclusive_cumsum(occs_n)
    counts = torch.where(suf_valid, occs_n[u], 0)
    seg_u = seg_start.to(torch.int64)[u]
    first = _exclusive_cumsum(counts)
    # suffix length per group: constant within a group, set at group heads
    head = torch.ones(nsuf_b, dtype=torch.bool, device=dev)
    head[1:] = gid[1:] != gid[:-1]
    ls_tab = _set_drop(
        nsuf_b, torch.where(head & suf_valid, gid, nsuf_b),
        torch.where(suf_valid, ls, 0), dev,
    )
    return (
        sa_kept, suf_valid, ls, gid, u, counts, first, flags, ls_tab, seg_u,
    )


def assemble_core(dict_flat, occs, bwlast, ilist, bwsai, nsuf_true: int,
                  total_true: int, w: int, nsuf_b: int, total_b: int,
                  sorted_state=None, seg_start=None, wide: bool = None,
                  n_levels: int = None):
    """Emission-sort assembly -> (bwt chars, SA values), each total_b long.

    Each emission lane needs its suffix's group id, BWT-char flags and
    ilist-slot base.  Where the packed (gid, j, flags) key fits 63 bits,
    each is constant across its suffix's run of lanes, so per-emitter
    differences are added at the runs' first slots and integrated with
    one cumsum each (the fill fan-out), and one single-key sort of the
    packed key gives the order.  Past 63 bits, or where ``wide`` forces
    it, suffix ids set at their first emission slots (strictly increasing
    over the suffixes that emit) are filled forward by a running max (the
    scatter fan-out), and a stable two-key sort on (gid, j) gives the
    order, exact at any width: the JAX package's path past 63 bits."""
    dev = dict_flat.device
    if sorted_state is None:
        sorted_state = dict_sort_part(dict_flat, w, n_levels=n_levels)
    (
        sa_kept, suf_valid, ls, gid, u, counts, first, flags, ls_tab, seg_u,
    ) = emission_state(
        dict_flat, occs, nsuf_true, w, nsuf_b, sorted_state, seg_start
    )
    eidx = torch.arange(total_b, device=dev)
    m_ilist = ilist.shape[0]
    e_valid = eidx < total_true
    KB = int(np.ceil(np.log2(m_ilist + 2)))
    nsuf_bits = int(np.ceil(np.log2(nsuf_b + 2)))
    narrow = max(dict_flat.shape[0], total_b) < 2**31 - 2

    if nsuf_bits + KB + 9 <= 63 and not wide:
        emit = counts > 0
        sidx = torch.arange(nsuf_b, device=dev)
        # index of the last emitter strictly before s
        pe_ex = torch.full((nsuf_b,), -1, dtype=torch.int64, device=dev)
        pe_ex[1:] = carry_max(torch.where(emit, sidx, -1))[:-1]
        sc_idx = torch.where(emit, first, total_b)
        prev = torch.clamp(pe_ex, 0, nsuf_b - 1)

        def fill(v):
            diff = v - torch.where(pe_ex >= 0, v[prev], 0)
            d = torch.zeros(total_b + 1, dtype=torch.int64, device=dev)
            d.index_add_(0, sc_idx, torch.where(emit, diff, 0))
            return torch.cumsum(d[:total_b], 0)

        gid_lane = fill(gid)
        flags_lane = fill(flags)
        base_lane = fill(seg_u - first)
        E_j = ilist[torch.clamp(eidx + base_lane, 0, m_ilist - 1)]
        key = (gid_lane << (KB + 9)) | (E_j << 9) | flags_lane
        key_ord = torch.sort(torch.where(e_valid, key, _I64_MAX)).values
        gid_ord = key_ord >> (KB + 9)
        if narrow:
            # the JAX package decodes into int32 when every index fits,
            # which wraps the padded lanes' sentinel group; wrapping the
            # same way keeps the padded buffers (and the checksum) equal
            gid_ord = gid_ord.to(torch.int32).to(torch.int64)
        ls_ord = ls_tab[torch.clamp(gid_ord, 0, nsuf_b - 1)]
        return _emit_decode(key_ord & 511, (key_ord >> 9) & ((1 << KB) - 1),
                            ls_ord, bwlast, bwsai, m_ilist)
    mark = _set_drop(
        total_b, torch.where(counts > 0, first, total_b),
        torch.arange(nsuf_b, device=dev) + 1, dev,
    )
    E_suffix = torch.clamp(carry_max(mark) - 1, 0, nsuf_b - 1)
    within = eidx - first[E_suffix]
    E_j = ilist[torch.clamp(seg_u[E_suffix] + within, 0, m_ilist - 1)]
    gid_e = gid[E_suffix]
    # two-key sort on (gid, j), stable: exact at any width; invalid lanes
    # last
    hi = torch.where(e_valid, gid_e, nsuf_b)
    order = torch.argsort(E_j, stable=True)
    order = order[torch.argsort(hi[order], stable=True)]
    j_ord = E_j[order]
    ls_ord = ls_tab[torch.clamp(gid_e, 0, nsuf_b - 1)][order]
    fl_ord = flags[E_suffix][order]
    return _emit_decode(fl_ord, j_ord, ls_ord, bwlast, bwsai, m_ilist)


def assemble_bwt_dev(dict_flat: np.ndarray, w: int, occs: np.ndarray,
                     bwlast: np.ndarray, ilist: np.ndarray, bwsai, n: int,
                     want_sa: bool = False, want_rssa: bool = False,
                     sa_dtype=np.uint64, device="cuda") -> BWTResult:
    """Stage 3 of the staged build on ``device``: the .dict bytes, the
    occurrence counts and the parse-BWT files to the final BWT, the SA
    (its first entry n) and the run-length samples.

    The JAX package pads every array to its bucket grid for its compile
    cache: EndOfDict separators after the dict, zero-count words,
    unreferenced ilist slots, invalid emission lanes.  None of them
    reaches the first n + 1 outputs, so the arrays go in at their own
    lengths and nsuf_b, total_b are the true sizes.  The tail,
    bwt_result_dev, is span ``fetch``, as in the fused build."""
    dev = resolve_device(device)
    dict_flat = np.asarray(dict_flat, dtype=np.uint8)
    occs = np.asarray(occs, dtype=np.int64)
    D = dict_flat.shape[0]
    dwords = occs.shape[0]
    nsuf = (D - 1 - dwords) - dwords * w
    total = n + 1
    if bwsai is None:
        bwsai = np.zeros(ilist.shape[0], dtype=np.uint64)
    # the max word length below, and dict_sort_part's suffix lengths,
    # need a separator-terminated dict
    if D == 0 or dict_flat[-1] > 1:
        raise ValueError(
            "assemble_bwt_dev: dict_flat must end with a separator byte "
            f"(EndOfWord/EndOfDict), got {int(dict_flat[-1]) if D else 'empty'}"
        )
    seps = np.flatnonzero(dict_flat <= 1)
    max_len = int(np.diff(np.concatenate(([-1], seps))).max()) - 1

    def put(a, dtype):  # a writable copy: file arrays are read-only
        return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)

    bwtc, sa_vals = assemble_core(
        put(dict_flat, np.uint8), put(occs, np.int64),
        put(bwlast, np.uint8), put(ilist, np.int64),
        put(np.asarray(bwsai, dtype=np.uint64).view(np.int64), np.int64),
        nsuf, total, w, nsuf, total, n_levels=capture_levels(max_len, w),
    )
    with span("fetch"):
        return bwt_result_dev(bwtc, sa_vals, total, n, want_sa, want_rssa,
                              sa_dtype)


def bwt_result_dev(bwt_d: torch.Tensor, sa_d: torch.Tensor, total: int,
                   n: int, want_sa: bool, want_rssa: bool, sa_dtype,
                   info: dict = None) -> BWTResult:
    """ops/bwt.bwt_result finished where ``bwt_d`` and ``sa_d`` live: the
    run count, the (position, sample) pairs at run starts (.ssa) and run
    ends (.esa) already in ``sa_dtype``, and the asked-for outputs brought
    to the host.  The first ``total`` entries of ``bwt_d`` (uint8) and
    ``sa_d`` (int64 holding the uint64 SA) are the result; ``sa_d[0]`` is
    set to ``n`` when the SA is used.

    Span ``fetch.sample`` holds the sampling and the read of the run
    count (one sync); span ``fetch.download`` copies the BWT, the SA when
    ``want_sa`` and the pairs when ``want_rssa`` into views of one pinned
    host block and waits once (one sync).  The returned arrays are views
    of that block, so a result keeps it alive and the block goes back to
    torch's host cache only when the result dies.  On the CPU the arrays
    are the tensors' own memory.  Counters: ``sample_dev`` 1,
    ``d2h_bytes`` every byte read back, ``pinned_bytes`` the block's size
    (on the card only).  ``info``, where given, receives ``sample_s`` and
    ``download_s``."""
    sa_dtype = np.dtype(sa_dtype)
    bwt = bwt_d[:total]
    outs = {}  # name: (tensor, numpy dtype), 8-byte lanes first so that
    # every view of the pinned block is aligned
    with span("fetch.sample") as sample:
        count("sample_dev")
        if want_sa or want_rssa:
            sa_d[0] = n
            sa = sa_d[:total]
        if want_sa:
            outs["sa"] = (sa, np.uint64)
        run_start = torch.empty(total, dtype=torch.bool, device=bwt.device)
        run_start[0] = True
        torch.ne(bwt[1:], bwt[:-1], out=run_start[1:])
        nruns = int(host_read(torch.count_nonzero(run_start)))
        if want_rssa:
            rs = torch.nonzero_static(run_start, size=nruns).squeeze(1)
            re = torch.empty_like(rs)
            re[:-1] = rs[1:] - 1
            re[-1] = total - 1
            lanes = torch.int32 if sa_dtype.itemsize == 4 else torch.int64
            for name, pos in (("ssa", rs), ("esa", re)):
                pairs = torch.empty((nruns, 2), dtype=lanes,
                                    device=bwt.device)
                pairs[:, 0] = pos
                pairs[:, 1] = sa.index_select(0, pos)
                outs[name] = (pairs.view(-1), sa_dtype)
        del run_start
        outs["bwt"] = (bwt, np.uint8)
    with span("fetch.download") as download:
        arrays = _download(outs)
    if info is not None:
        info.update(sample_s=sample.seconds, download_s=download.seconds)
    return BWTResult(bwt=arrays["bwt"], sa=arrays.get("sa"), nruns=nruns,
                     ssa=arrays.get("ssa"), esa=arrays.get("esa"))


def _download(outs: dict) -> dict:
    """The host arrays of ``outs`` (name: (1-D tensor, numpy dtype), on
    one device): on the card one pinned block, each tensor copied without
    blocking into its own view of it, then one wait; on the CPU the
    tensors' own memory."""
    nbytes = sum(t.numel() * t.element_size() for t, _ in outs.values())
    count("d2h_bytes", nbytes)
    count("syncs")  # the wait, on the CPU too, as the bytes are
    dev = outs["bwt"][0].device
    if dev.type == "cpu":
        return {k: t.numpy().view(dt) for k, (t, dt) in outs.items()}
    count("pinned_bytes", nbytes)
    block = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    arrays, off = {}, 0
    for k, (t, dt) in outs.items():
        nb = t.numel() * t.element_size()
        h = block[off:off + nb].view(t.dtype)
        h.copy_(t, non_blocking=True)
        arrays[k] = h.numpy().view(dt)
        off += nb
    torch.cuda.current_stream(dev).synchronize()
    return arrays
