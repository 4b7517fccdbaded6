"""Exact phrase dedup + byte-lex ranking, on one device and over the
mesh (pfbwtf_tpu/parallel/dict_union.py), and the mesh parse.

Every phrase occurrence becomes a row of big-endian 8-byte chunks of its
bytes, zero past the phrase end.  Phrase bytes are >= Dollar == 2, so
chunk-wise unsigned order is strcmp order, and since the dictionary is
prefix-free with no 0x00/0x01 inside a phrase, equal rows are equal
phrases.  The rows are int64 with the sign bit flipped, so that int64
order is the uint64 order of the chunks (all-ones padding rows sort
last).  A stable lexsort of the rows, a head flag where a row differs
from the one before, and a cumsum give the 1-based dictionary rank of
every occurrence (pfparser.hpp:500-517).

- ``dedup_rank_device``: the rows of one device (the staged build).
- ``rank_rows_blocks``: the collective string sample-sort, the
  multi-device form of merge_pfp's operator+= fold
  (src/merge_pfp.cpp:97-152).  Splitters from regular samples of the
  first chunk (dsort._sort_bucket, JAX's ``_agree_splitters``) route
  equal rows to one rank, one exact exchange moves them, each rank
  lexsorts what it received, and an all_gather of the per-rank unique
  counts numbers the groups globally.
- ``distributed_parse_records``: the mesh parse.  Rank r holds block r
  of T' with a left halo from the rank before; K1 scans its codes once
  (the mask's cut positions are kept for the rows step, where JAX
  recomputes the mask); the ranks all_gather four statistics each, the
  host stitches the blocks on them, each rank builds its phrases' chunk
  rows from its halo-extended block, and ``rank_rows_blocks`` ranks
  them.  A phrase longer than a block (``H > W_t``) takes the exact
  stream fallback: every rank scans the whole stream on its device (K1
  on a card), then the collective rank.
"""

import time

import numpy as np
import torch

from ..ops.fused import _SIGN, _lexsort
from ..ops.hash import cut_mask
from ..ops.parse import (ParseResult, ParserParams, _pack8, _tprime,
                         build_stream)
from ..utils.device import resolve_device
from ..utils.errors import die
from ..utils.limits import check_phrase_count
from ..utils.tables import codes_or_die, ntoa_codes
from ..utils.timer import host_read
from .dsort import _round_up, _sort_bucket
from .sharded import (ParseMesh, all_gather_rows, exchange, gather_ragged,
                      shift_from)


def _dict_from_ranks(T: np.ndarray, starts, ends, ranks: np.ndarray):
    """Host tail: the flat (start, len) dict view of the first occurrence
    of each rank, the occurrence counts, and the uint32 ranks."""
    D = int(ranks.max(initial=0))
    occs = np.bincount(ranks, minlength=D + 1)[1:].astype(np.uint64)
    _, first = np.unique(ranks, return_index=True)
    lens = (ends - starts + 1).astype(np.int64)
    starts = np.asarray(starts, dtype=np.int64)
    return starts[first], lens[first], occs, ranks.astype(np.uint32)


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _chunk_rows(text: torch.Tensor, s: torch.Tensor, ln: torch.Tensor,
                ncols: int) -> torch.Tensor:
    """(N, ncols) sign-flipped big-endian chunk rows of text[s .. s+ln),
    zero past each phrase's end; reads clamp to the text."""
    offs = torch.arange(8, device=text.device)
    shifts = 56 - 8 * offs
    tmax = text.shape[0] - 1
    cols = torch.empty((s.shape[0], ncols), dtype=torch.int64,
                       device=text.device)
    for j in range(ncols):
        off = 8 * j + offs
        ch = text[torch.clamp(s[:, None] + off, 0, tmax)].to(torch.int64)
        ch = torch.where(off < ln[:, None], ch, 0)
        # the eight shifted bytes are disjoint bits: their sum is their or
        cols[:, j] = (ch << shifts).sum(1) ^ _SIGN
    return cols


def dedup_rank_device(T: np.ndarray, starts, ends, device="cuda",
                      info: dict = None):
    """(dict_starts, dict_lens, occs, parse_ranks) as
    ops/parse._dedup_and_rank returns them, the rows built, sorted and
    ranked on ``device``.

    The rows are int64 with the sign bit flipped, so that int64 order is
    the uint64 order of the chunks.  They have ncols = ceil(max phrase
    length / 8) columns: the JAX package rounds ncols up to a multiple of
    4 and N up to a multiple of 4096 for its compile cache, and those
    all-zero columns and all-ones rows leave every rank as it is.  The
    lexsort is one stable sort per column, the last column first.
    ``info``, if given, receives ncols, the row matrix's bytes and the
    lexsort's seconds (timed between two device synchronisations).  The
    ranks come back through utils/timer.host_read (one counted sync)."""
    dev = resolve_device(device)
    starts = np.asarray(starts, dtype=np.int64)
    ends = np.asarray(ends, dtype=np.int64)
    lens = ends - starts + 1
    N = starts.shape[0]
    ncols = max(1, -(-int(lens.max(initial=1)) // 8))
    cols = _chunk_rows(torch.from_numpy(np.ascontiguousarray(T)).to(dev),
                       torch.from_numpy(starts).to(dev),
                       torch.from_numpy(lens).to(dev), ncols)
    _sync(dev)
    t0 = time.perf_counter()
    order = _lexsort([cols[:, j] for j in range(ncols - 1, -1, -1)])
    _sync(dev)
    lexsort_s = time.perf_counter() - t0
    head = torch.zeros(N, dtype=torch.bool, device=dev)
    head[:1] = True
    for j in range(ncols):  # a column at a time: no second row matrix
        c = cols[order, j]
        head[1:] |= c[1:] != c[:-1]
    ranks = torch.empty(N, dtype=torch.int64, device=dev)
    ranks[order] = torch.cumsum(head, 0)  # 1-based group ids
    if info is not None:
        info.update(dedup_ncols=ncols, dedup_rows_bytes=cols.numel() * 8,
                    dedup_lexsort_s=lexsort_s)
    return _dict_from_ranks(T, starts, ends, host_read(ranks).numpy())


# --------------------------------------------------------------------------
# the collective rank
# --------------------------------------------------------------------------


def rank_rows_blocks(mesh: ParseMesh, cols: torch.Tensor, idx: torch.Tensor,
                     N: int):
    """Dense 1-based group ranks of every rank's chunk rows.  ``cols`` is
    this rank's (cap, ncols) int64 sign-flipped rows on its device, ``idx``
    their global occurrence indices (-1: padding).  Returns (ranks (N,)
    int64 numpy, number of groups) on every rank."""
    valid = idx >= 0
    bucket = _sort_bucket(mesh, cols[:, 0], valid)
    got = exchange(mesh, torch.cat((cols, idx[:, None]), 1), bucket, valid)
    rcols, ridx = got[:, :-1], got[:, -1]
    ncols = rcols.shape[1]
    order = _lexsort([rcols[:, j] for j in range(ncols - 1, -1, -1)])
    M = order.shape[0]
    head = torch.zeros(M, dtype=torch.bool, device=cols.device)
    head[:1] = True
    for j in range(ncols):
        c = rcols[order, j]
        head[1:] |= c[1:] != c[:-1]
    uniq = all_gather_rows(mesh, head.sum().reshape(1)).flatten().tolist()
    base = sum(uniq[: mesh.rank])
    rank = torch.empty(M, dtype=torch.int64, device=cols.device)
    rank[order] = base + torch.cumsum(head, 0)
    pairs = gather_ragged(mesh, torch.stack((ridx, rank), 1)).cpu().numpy()
    ranks = np.zeros(N, dtype=np.int64)
    ranks[pairs[:, 0]] = pairs[:, 1]
    if N and ranks.min() < 1:
        die("distributed rank: unassigned occurrence (collective bug)")
    return ranks, int(ranks.max(initial=0))


def _flip(cols: np.ndarray) -> np.ndarray:
    """uint64 chunk rows -> int64 with the sign bit flipped."""
    return np.ascontiguousarray(cols, dtype=np.uint64).view(np.int64) ^ _SIGN


def distributed_rank_rows(cols: np.ndarray, mesh: ParseMesh):
    """Dense 1-based lexicographic group ranks of the uint64 chunk rows
    (N, ncols), by the collective rank; rank r takes the r-th block of
    rows.  Returns (ranks (N,), number of groups) on every rank."""
    N = cols.shape[0]
    cap = _round_up(max(1, -(-N // mesh.size)), 256)
    lo = min(mesh.rank * cap, N)
    hi = min(lo + cap, N)
    blk = torch.from_numpy(_flip(cols[lo:hi])).to(mesh.device)
    idx = torch.arange(lo, hi, device=mesh.device)
    return rank_rows_blocks(mesh, blk, idx, N)


def phrase_chunk_rows(T: np.ndarray, starts, ends) -> np.ndarray:
    """(N, ncols) big-endian 8-byte chunk rows of T[s..e] per phrase."""
    starts = np.asarray(starts, dtype=np.int64)
    lens = (np.asarray(ends, dtype=np.int64) - starts + 1)
    ncols = max(1, -(-int(lens.max(initial=1)) // 8))
    cols = np.empty((starts.shape[0], ncols), dtype=np.uint64)
    for j in range(ncols):
        cols[:, j] = _pack8(T, starts, 8 * j, lens)
    return cols


def distributed_dedup_rank(T: np.ndarray, starts, ends, mesh: ParseMesh):
    """Collective phrase dedup + byte-lex ranking: (dict_starts,
    dict_lens, occs, parse_ranks) as ops/parse._dedup_and_rank returns
    them, on every rank."""
    starts = np.asarray(starts, dtype=np.int64)
    ends = np.asarray(ends, dtype=np.int64)
    ranks, _ = distributed_rank_rows(phrase_chunk_rows(T, starts, ends), mesh)
    return _dict_from_ranks(T, starts, ends, ranks)


# --------------------------------------------------------------------------
# the mesh parse.  T' window position t is stream position k = t - 1, so
# the cut set is {t : t > w, hash(k-mer at t) % p == 0, t <= C_len} plus
# the pseudo-cut t = C_len + w that ends the last phrase.
# --------------------------------------------------------------------------


def _halo_ext(mesh: ParseMesh, tp: torch.Tensor, H: int) -> torch.Tensor:
    """This rank's T' block with the H bytes before it (H <= the block)."""
    return torch.cat((shift_from(mesh, tp[-H:], -1), tp))


def _cut_positions(mesh: ParseMesh, tp: torch.Tensor, blk_start: int,
                   H: int, C_len: int, w: int, p: int) -> torch.Tensor:
    """Block indices of this rank's cuts: K1 over the codes of the block
    with an H-byte halo (H > w, so K1's cleared head is halo), then the
    t > w, t <= C_len and pseudo-cut guards on T' positions t."""
    ext = _halo_ext(mesh, tp, H)
    cut = cut_mask(ntoa_codes(ext), w, p)[H:]
    t = blk_start + torch.arange(tp.shape[0], device=tp.device)
    cut &= (t > w) & (t <= C_len)
    cut |= t == C_len + w
    return torch.nonzero(cut).flatten()


def _stitch(stats: np.ndarray, w: int):
    """The host's cross-rank stitch over every rank's (count, first_t,
    last_t, longest phrase after its first cut): the previous cut before
    each rank, each rank's first occurrence index and the longest
    phrase."""
    cnt = stats[:, 0]
    prev_t = np.full(cnt.shape[0], w - 1, dtype=np.int64)  # start 0
    run_last, have_prev = w - 1, False
    maxlen = int(stats[:, 3].max(initial=0))
    for s in range(cnt.shape[0]):
        prev_t[s] = run_last
        if cnt[s] > 0:
            f = int(stats[s, 1])
            maxlen = max(maxlen, f - run_last + w if have_prev else f + 1)
            run_last = int(stats[s, 2])
            have_prev = True
    base_idx = np.zeros(cnt.shape[0], dtype=np.int64)
    np.cumsum(cnt[:-1], out=base_idx[1:])
    return prev_t, base_idx, maxlen


def distributed_parse_records(records, params: ParserParams,
                              mesh: ParseMesh, info: dict = None
                              ) -> ParseResult:
    """The mesh parse of FASTA records, the same ParseResult as the
    single-stream parse, on every rank (PfParser::add_fasta + finalize,
    pfparser.hpp:299-369, 484-517, exact by the junction identity).  The
    invalid-character check, the one-word and phrase-count checks are
    made on every rank from the same data, so every rank raises at the
    same point.  ``info`` receives sizing_s (upload, halo, K1, the
    statistics' all_gather), rows_s (the chunk rows), rank_s (the
    collective rank, ranks to the host), bounds_s (phrase bounds to the
    host, dict view) and stream_fallback (a phrase longer than a block:
    the whole stream scanned on every rank)."""
    info = {} if info is None else info
    w, p = params.w, params.p
    t0 = time.perf_counter()
    C, doc_names, doc_starts = build_stream(records, params)
    codes_or_die(C)
    T = _tprime(C, w)
    C_len = int(C.shape[0])
    W_t = _round_up(max(-(-T.shape[0] // mesh.size), 64), 64)
    blk_start = mesh.rank * W_t
    blk = np.zeros(W_t, dtype=np.uint8)  # pad byte 0 < Dollar
    part = T[blk_start: blk_start + W_t]
    blk[: part.shape[0]] = part
    tp = torch.from_numpy(blk).to(mesh.device)
    H0 = _round_up(w + 1, 64)
    loc = _cut_positions(mesh, tp, blk_start, H0, C_len, w, p)
    t = blk_start + loc
    nloc = loc.shape[0]
    dev = mesh.device
    stat = torch.zeros(4, dtype=torch.int64, device=dev)
    if nloc:
        stat[0] = nloc
        stat[1] = t[0]
        stat[2] = t[-1]
        if nloc > 1:
            stat[3] = (t[1:] - t[:-1]).max() + w
    stats = all_gather_rows(mesh, stat).cpu().numpy()
    t1 = time.perf_counter()
    nphrases = int(stats[:, 0].sum())
    if nphrases <= 1:
        die("error: only one dict word total. Re-run with a smaller p "
            "modulus")
    check_phrase_count(nphrases)
    prev_t, base_idx, maxlen = _stitch(stats, w)
    H = _round_up(max(maxlen, w + 1), 64)
    info["stream_fallback"] = H > W_t
    if H > W_t:
        # a phrase longer than a block: one rank's halo cannot hold it,
        # so every rank scans the whole stream on its device (K1 on a
        # card), which is exact (rare: p bounds the phrase length)
        from ..engine import parse_stream

        mesh.stats["stream_fallbacks"] += 1
        starts, ends = parse_stream(C, params, device=mesh.device)
        t2 = time.perf_counter()
        dict_starts, dict_lens, occs, parse_ranks = distributed_dedup_rank(
            T, starts, ends, mesh)
        t3 = t4 = time.perf_counter()  # the bounds are on the host
    else:
        ends_d = t
        prev_e = torch.cat((torch.tensor([prev_t[mesh.rank]], device=dev),
                            ends_d[:-1]))
        starts_d = prev_e - w + 1
        ext = _halo_ext(mesh, tp, H)
        rows = _chunk_rows(ext, starts_d - (blk_start - H),
                           ends_d - starts_d + 1, max(1, -(-maxlen // 8)))
        idx = base_idx[mesh.rank] + torch.arange(nloc, device=dev)
        del ext
        t2 = time.perf_counter()
        ranks, _ = rank_rows_blocks(mesh, rows, idx, nphrases)
        del rows
        t3 = time.perf_counter()
        # O(#phrases) bounds to the host, in occurrence order
        se = gather_ragged(mesh, torch.stack((starts_d, ends_d), 1))
        se = se.cpu().numpy()
        starts, ends = se[:, 0], se[:, 1]
        dict_starts, dict_lens, occs, parse_ranks = _dict_from_ranks(
            T, starts, ends, ranks)
        t4 = time.perf_counter()
    info.update(sizing_s=t1 - t0, rows_s=t2 - t1, rank_s=t3 - t2,
                bounds_s=t4 - t3)
    return ParseResult(
        params=params,
        text=T,
        dict_starts=dict_starts,
        dict_lens=dict_lens,
        occs=occs,
        parse_ranks=parse_ranks,
        last=T[ends - w],
        sai=ends.astype(np.uint64),
        doc_names=list(doc_names) if params.store_docs else [],
        doc_starts=list(doc_starts) if params.store_docs else [],
        pos=C.shape[0] + w,
        nseqs=len(records),
    )
