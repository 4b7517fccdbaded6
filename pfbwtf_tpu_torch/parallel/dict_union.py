"""Phrase dedup + byte-lex ranking on one device (the local device path
of pfbwtf_tpu/parallel/dict_union.py).

Every phrase occurrence becomes a row of big-endian 8-byte chunks of its
bytes, zero past the phrase end.  Phrase bytes are >= Dollar == 2, so
chunk-wise unsigned order is strcmp order, and since the dictionary is
prefix-free with no 0x00/0x01 inside a phrase, equal rows are equal
phrases.  A stable lexsort of the rows, a head flag where a row differs
from the one before, and a cumsum give the 1-based dictionary rank of
every occurrence (pfparser.hpp:500-517).
"""

import time

import numpy as np
import torch

from ..ops.fused import _SIGN, _lexsort
from ..utils.device import resolve_device


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
    lexsort's seconds (timed between two device synchronisations)."""
    dev = resolve_device(device)
    starts = np.asarray(starts, dtype=np.int64)
    ends = np.asarray(ends, dtype=np.int64)
    lens = ends - starts + 1
    N = starts.shape[0]
    ncols = max(1, -(-int(lens.max(initial=1)) // 8))
    Tt = torch.from_numpy(np.ascontiguousarray(T)).to(dev)
    s = torch.from_numpy(starts).to(dev)
    ln = torch.from_numpy(lens).to(dev)
    tmax = T.shape[0] - 1
    offs = torch.arange(8, device=dev)
    shifts = 56 - 8 * offs
    cols = torch.empty((N, ncols), dtype=torch.int64, device=dev)
    for j in range(ncols):
        off = 8 * j + offs
        ch = Tt[torch.clamp(s[:, None] + off, max=tmax)].to(torch.int64)
        ch = torch.where(off < ln[:, None], ch, 0)
        # the eight shifted bytes are disjoint bits: their sum is their or
        cols[:, j] = (ch << shifts).sum(1) ^ _SIGN
    del Tt, s, ln, ch
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
    return _dict_from_ranks(T, starts, ends, ranks.cpu().numpy())
