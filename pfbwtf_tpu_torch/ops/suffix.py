"""Suffix sorting by prefix doubling (Manber-Myers) on tensors.

The device half of pfbwtf_tpu/ops/suffix.py: index compaction, the
dense-rank doubling that sorts the parse, and the dict doubling over
byte-packed keys with exact rank-block captures.  Each round is one
stable ``torch.sort`` of a packed (rank, rank[i+k]) key; the loop
condition reads one scalar per round (a counted host read,
utils/timer).  ``rounds`` records how many rounds the last call of each
doubling took; the open build counts them all as ``rounds``.
"""

import numpy as np
import torch

from ..constants import EndOfDict
from ..utils.timer import count, host_read
from .carry import posrank

rounds = {"parse_sa": 0, "dict_sa": 0}


def _pack_bits(n: int) -> int:
    """Bits that hold one of n + 2 key values (the shift of the packed
    (rank, key2 + 1) sort key)."""
    return int(np.ceil(np.log2(n + 2)))


def _shifted(rank: torch.Tensor, k: int) -> torch.Tensor:
    """rank[i + k], or -1 past the end."""
    n = rank.shape[0]
    key2 = torch.full_like(rank, -1)
    if k < n:
        key2[: n - k] = rank[k:]
    return key2


def _pair_key(rank: torch.Tensor, k: int) -> torch.Tensor:
    n = rank.shape[0]
    key2 = _shifted(rank, k) + 1
    if n < 2**31 - 2:
        return (rank << _pack_bits(n)) | key2
    return rank * (n + 1) + key2


def _scatter_perm(order: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """out[order[i]] = vals[i] for a permutation ``order``."""
    out = torch.empty_like(vals)
    out[order] = vals
    return out


def compact_indices(mask: torch.Tensor, size: int, fill: int = 0):
    """Ascending indices of the True lanes, truncated or padded with
    ``fill`` to ``size`` — jnp.nonzero(size=, fill_value=) without a host
    sync.  Lanes past ``size`` land in one spare slot that is cut off."""
    n = mask.shape[0]
    pos = torch.cumsum(mask, 0) - 1
    slot = torch.where(mask & (pos < size), pos, size)
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=mask.device)
    out.scatter_(0, slot, torch.arange(n, device=mask.device))
    return out[:size]


def _doubling(keys: torch.Tensor):
    """Prefix doubling over integer keys with dense ranks; ends as soon as
    the ranks are all distinct.  Returns (suffix order, rank)."""
    n = keys.shape[0]

    def rank_of(ck):
        cks, order = torch.sort(ck, stable=True)
        changed = torch.zeros(n, dtype=torch.int64, device=ck.device)
        changed[1:] = cks[1:] != cks[:-1]
        return _scatter_perm(order, torch.cumsum(changed, 0))

    rank = rank_of(keys.to(torch.int64))
    k, nround = 1, 0
    while k < n and int(host_read(rank.max())) < n - 1:
        rank = rank_of(_pair_key(rank, k))
        k *= 2
        nround += 1
    rounds["parse_sa"] = nround
    count("rounds", nround)
    return torch.argsort(rank, stable=True), rank


def packed_dict_keys_k0(w: int) -> int:
    """The initial doubling level of the byte-packed keys: largest power
    of two <= min(8, w+1) bytes per key."""
    k0 = 1
    while k0 * 2 <= min(8, w + 1):
        k0 *= 2
    return k0


def capture_levels(max_len: int, w: int) -> int:
    """Capture-table height for doubling_with_captures from the max dict
    word length: levels up to floor_pow2(max_len), +1 safety, rounded up
    to a multiple of 4; rows count from k0, the level of the packed
    keys."""
    log2k0 = int(np.round(np.log2(packed_dict_keys_k0(w))))
    need = int(np.floor(np.log2(max(max_len, 1)))) - log2k0 + 2
    return max(4, -(-need // 4) * 4)


def _shifted_left(b: torch.Tensor, j: int) -> torch.Tensor:
    """b[i + j], or 0 past the end."""
    out = torch.zeros_like(b)
    out[: max(b.shape[0] - j, 0)] = b[j:]
    return out


def packed_dict_keys(dict_flat: torch.Tensor, w: int):
    """Initial doubling keys of the dict byte array: k0 raw bytes packed
    big-endian into one int64, with every EndOfDict position (terminator
    and bucket pads) overridden by a distinct ascending negative, so the
    loop is bounded by the real suffixes' max LCP.  Returns (keys, k0)."""
    D = dict_flat.shape[0]
    iota = torch.arange(D, device=dict_flat.device)
    eod = dict_flat == EndOfDict
    k0 = packed_dict_keys_k0(w)
    b = dict_flat.to(torch.int64)
    key = torch.zeros(D, dtype=torch.int64, device=dict_flat.device)
    for j in range(k0):
        key = (key << 8) | _shifted_left(b, j)
    return torch.where(eod, iota - D, key), k0


def _floor_pow2(x: torch.Tensor) -> torch.Tensor:
    """Largest power of two <= x, elementwise (x >= 1), by bit smearing."""
    v = x.to(torch.int64)
    for s in (1, 2, 4, 8, 16, 32):
        v = v | (v >> s)
    return v - (v >> 1)


def _log2_pow2(x: torch.Tensor) -> torch.Tensor:
    """log2 of a tensor of powers of two (exact in float64)."""
    return torch.log2(x.to(torch.float64)).round().to(torch.int64)


def doubling_with_captures(keys: torch.Tensor, cap_len: torch.Tensor,
                           k0: int, n_levels: int = None):
    """Prefix doubling that also captures, for every position j, the rank
    blocks for O(1) exact substring equality (the sparse-table two-block
    test):

        t_j  = max(k0, floor_pow2(cap_len[j]))
        C1_j = R_t[j],   C2_j = R_t[j + cap_len[j] - t_j]

    Two positions with equal cap_len are substring-equal over that length
    iff their (C1, C2) match.  ``keys`` are level-k0 keys.  Ranks are
    POSITIONAL (the sorted position of the group's head: one launch of
    kernel K5 a round on a card, carry.posrank), stored per round in a
    (levels, n) table and captured after the loop.  ``n_levels`` bounds
    the table height; queries past it, or past the last executed round,
    keep distinct negative sentinels.  Identity captures, as every
    caller of the JAX package's passes.  Returns (order, rank, C1, C2)."""
    n = keys.shape[0]
    dev = keys.device
    idx = torch.arange(n, device=dev)

    def round_of(ck):
        """One round: (positional rank, number of groups)."""
        cks, order = torch.sort(ck, stable=True)
        rank, counts = posrank(cks, order)
        return rank, int(host_read(counts))

    cap_len = cap_len.to(torch.int64)
    t = torch.clamp(_floor_pow2(torch.clamp(cap_len, min=1)), min=k0)
    p2 = torch.clamp(idx + cap_len - t, 0, n - 1)
    log2k0 = int(np.round(np.log2(k0)))
    full_levels = max(_pack_bits(n) - log2k0 + 1, 1)
    if n_levels is None:
        n_levels = full_levels
    n_levels = max(1, min(n_levels, full_levels))
    # +1 trash row: rounds past the table height write there
    Rlev = torch.zeros((n_levels + 1, n), dtype=torch.int64, device=dev)
    rank, n_groups = round_of(keys.to(torch.int64))
    Rlev[0] = rank
    k, nround = k0, 0
    while k < n and n_groups < n:
        rank, n_groups = round_of(_pair_key(rank, k))
        k *= 2
        nround += 1
        Rlev[min(int(np.log2(k)) - log2k0, n_levels)] = rank
    rounds["dict_sa"] = nround
    count("rounds", nround)
    lvl_q = _log2_pow2(t) - log2k0
    ok = (lvl_q <= int(np.log2(k)) - log2k0) & (lvl_q < n_levels)
    lvl_c = torch.clamp(lvl_q, 0, n_levels - 1)
    sentinel = -idx - 1
    C1 = torch.where(ok, Rlev[lvl_c, idx], sentinel)
    C2 = torch.where(ok, Rlev[lvl_c, p2], sentinel)
    return torch.argsort(rank, stable=True), rank, C1, C2
