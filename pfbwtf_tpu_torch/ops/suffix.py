"""Suffix sorting by prefix doubling (Manber-Myers) on tensors.

The device half of pfbwtf_tpu/ops/suffix.py: index compaction, the
dense-rank doubling that sorts the parse, and the dict doubling with
exact rank-block captures, byte-packed or 3-bit-packed (acgt3) keys and
the opt-in subset-refinement schedule.  Each round is one stable
``torch.sort`` of a packed (rank, rank[i+k]) key; the loop condition
reads one or two scalars per round (each a counted host read,
utils/timer).  ``rounds`` records how many rounds the last call of each
doubling took (``dict_sa_subset``: how many of them were subset rounds);
the open build counts them all as ``rounds``.

The opt-in engine variables are read at call time, as in pfbwtf_tpu:

- ``PFBWT_SORT_IMPL`` (``sort_impl``): ``radix`` selects the JAX
  package's LSD radix argsort, a TPU stand-in for the bitonic lax.sort.
  On CUDA a stable ``torch.sort`` of integer keys is itself an LSD radix
  sort, and every radix site sorts unique (rank, key2) or (gid, j) pairs
  or argsorts with stable ties, so the value maps to the sorts here with
  equal bytes; the one place it changes bytes, the padded lanes of the
  scatter and merge fan-outs' final sort, follows it (bwt_dev).
- ``PFBWT_DBL_INV=scatter``: the JAX package inverts each round's
  permutation by a value-carrying sort unless this says scatter; the
  port's ``_scatter_perm`` is the scatter form, and both give the same
  rank, so the value changes nothing here.
- ``PFBWT_DBL_SUBSET=N``: the subset-refinement phase of
  ``doubling_with_captures``.
"""

import os

import numpy as np
import torch

from ..constants import EndOfDict
from ..utils.timer import count, host_read
from .carry import carry_max, posrank

rounds = {"parse_sa": 0, "dict_sa": 0, "dict_sa_subset": 0}


def sort_impl() -> str:
    """``PFBWT_SORT_IMPL`` (``lax`` or ``radix``), read at call time."""
    return os.environ.get("PFBWT_SORT_IMPL", "lax").lower()


def fanout_impl() -> str:
    """``PFBWT_FANOUT``, the emission fan-out of bwt_dev.assemble_core:
    ``fill`` (the default), ``scatter`` or ``merge``; read at call
    time."""
    return os.environ.get("PFBWT_FANOUT", "fill").lower()


def subset_divisor() -> int:
    """``PFBWT_DBL_SUBSET`` (0, the default, keeps every round full
    width), read at call time."""
    return int(os.environ.get("PFBWT_DBL_SUBSET", "0"))


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


# acgt3: 16 symbols of 3 bits in one int64 key, exactly its k0
_FP_SYMS = 16


def dict_key_plan(w: int, alphabet: str = "byte"):
    """(k0, t_min, n_fp) of the dict doubling keys.

    byte:  k0 = largest power of two <= min(8, w + 1) raw bytes in one
           int64; every capture level is >= k0 (kept suffixes are longer
           than w), so no fingerprint tiers (t_min = k0, n_fp = 0).
    acgt3: the pure-ACGT dict alphabet packs 3 bits a symbol, so the
           first rank covers k0 = 16 symbols, and the capture levels
           below k0, from t_min = floor_pow2(w + 1), are exact prefix
           fingerprints sliced from the packed word (n_fp rows)."""
    if alphabet == "acgt3":
        k0 = _FP_SYMS
        tm = 1
        while tm * 2 <= min(w + 1, k0):
            tm *= 2
        return k0, tm, int(np.round(np.log2(k0) - np.log2(tm)))
    k0 = packed_dict_keys_k0(w)
    return k0, k0, 0


def _acgt3_codes(dict_flat: torch.Tensor) -> torch.Tensor:
    """Order-preserving 3-bit codes of the pure-ACGT dict alphabet: the
    separators 0, 1, 2 keep their values, A C G T become 3 4 5 6."""
    c = dict_flat.to(torch.int64)
    return torch.where(
        c <= 2, c, 3 + (c == 67) + 2 * (c == 71) + 3 * (c == 84))


def _shifted_left(b: torch.Tensor, j: int) -> torch.Tensor:
    """b[i + j], or 0 past the end."""
    out = torch.zeros_like(b)
    out[: max(b.shape[0] - j, 0)] = b[j:]
    return out


def packed_dict_keys(dict_flat: torch.Tensor, w: int,
                     alphabet: str = "byte"):
    """Initial doubling keys of the dict byte array, with every EndOfDict
    position (terminator and bucket pads) overridden by a distinct
    ascending negative, so the loop is bounded by the real suffixes' max
    LCP.  byte: k0 raw bytes packed big-endian into one int64.  acgt3:
    16 symbols of 3 bits; the same word is the fingerprint source of the
    capture levels below k0 (dict_key_plan).  Returns (keys, k0,
    fp_word), fp_word None in byte mode."""
    D = dict_flat.shape[0]
    iota = torch.arange(D, device=dict_flat.device)
    eod = dict_flat == EndOfDict
    if alphabet == "acgt3":
        k0, _, _ = dict_key_plan(w, alphabet)
        codes = _acgt3_codes(dict_flat)
        key = torch.zeros(D, dtype=torch.int64, device=dict_flat.device)
        for j in range(_FP_SYMS):
            key = (key << 3) | _shifted_left(codes, j)
        fp_word = torch.where(eod, iota - D, key)
        return fp_word, k0, fp_word
    k0 = packed_dict_keys_k0(w)
    b = dict_flat.to(torch.int64)
    key = torch.zeros(D, dtype=torch.int64, device=dict_flat.device)
    for j in range(k0):
        key = (key << 8) | _shifted_left(b, j)
    return torch.where(eod, iota - D, key), k0, None


def _floor_pow2(x: torch.Tensor) -> torch.Tensor:
    """Largest power of two <= x, elementwise (x >= 1), by bit smearing."""
    v = x.to(torch.int64)
    for s in (1, 2, 4, 8, 16, 32):
        v = v | (v >> s)
    return v - (v >> 1)


def _log2_pow2(x: torch.Tensor) -> torch.Tensor:
    """log2 of a tensor of powers of two (exact in float64)."""
    return torch.log2(x.to(torch.float64)).round().to(torch.int64)


def _posrank(cks: torch.Tensor, order: torch.Tensor, idx: torch.Tensor,
             unresolved: bool = False):
    """Positional ranks of one full-width round from its sorted keys and
    order: each position gets the sorted position of its group's head.
    Returns (rank, counts) with the counts on the device: [groups], or
    with ``unresolved`` [groups, unresolved lanes], a lane being
    unresolved while its group has another member.  The default round is
    one launch of kernel K5 on a card (carry.posrank)."""
    if not unresolved:
        return posrank(cks, order)
    n = cks.shape[0]
    changed = torch.ones(n, dtype=torch.bool, device=cks.device)
    changed[1:] = cks[1:] != cks[:-1]
    headpos = carry_max(torch.where(changed, idx, 0))
    single = changed.clone()
    single[:-1] &= changed[1:]
    counts = torch.stack((changed.sum(), n - single.sum()))
    return _scatter_perm(order, headpos), counts


def _subset_round(rank: torch.Tensor, pos_u: torch.Tensor, k: int, B: int):
    """One subset round over the unresolved positions ``pos_u`` (every
    member of every group of more than one): sort their (rank, rank[i+k])
    keys, and give each sub-group the rank of its block plus its offset
    in the block, which is its positional rank, so the ranks of the
    resolved lanes stay as they are.  Updates ``rank`` in place (only the
    live lanes are scattered) and returns the number of new groups."""
    n = rank.shape[0]
    m = pos_u.shape[0]
    sidx = torch.arange(m, device=rank.device)
    ru = rank[pos_u]
    k2p = pos_u + k
    key2 = torch.where(k2p < n, rank[torch.clamp(k2p, max=n - 1)], -1)
    cks, order = torch.sort((ru << B) | (key2 + 1), stable=True)
    pos_s = pos_u[order]
    ru_s = cks >> B
    changed = torch.ones(m, dtype=torch.bool, device=rank.device)
    changed[1:] = cks[1:] != cks[:-1]
    block = torch.ones(m, dtype=torch.bool, device=rank.device)
    block[1:] = ru_s[1:] != ru_s[:-1]
    base = carry_max(torch.where(block, sidx, 0))
    head = carry_max(torch.where(changed, sidx, 0))
    rank[pos_s] = ru_s + (head - base)
    return changed.sum() - block.sum()


def doubling_with_captures(keys: torch.Tensor, cap_len: torch.Tensor,
                           k0: int, n_levels: int = None,
                           fp_word: torch.Tensor = None, t_min: int = None):
    """Prefix doubling that also captures, for every position j, the rank
    blocks for O(1) exact substring equality (the sparse-table two-block
    test):

        t_j  = max(t_min, floor_pow2(cap_len[j]))
        C1_j = R_t[j],   C2_j = R_t[j + cap_len[j] - t_j]

    Two positions with equal cap_len are substring-equal over that length
    iff their (C1, C2) match.  ``keys`` are level-k0 keys.  Ranks are
    POSITIONAL (the sorted position of the group's head), stored per round
    in a (levels, n) table and captured after the loop.  With
    ``fp_word`` (acgt3 keys) the table's first n_fp rows hold the exact
    3-bit content of the (t_min << r)-symbol prefixes, which serve the
    levels in [t_min, k0); without it t_min is k0.  ``n_levels`` bounds
    the table height; queries past it, or past the last executed round,
    keep distinct negative sentinels.  Identity captures, as every
    caller of the JAX package's passes.

    With ``PFBWT_DBL_SUBSET=N`` (n < 2**31 - 2) rounds run full width
    only while more than max(n // N, 4096) lanes are unresolved; the
    rest sort, scan and scatter only the unresolved positions (exactly
    those, where the JAX package pads them to that bucket).  The ranks,
    the table and so (order, rank, C1, C2) are those of the full-width
    schedule.  Returns (order, rank, C1, C2)."""
    n = keys.shape[0]
    dev = keys.device
    idx = torch.arange(n, device=dev)
    narrow = n < 2**31 - 2
    B = _pack_bits(n)

    div = subset_divisor()
    use_subset = narrow and div > 0
    m_sub = max(n // div, 1 << 12) if use_subset else n

    def round_of(ck):
        """One full-width round: (rank, groups, unresolved lanes), the
        last counted only for the subset schedule (else n)."""
        cks, order = torch.sort(ck, stable=True)
        rank, counts = _posrank(cks, order, idx, use_subset)
        got = host_read(counts).tolist()
        return rank, got[0], got[1] if use_subset else n

    if fp_word is None or t_min is None:
        t_min = k0
    cap_len = cap_len.to(torch.int64)
    t = torch.clamp(_floor_pow2(torch.clamp(cap_len, min=1)), min=t_min)
    p2 = torch.clamp(idx + cap_len - t, 0, n - 1)
    log2k0 = int(np.round(np.log2(k0)))
    log2tmin = int(np.round(np.log2(t_min)))
    n_fp = log2k0 - log2tmin
    full_levels = max(_pack_bits(n) - log2k0 + 1 + n_fp, 1)
    if n_levels is None:
        n_levels = full_levels
    n_levels = max(n_fp + 1, min(n_levels, full_levels))
    # +1 trash row: rounds past the table height write there
    Rlev = torch.zeros((n_levels + 1, n), dtype=torch.int64, device=dev)
    for r in range(n_fp):
        # the prefix of t_min << r symbols, at most 24 bits, and the
        # negative EndOfDict keys shifted arithmetically: both fit the JAX
        # package's int32 table, so its narrowing changes no value
        Rlev[r] = fp_word >> (3 * (_FP_SYMS - (t_min << r)))
    rank, n_groups, n_unres = round_of(keys.to(torch.int64))
    Rlev[n_fp] = rank

    def write_row(k):
        Rlev[min(int(np.log2(k)) - log2k0 + n_fp, n_levels)] = rank

    k, nround, nsub = k0, 0, 0
    while k < n and n_groups < n and not (use_subset and n_unres <= m_sub):
        rank, n_groups, n_unres = round_of(_pair_key(rank, k))
        k *= 2
        nround += 1
        write_row(k)
    if use_subset and k < n and n_groups < n:
        rank_c = torch.clamp(rank, 0, n - 1)
        hist = torch.zeros(n, dtype=torch.int64, device=dev)
        hist.index_add_(0, rank_c, torch.ones_like(rank_c))
        pos_u = torch.nonzero(hist[rank_c] > 1).flatten()
        del rank_c, hist
        while k < n and n_groups < n:
            n_groups += int(host_read(_subset_round(rank, pos_u, k, B)))
            k *= 2
            nround += 1
            nsub += 1
            write_row(k)
    rounds["dict_sa"] = nround
    rounds["dict_sa_subset"] = nsub
    count("rounds", nround)
    lvl_q = _log2_pow2(t) - log2tmin
    ok = (lvl_q <= int(np.log2(k)) - log2k0 + n_fp) & (lvl_q < n_levels)
    lvl_c = torch.clamp(lvl_q, 0, n_levels - 1)
    sentinel = -idx - 1
    C1 = torch.where(ok, Rlev[lvl_c, idx], sentinel)
    C2 = torch.where(ok, Rlev[lvl_c, p2], sentinel)
    return torch.argsort(rank, stable=True), rank, C1, C2
