"""The whole BWT build on one device: chars -> .bwt/.sa with no host hops
between stages (the fused pipeline of pfbwtf_tpu/ops/fused.py).

  J2 parse     cut scan (kernel K1 on the card), cut compaction, phrase
               bounds, dictionary dedup by (len, two 64-bit polynomial
               substring hashes), per-occurrence metadata, and the dict
               (start, len) view in PROVISIONAL dedup order.  The phrase
               bucket is chosen speculatively from C_len/p and J2 re-runs
               at the exact bucket until it holds.
  J3 assemble  dict byte array, dict suffix sort with captures, true
               byte-lex word ranks recovered from the suffix order,
               parse-BWT, emission fan-out and the final sort -> bwt chars
               + SA values.

The char stream is built on the device too: the records' raw bytes are
copied up as they are, and padded, uppercased and checked there
(``stream_dev``).  The host reads four scalars after J2 (they size
J3's buckets, and the check's result rides with them) and the checksum
after J3; the runs are sampled on the device too, and the outputs come
back through one pinned host block (bwt_dev.bwt_result_dev).
Covers run_parser + run_pfbwt of the reference (src/pfbwt-f.cpp:209-349).
Buckets and intermediates have the JAX package's shapes, so the two can
be compared stage by stage; uint64 hash words and SA values ride in int64
with the same bits.

The port reads none of pfbwtf_tpu's engine variables (PFBWT_FANOUT,
PFBWT_SORT_IMPL, PFBWT_EMIT_WIDE, PFBWT_DICT_KEYS, PFBWT_DBL_SUBSET,
PFBWT_DBL_INV, PFBWT_J3_SPLIT, PFBWT_SCAN_IMPL, PFBWT_J2_STREAM,
PFBWT_J2_CHUNK), and under each of them the JAX package writes the
port's files.
"""

import numpy as np
import torch

from ..constants import Dollar, EndOfDict, EndOfWord
from ..utils.device import resolve_device
from ..utils.errors import die
from ..utils.tables import die_invalid, first_invalid, ntoa_codes, upper_dev
from ..utils.timer import build, count, host_read, span
from . import suffix
from .bwt_dev import (_exclusive_cumsum, _set_drop, assemble_core,
                      bwt_result_dev, dict_sort_part)
from .carry import carry_max
from .hash import cut_mask
from .parse_bwt import parse_bwt_core
from .suffix import capture_levels, compact_indices

_MASK64 = (1 << 64) - 1
_SIGN = -(1 << 63)  # int64 sign bit: flipping it orders int64 as uint64
_HB1 = 0x9E3779B97F4A7C15
_HB2 = 0xC2B2AE3D27D4EB4F


def _signed(x: int) -> int:
    """The int64 with the bits of the uint64 ``x``."""
    x &= _MASK64
    return x - (1 << 64) if x >> 63 else x


def _bucket(n: int, floor: int = 1 << 12) -> int:
    if n <= floor:
        return floor
    step = max(floor, 1 << (max(int(np.floor(np.log2(n))) - 3, 0)))
    return -(-n // step) * step


def speculative_nphrases(C_len: int, p: int) -> int:
    """Upper bound on nphrases that sizes J2's bucket without a device
    round-trip: cuts are ``hash % p == 0`` events, so ncuts is about
    Binomial(C_len, 1/p); mean + 8 sigma + a flat pad.  Adversarial inputs
    overflow it, and the driver re-runs at the exact bucket."""
    exp = C_len / max(p, 1)
    return int(exp + 8.0 * exp**0.5 + 4096.0)


def _lexsort(keys):
    """Stable lexicographic order; the LAST key is primary (jnp.lexsort)."""
    order = torch.argsort(keys[0], stable=True)
    for key in keys[1:]:
        order = order[torch.argsort(key[order], stable=True)]
    return order


# --------------------------------------------------------------------------
# J2: parse + dictionary dedup
# --------------------------------------------------------------------------


def _inv_pow_at(base: int, s, tb: int):
    """base^-s mod 2**64 at the positions ``s`` (0 <= s < tb), by binary
    exponentiation over the bits of s."""
    ipow = pow(int(base), -1, 1 << 64)
    inv_s = torch.ones_like(s)
    for j in range(max(int(np.ceil(np.log2(tb + 1))), 1)):
        sq = _signed(pow(ipow, 1 << j, 1 << 64))
        inv_s = torch.where(((s >> j) & 1) == 1, inv_s * sq, inv_s)
    return inv_s


def _powers(base: int, n: int, device):
    """base^j mod 2**64 for j < n, as int64."""
    b = torch.full((n,), _signed(base), dtype=torch.int64, device=device)
    b[0] = 1
    return torch.cumprod(b, 0)


def _substring_hashes_dev(Tp, starts, lens, base: int):
    """Polynomial hash of Tp[s:s+l] per (s, l), mod 2**64:
    (G[s] - G[e]) * base^-s with G[i] = sum_{j>=i} c_j base^j.  int64
    cumprod / cumsum / multiply wrap mod 2**64 as the uint64 ones do."""
    c = Tp.to(torch.int64)
    tb = c.shape[0]
    powers = _powers(base, tb, Tp.device)
    G = torch.zeros(tb + 1, dtype=torch.int64, device=Tp.device)
    G[:tb] = torch.cumsum((c * powers).flip(0), 0).flip(0)
    del powers
    s = torch.clamp(starts, 0, tb - 1)
    e = torch.clamp(starts + lens, 0, tb)
    return (G[s] - G[e]) * _inv_pow_at(base, s, tb)


def _phrase_bounds(cuts, ncuts, C_len: int, w: int):
    """Phrase k spans [starts[k], ends[k]] of T' (phrases overlap by w);
    lanes past nphrases = ncuts + 1 are invalid with length 0.  Returns
    (k, valid, starts, lens, ends)."""
    k = torch.arange(cuts.shape[0], device=cuts.device)
    valid = k <= ncuts
    ends = torch.where(k < ncuts, cuts + 1, C_len + w)
    starts = torch.zeros_like(ends)
    starts[1:] = ends[:-1] - w + 1
    lens = torch.where(valid, ends - starts + 1, 0)
    return k, valid, starts, lens, ends


def _dedup_state(Tp, k, valid, starts, lens, ends, h1, h2, ncuts, w: int):
    """Dict dedup by (len, h1, h2) and the per-occurrence metadata: the J2
    state (Tp, parse_ranks, occs, dict_start, dict_len, last, sai, meta)
    with meta = [ncuts, D, dict_total, max dict_len]."""
    dev = Tp.device
    nph_b = k.shape[0]
    tb = Tp.shape[0]
    # sign-flipped hashes sort as uint64
    key_l = torch.where(valid, lens, -1 - k)  # invalid lanes: distinct
    order = _lexsort((h2 ^ _SIGN, h1 ^ _SIGN, key_l, (~valid).to(torch.int64)))
    l_o, h1_o, h2_o, v_o = key_l[order], h1[order], h2[order], valid[order]
    head = torch.ones(nph_b, dtype=torch.bool, device=dev)
    head[1:] = (
        (l_o[1:] != l_o[:-1]) | (h1_o[1:] != h1_o[:-1]) | (h2_o[1:] != h2_o[:-1])
    )
    gid_sorted = torch.cumsum(head, 0) - 1
    D = (head & v_o).sum()  # valid groups come first
    gid = torch.empty_like(gid_sorted)
    gid[order] = gid_sorted
    # representative (first-in-sorted) start/len per group: one head per
    # group and zeros elsewhere, so an add is a set
    rep_start = torch.zeros(nph_b, dtype=torch.int64, device=dev)
    rep_start.index_add_(0, gid_sorted, torch.where(head, starts[order], 0))
    rep_len = torch.zeros(nph_b, dtype=torch.int64, device=dev)
    rep_len.index_add_(0, gid_sorted, torch.where(head, lens[order], 0))
    group_counts = torch.zeros(nph_b, dtype=torch.int64, device=dev)
    group_counts.index_add_(0, gid, valid.to(torch.int64))

    # dict views stay in provisional (dedup-sorted) order; J3 recovers the
    # byte-lex word ranks from the dict suffix sort
    rep_valid = k < D
    dict_start = rep_start * rep_valid
    dict_len = rep_len * rep_valid
    occs = group_counts * rep_valid
    parse_ranks = torch.where(valid, torch.clamp(gid, 0, nph_b - 1) + 1, 0)
    last = torch.where(valid, Tp[torch.clamp(ends - w, 0, tb - 1)], 0)
    sai = torch.where(valid, ends, 0)
    dict_total = dict_len.sum() + D + 1
    meta = torch.stack((ncuts, D, dict_total, dict_len.max()))
    return Tp, parse_ranks, occs, dict_start, dict_len, last, sai, meta


def _parse_core(chars_p, C_len: int, w: int, p: int, nph_b: int):
    """Cut scan + compaction + phrase bounds + dict dedup + occurrence
    metadata.  Returns (Tp, parse_ranks, occs, dict_start, dict_len, last,
    sai, meta) with meta = [ncuts, D, dict_total, max dict_len]; valid
    only when ncuts + 1 <= nph_b."""
    dev = chars_p.device
    n_b = chars_p.shape[0]
    cut = cut_mask(ntoa_codes(chars_p), w, p)
    cut &= torch.arange(n_b, device=dev) < C_len
    ncuts = cut.sum()

    # T' = Dollar + C + Dollar*w (pads of chars_p beyond C_len -> Dollar)
    tb = n_b + w + 1
    Tp = torch.full((tb,), Dollar, dtype=torch.uint8, device=dev)
    Tp[1: C_len + 1] = chars_p[:C_len]

    cuts = compact_indices(cut, nph_b, fill=n_b)
    del cut
    k, valid, starts, lens, ends = _phrase_bounds(cuts, ncuts, C_len, w)
    h1 = torch.where(valid, _substring_hashes_dev(Tp, starts, lens, _HB1), 0)
    h2 = torch.where(valid, _substring_hashes_dev(Tp, starts, lens, _HB2), 0)
    return _dedup_state(Tp, k, valid, starts, lens, ends, h1, h2, ncuts, w)


# --------------------------------------------------------------------------
# J2 streamed: for inputs past the monolithic J2's memory ceiling
# --------------------------------------------------------------------------


def speculative_chunk_phrases(L: int, p: int) -> int:
    """Phrase window of one chunk of the streamed J2 (the bound of
    speculative_nphrases over one chunk's positions)."""
    exp = L / max(p, 1)
    return _bucket(int(exp + 8.0 * exp**0.5 + 4096.0))


def _parse_core_stream(chars_p, C_len: int, w: int, p: int, nph_b: int,
                       n_chunks: int, m_max: int):
    """Streamed J2: the state of _parse_core, with meta gaining a 5th
    scalar, the most phrase starts (or ends) in one chunk.  Only chunk-
    (Lc, Lh) and phrase-sized (nph_b) arrays are ever 64 bits wide:

    - pass A compacts the cut positions chunk by chunk, a running count
      carried on the device;
    - pass B computes the forward prefix F[i] = sum_{j<i} c_j base^j of T'
      chunk by chunk, carrying (F, base^chunk_start), and samples it only
      at the phrase starts and ends inside the chunk: phrases are in
      position order, so those form the index window [lo[kc], lo[kc+1]),
      read at its first m_max lanes.

    h(s, e) = (F[e] - F[s]) * base^-s equals the monolithic
    (G[s] - G[e]) * base^-s, so the dedup keys are bit-identical.  The
    chunk grid is the JAX package's, so meta[4] is too.  The state is
    valid only when ncuts + 1 <= nph_b and meta[4] <= m_max."""
    dev = chars_p.device
    n_b = chars_p.shape[0]
    cut = cut_mask(ntoa_codes(chars_p), w, p)
    cut[C_len:] = False
    tb = n_b + w + 1
    Tp = torch.full((tb,), Dollar, dtype=torch.uint8, device=dev)
    Tp[1: C_len + 1] = chars_p[:C_len]

    # pass A; cut positions past the bucket go to a spare slot, cut off.
    # Its running count ends as ncuts: a sum over the whole mask would
    # first copy it to int64
    Lc = -(-n_b // n_chunks)
    cuts = torch.full((nph_b + 1,), n_b, dtype=torch.int64, device=dev)
    cnt = torch.zeros((), dtype=torch.int64, device=dev)
    for lo in range(0, n_b, Lc):
        cm = cut[lo: lo + Lc]
        slot = cnt + torch.cumsum(cm, 0) - 1
        cnt = slot[-1] + 1
        slot = torch.where(cm & (slot < nph_b), slot, nph_b)
        cuts.scatter_(0, slot, torch.arange(lo, lo + cm.shape[0], device=dev))
    del cut, cm, slot
    ncuts = cnt
    k, valid, starts, lens, ends = _phrase_bounds(cuts[:nph_b], ncuts, C_len, w)

    # pass B; tb + 1 positions, since the last phrase ends at tb itself,
    # and a chunk length rounded to the JAX package's 2**15 grid
    Lh = -(-(tb + 1) // n_chunks)
    Lh = -(-Lh // (1 << 15)) * (1 << 15)
    s_cl = torch.clamp(starts, 0, tb - 1)
    e_cl = torch.clamp(starts + lens, 0, tb)
    grid = torch.arange(n_chunks + 1, device=dev) * Lh
    # invalid lanes sort past every grid point, so no window counts them
    sent = 1 << 62
    lo_s = torch.searchsorted(torch.where(valid, s_cl, sent), grid)
    lo_e = torch.searchsorted(torch.where(valid, e_cl, sent), grid)
    m_over = torch.maximum((lo_s[1:] - lo_s[:-1]).max(),
                           (lo_e[1:] - lo_e[:-1]).max())
    lo_s, lo_e = host_read(torch.stack((lo_s, lo_e))).tolist()  # one read
    pad = torch.zeros(m_max, dtype=torch.int64, device=dev)
    s_q, e_q = torch.cat((s_cl, pad)), torch.cat((e_cl, pad))
    hashes = []
    for base in (_HB1, _HB2):
        pw = _powers(base, Lh, dev)
        step = _signed(pow(base, Lh, 1 << 64))
        F = torch.zeros((), dtype=torch.int64, device=dev)
        bp = torch.ones((), dtype=torch.int64, device=dev)
        Gs = torch.zeros(nph_b + m_max, dtype=torch.int64, device=dev)
        Ge = torch.zeros_like(Gs)
        for kc in range(n_chunks):
            c = torch.full((Lh,), Dollar, dtype=torch.int64, device=dev)
            seg = Tp[kc * Lh: (kc + 1) * Lh]
            c[: seg.shape[0]] = seg
            t = c * pw
            cs = torch.cumsum(t, 0)
            ex = cs - t  # F inside the chunk, exclusive
            for lo, q, G in ((lo_s[kc], s_q, Gs), (lo_e[kc], e_q, Ge)):
                # lo <= nph_b and q, G hold nph_b + m_max lanes: the window
                # never runs short, as the JAX dynamic_slice never clamps
                j = q[lo: lo + m_max] - kc * Lh
                ok = (j >= 0) & (j < Lh)
                v = F + bp * ex[torch.clamp(j, 0, Lh - 1)]
                G[lo: lo + m_max] = torch.where(ok, v, G[lo: lo + m_max])
            F = F + bp * cs[-1]
            bp = bp * step
        del pw, c, t, cs, ex
        h = (Ge[:nph_b] - Gs[:nph_b]) * _inv_pow_at(base, s_cl, tb)
        hashes.append(torch.where(valid, h, 0))
    state = _dedup_state(Tp, k, valid, starts, lens, ends, *hashes, ncuts, w)
    return (*state[:-1], torch.cat((state[-1], m_over.reshape(1))))


def _rerun_until_held(j2, nph_b: int, m_max: int = 0, check=None):
    """Run ``j2(nph_b, m_max)`` at the speculative buckets and again at
    the exact ones until its state holds: ncuts + 1 <= nph_b and, for the
    streamed J2, meta[4] <= m_max.  Both are checked on every run, since
    a run whose phrase bucket overflowed counted meta[4] over truncated
    cuts.  ``check``, the input's utils/tables.first_invalid pair, is
    read with the first run's sizes, and an invalid byte dies before any
    size is judged.  Returns (state, [ncuts, D, dict_total, max_len],
    runs)."""
    runs = 0
    while True:
        with span("j2.run"):
            state = j2(nph_b, m_max)
        runs += 1
        with span("j2.sizes_read"):
            meta = state[-1]
            if check is not None:
                meta = torch.cat((meta, check))
            meta = host_read(meta).tolist()
        if check is not None:
            meta, (bad, byte) = meta[:-2], meta[-2:]
            if bad:
                die_invalid(byte)
            check = None
        ncuts = meta[0]
        m_over = meta[4] if len(meta) > 4 else 0
        if ncuts == 0:
            die("error: only one dict word total. "
                "Re-run with a smaller p modulus")
        if ncuts + 1 <= nph_b and m_over <= m_max:
            return state, meta[:4], runs
        nph_b = _bucket(max(ncuts + 1, nph_b))
        m_max = max(m_max, _bucket(m_over))


def run_parse(chars, C_len: int, w: int, p: int, nph_b: int, check=None):
    """The monolithic J2 until its phrase bucket holds; ``check`` as
    _rerun_until_held's."""
    return _rerun_until_held(
        lambda nb, _: _parse_core(chars, C_len, w, p, nb), nph_b,
        check=check)


def run_parse_stream(chars, C_len: int, w: int, p: int, nph_b: int,
                     chunk_target: int = 32 << 20):
    """The streamed J2 over chunks of about ``chunk_target`` positions,
    until its phrase bucket and its per-chunk phrase window hold."""
    n_b = chars.shape[0]
    n_chunks = max(-(-n_b // chunk_target), 1)
    return _rerun_until_held(
        lambda nb, mm: _parse_core_stream(chars, C_len, w, p, nb, n_chunks,
                                          mm),
        nph_b, speculative_chunk_phrases(-(-n_b // n_chunks), p))


# --------------------------------------------------------------------------
# J3: dict bytes + parse-BWT + assembly
# --------------------------------------------------------------------------


def _j3_prep_core(Tp, parse_ranks, occs, dict_start, dict_len, last, sai,
                  nphrases: int, D: int, dict_total: int, w: int,
                  dict_b: int, n_levels: int = None):
    """Dict byte array, dict suffix sort with captures, true word-rank
    recovery, parse-BWT, and the ilist segment starts permuted to the
    provisional word order.  Returns
    (dict_flat, sorted_state, bwlast, ilist, bwsai, seg_prov)."""
    dev = Tp.device
    nph_b = parse_ranks.shape[0]
    tb = Tp.shape[0]
    r = torch.arange(nph_b, device=dev)
    pidx = torch.arange(dict_b, device=dev)
    with span("j3.dict_flat"):
        # word r spans [bounds[r]-contrib[r], bounds[r]) with its
        # EndOfWord at bounds[r]-1; EndOfDict terminator and zero pads
        # after.  Word of each position: word ids scattered at word
        # starts + cummax.
        contrib = torch.where(r < D, dict_len + 1, 0)
        wstart = torch.cumsum(contrib, 0) - contrib
        mark = _set_drop(dict_b, torch.where(r < D, wstart, dict_b), r + 1,
                         dev)
        word = torch.clamp(carry_max(mark) - 1, 0, nph_b - 1)
        within = pidx - wstart[word]
        src = torch.clamp(dict_start[word] + within, 0, tb - 1)
        ch = torch.where(within < dict_len[word], Tp[src], EndOfWord)
        dict_flat = torch.where(pidx < dict_total - 1, ch, EndOfDict)
        del mark, word, within, src, ch

    with span("j3.dict_sort"):
        ss = dict_sort_part(dict_flat, w, n_levels=n_levels)
    with span("j3.ranks_bwt"):
        # word-start suffixes appear in SA order in byte-lex word order
        # (prefix-free), which recovers the true ranks
        sa_all, word_id = ss[0], ss[4]
        prev_sep0 = torch.ones(dict_b, dtype=torch.bool, device=dev)
        prev_sep0[1:] = dict_flat[:-1] <= 1
        is_wstart = prev_sep0 & (pidx < dict_total - 1)
        wsa = compact_indices(is_wstart[sa_all], nph_b, fill=0)
        prov_in_lex = word_id[torch.clamp(sa_all[wsa], 0, dict_b - 1)]
        lex_valid = r < D
        prov_c = torch.clamp(prov_in_lex, 0, nph_b - 1)
        lex_of_prov = _set_drop(nph_b, torch.where(lex_valid, prov_c, nph_b),
                                r, dev)
        ranks_true = torch.where(
            parse_ranks > 0,
            lex_of_prov[torch.clamp(parse_ranks - 1, 0, nph_b - 1)] + 1,
            0,
        )
        bwlast, ilist, bwsai, _ = parse_bwt_core(ranks_true, last, sai,
                                                 nphrases)
        # ilist segment starts live in lex rank space; permute them to the
        # provisional word ids the dict (and its suffixes' word_id) carry
        occs_lex = torch.where(lex_valid, occs[prov_c], 0)
        seg_lex = 1 + _exclusive_cumsum(occs_lex)
        seg_prov = seg_lex[torch.clamp(lex_of_prov, 0, nph_b - 1)]
    return dict_flat, ss, bwlast, ilist, bwsai, seg_prov


def _final_core(Tp, parse_ranks, occs, dict_start, dict_len, last, sai,
                nphrases: int, D: int, dict_total: int, nsuf_true: int,
                total_true: int, w: int, dict_b: int, nsuf_b: int,
                total_b: int, n_levels: int = None):
    """J3 -> (bwt chars, SA values, checksum).  The checksum is the
    wrapping uint64 sum of both padded buffers, as an int64 tensor."""
    prep = _j3_prep_core(
        Tp, parse_ranks, occs, dict_start, dict_len, last, sai,
        nphrases, D, dict_total, w, dict_b, n_levels=n_levels,
    )
    with span("j3.emit"):
        return _j3_emit_core(*prep, occs, nsuf_true, total_true, w, nsuf_b,
                             total_b)


def _j3_emit_core(dict_flat, ss, bwlast, ilist, bwsai, seg_prov, occs,
                  nsuf_true: int, total_true: int, w: int, nsuf_b: int,
                  total_b: int):
    """The emission half of J3 over _j3_prep_core's outputs: fan-out,
    final sort and decode -> (bwt chars, SA values, checksum)."""
    bwtc, sa_vals = assemble_core(
        dict_flat, occs, bwlast, ilist, bwsai, nsuf_true, total_true,
        w, nsuf_b, total_b, sorted_state=ss, seg_start=seg_prov,
    )
    checksum = bwtc.to(torch.int64).sum() + sa_vals.sum()
    return bwtc, sa_vals, checksum


# --------------------------------------------------------------------------
# the state carried from J2 to J3, as numpy arrays
# --------------------------------------------------------------------------

_STATE_DTYPES = (
    torch.uint8, torch.int64, torch.int64, torch.int64, torch.int64,
    torch.uint8, torch.int64, torch.int64,
)


def parse_state_from_numpy(arrays, device):
    """J2's output tuple (Tp, parse_ranks, occs, dict_start, dict_len,
    last, sai, meta) from numpy arrays (as the JAX package returns them:
    uint64 sai is reinterpreted as int64) to the port's tensors."""
    out = []
    for a, dt in zip(arrays, _STATE_DTYPES):
        a = np.array(a)  # a writable copy (JAX hands out read-only views)
        if a.dtype == np.uint64:
            a = a.view(np.int64)
        out.append(torch.from_numpy(a).to(device, dt))
    return tuple(out)


def parse_state_to_numpy(state):
    """The inverse of parse_state_from_numpy, in the JAX package's dtypes
    (sai as uint64)."""
    out = [t.cpu().numpy() for t in state]
    out[6] = out[6].view(np.uint64)
    return tuple(out)


# --------------------------------------------------------------------------
# host driver
# --------------------------------------------------------------------------


def _stage(seqs, w: int, n_b: int, dev):
    """The padded char stream on ``dev``: the bytes of each of ``seqs``
    followed by ``w`` 'A's (pfparser.hpp:333-337), then 'A' up to ``n_b``
    bytes.  Each array is copied from its own host memory into its slice
    without blocking: CUDA stages pageable memory before the copy
    returns, overlapping the host's read with the transfer.  The pads are
    filled in one launch from their offsets and the tail in another, so
    no fill grows with the number of records."""
    chars = torch.empty(n_b, dtype=torch.uint8, device=dev)
    ends, off = [], 0
    for seq in seqs:
        n = seq.shape[0]
        # a read-only array is copied once: torch takes writable memory
        src = torch.from_numpy(np.require(seq, requirements="W"))
        chars[off: off + n].copy_(src, non_blocking=True)
        ends.append(off + n)
        off += n + w
    pads = (np.asarray(ends, dtype=np.int64)[:, None] + np.arange(w)).ravel()
    chars.index_fill_(0, torch.from_numpy(pads).to(dev, non_blocking=True),
                      ord("A"))
    chars[off:].fill_(ord("A"))
    return chars


def stream_dev(seqs, params, n_b: int, dev):
    """build_stream on the device: [chars, check], ``chars`` the char
    stream of the records' bytes ``seqs`` (uint8 arrays), uppercased,
    with ``params.non_acgt_to_a`` replaced, and padded to ``n_b`` bytes;
    ``check`` its utils/tables.first_invalid pair, unread."""
    chars = _stage(seqs, params.w, n_b, dev)
    upper_dev(chars, params.non_acgt_to_a)
    count("stream_dev")
    return [chars, first_invalid(chars)]


def pfbwt_fused_device(C: np.ndarray, w: int, p: int, want_sa: bool = False,
                       want_rssa: bool = False, sa_dtype=np.uint64,
                       device="cuda"):
    """Whole-pipeline run over the padded char stream C on ``device``.

    Returns ``(BWTResult, info)``.  ``info`` holds the sizes, the doubling
    round counts, the checksum and the seconds of its stage spans
    (utils/timer): host_s (``host_prep``: sizing, and C's upload padded to
    its bucket with its check launched), j2_s (``j2``: J2, ending in the
    host read of its sizes and the check), j3_s (``j3``: J3, ending in the
    checksum read) and fetch_s (``fetch``: sample_s, the run-length
    sampling on the device, + download_s, the outputs' copy to pinned host
    memory: bwt_dev.bwt_result_dev); as the outermost entry point also
    spans, counts and build_id."""
    info = {}
    with build(info):
        dev = resolve_device(device)
        with span("host_prep") as host:
            C_len = int(C.shape[0])
            chars = _stage([C], 0, _bucket(max(C_len, 1), 1 << 16), dev)
            staged = [chars, first_invalid(chars)]
            del chars
        info["host_s"] = host.seconds
        res = _fused_from_chars(staged, C_len, w, p, want_sa, want_rssa,
                                sa_dtype, info)
    return res, info


def _fused_from_chars(staged, C_len: int, w: int, p: int, want_sa: bool,
                      want_rssa: bool, sa_dtype, info: dict):
    """J2, J3 and the fetch from the device chars on, inside an open
    build; ``staged`` is [chars, check] and is emptied, so that the chars
    are freed before J3.  ``info`` receives the keys of
    pfbwt_fused_device but host_s."""
    chars, check = staged
    staged.clear()
    n_b = chars.shape[0]
    # text length incl. per-record pads (pfparser.hpp:529-532)
    n = C_len
    with span("j2") as j2:
        state, (ncuts, D, dict_total, max_len), j2_runs = run_parse(
            chars, C_len, w, p, _bucket(speculative_nphrases(C_len, p)),
            check)
        nph_b = state[1].shape[0]

    with span("j3") as j3:
        del chars, check
        nphrases = ncuts + 1
        n_levels = capture_levels(max_len, w)
        nsuf = (dict_total - 1 - D) - D * w
        total = n + 1
        dict_b, nsuf_b = _bucket(dict_total), _bucket(nsuf)
        total_b = _bucket(total)
        bwt_d, sa_d, checksum_d = _final_core(
            *state[:-1], nphrases, D, dict_total, nsuf, total, w,
            dict_b, nsuf_b, total_b, n_levels=n_levels,
        )
        del state
        with span("j3.checksum_read"):
            checksum = int(host_read(checksum_d)) & _MASK64
    info.update({
        "n": n, "n_b": n_b, "nphrases": nphrases, "nph_b": nph_b,
        "D": D, "dict_total": dict_total, "dict_b": dict_b, "nsuf": nsuf,
        "n_levels": n_levels, "j2_runs": j2_runs, "j2_s": j2.seconds,
        "j3_s": j3.seconds, "checksum": checksum,
        "rounds": dict(suffix.rounds),
    })
    with span("fetch") as fetch:
        res = bwt_result_dev(bwt_d, sa_d, total, n, want_sa, want_rssa,
                             sa_dtype, info=info)
    info.update(r=res.nruns, fetch_s=fetch.seconds)
    return res


def pfbwt_fused_records(records, params, device="cuda", want_sa=False,
                        want_rssa=False, sa_dtype=np.uint64):
    """Fused run over FASTA records: the char stream built on the device
    (stream_dev), then the build of pfbwt_fused_device from the device
    chars on.  ``info`` as pfbwt_fused_device's, host_s (``host_prep``)
    being the sizing alone, and stream_s (``stream``: the bytes' copy to
    the device and the launches that normalize and check them)."""
    info = {}
    with build(info):
        dev = resolve_device(device)
        with span("host_prep") as host:
            seqs = [np.asarray(seq, dtype=np.uint8) for _, seq in records]
            C_len = sum(seq.shape[0] for seq in seqs) + params.w * len(seqs)
            n_b = _bucket(max(C_len, 1), 1 << 16)
        with span("stream") as stream:
            staged = stream_dev(seqs, params, n_b, dev)
        info.update(host_s=host.seconds, stream_s=stream.seconds)
        res = _fused_from_chars(staged, C_len, params.w, params.p, want_sa,
                                want_rssa, sa_dtype, info)
    return res, info
