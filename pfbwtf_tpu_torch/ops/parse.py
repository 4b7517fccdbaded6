"""Host side of the prefix-free parse: parameters, the char stream, phrase
bounds, and the dictionary dedup + ranking of the staged build.

1. C = concat(upper(record) [+ non-ACGT->A] + 'A'*w): every FASTA record
   is padded with w 'A's (pfparser.hpp:333-337).  The device parse
   (ops/fused.py, engine.parse_stream) works on C; the fused build over
   records makes the same bytes on the device (ops/fused.stream_dev).
2. T' = Dollar + C + Dollar*w (pfparser.hpp:316-318, 485-488).  Phrase j
   spans T'[s_j..e_j] with e_j = cut_k + 1 in T' coordinates and
   s_{j+1} = e_j - w + 1 (phrases overlap by w chars).
3. Dictionary = byte-lex sorted unique phrases; ranks are 1-based
   (pfparser.hpp:504-517); per occurrence last_j = T'[e_j - w]
   (pfparser.hpp:599) and sai_j = e_j (pfparser.hpp:600).

The dedup (``_dedup_and_rank``) runs on the device
(parallel/dict_union.dedup_rank_device) or on the host: the native
rank_substrings kernel where it builds, else (len, 128-bit substring
hash) dedup and an 8-byte-chunk radix word sort in numpy.
``finalize_parse`` reads PFBWT_DICT_IMPL at each call, as pfbwtf_tpu's
dedup does: ``host`` or ``numpy`` moves a device dedup to the host, any
other value (``jax``) or none leaves it on the device (pfbwtf_tpu's
unset default is the host; a local card has no tunnel to spare).
"""

import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..constants import DEFAULT_P, DEFAULT_W, Dollar, EndOfDict, EndOfWord, MAX_W
from ..utils.errors import die
from ..utils.limits import check_phrase_count
from ..utils.tables import NT4_TABLE, UPPER_TABLE


@dataclass
class ParserParams:
    """Mirrors pfbwtf::PfParserParams (pfparser.hpp:30-44)."""

    w: int = DEFAULT_W
    p: int = DEFAULT_P
    get_sai: bool = False
    store_docs: bool = False
    verbose: bool = False
    trim_non_acgt: bool = False
    non_acgt_to_a: bool = False

    def __post_init__(self):
        if self.w > MAX_W:
            die("window size w must be < 32!")


@dataclass
class ParseResult:
    """Finalized parse: dictionary + occurrence metadata.

    The dictionary is a flat view, (text, dict_starts, dict_lens), never a
    Python list of phrases.  ``text`` is T' and may be a read-only memmap
    (the chunked parse), so phrase bytes are paged on demand.
    """

    params: ParserParams
    text: np.ndarray  # T', uint8 (possibly memmap)
    dict_starts: np.ndarray  # int64 word start in text, byte-lex dict order
    dict_lens: np.ndarray  # int64 word length, dict order
    occs: np.ndarray  # per-phrase occurrence counts, dict order
    parse_ranks: np.ndarray  # 1-based ranks, text order (uint32)
    last: np.ndarray  # uint8, per occurrence
    sai: np.ndarray  # uint64 phrase end positions, per occurrence
    doc_names: List[str] = field(default_factory=list)
    doc_starts: List[int] = field(default_factory=list)
    pos: int = 0  # total chars incl. sentinels (pfparser.hpp:614)
    nseqs: int = 0

    @property
    def n(self) -> int:
        """Text length incl. per-record 'A' pads, excl. Dollar sentinels
        (pfparser.hpp:529-532)."""
        return self.pos - self.params.w if self.pos >= self.params.w else 0

    def iter_dict_chunks(self, chunk_bytes: int = 1 << 23):
        """Yield the .dict byte stream (sorted words + EndOfWord each, then
        EndOfDict) as uint8 slabs of about ``chunk_bytes`` bytes
        (pfbwt_io.hpp:71-82); a slab's index arrays scale with its bytes,
        not with its word count."""
        starts = np.asarray(self.dict_starts, dtype=np.int64)
        lens = np.asarray(self.dict_lens, dtype=np.int64)
        D = starts.shape[0]
        cum = np.cumsum(lens + 1)
        lo = 0
        while lo < D:
            base = int(cum[lo - 1]) if lo else 0
            hi = int(np.searchsorted(cum, base + chunk_bytes, side="right"))
            hi = min(max(hi, lo + 1), D)
            s = starts[lo:hi]
            l = lens[lo:hi]
            bounds = cum[lo:hi] - base
            out_len = int(bounds[-1])
            idx = np.arange(out_len, dtype=np.int64)
            word = np.searchsorted(bounds, idx, side="right")
            wstart = bounds - (l + 1)
            within = idx - wstart[word]
            src = s[word] + np.minimum(within, np.maximum(l[word] - 1, 0))
            out = np.asarray(self.text[src], dtype=np.uint8)
            out[bounds - 1] = EndOfWord
            yield out
            lo = hi
        yield np.array([EndOfDict], dtype=np.uint8)

    def dict_flat(self) -> np.ndarray:
        """The .dict byte array (separators included)."""
        return np.concatenate(list(self.iter_dict_chunks()))


def normalize_records(
    records: Sequence[Tuple[str, np.ndarray]], params: ParserParams
) -> List[Tuple[str, np.ndarray]]:
    """toupper + optional non-ACGT->'A' (pfparser.hpp:337-344)."""
    out = []
    for name, seq in records:
        seq = UPPER_TABLE[np.asarray(seq, dtype=np.uint8)]
        if params.non_acgt_to_a:
            seq = np.where(NT4_TABLE[seq] > 3, np.uint8(ord("A")), seq)
        out.append((name, seq))
    return out


def build_stream(
    records: Sequence[Tuple[str, np.ndarray]], params: ParserParams
):
    """Concatenate normalized records, each padded with w 'A's.

    Returns (C, doc_names, doc_starts); doc_starts[r] is the offset of
    record r inside C (pfparser.hpp:321-324).
    """
    records = normalize_records(records, params)
    pad = np.full(params.w, ord("A"), dtype=np.uint8)
    chunks = []
    doc_names: List[str] = []
    doc_starts: List[int] = []
    off = 0
    for name, seq in records:
        doc_names.append(name)
        doc_starts.append(off)
        chunks.append(seq)
        chunks.append(pad)
        off += seq.shape[0] + params.w
    C = np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.uint8)
    return C, doc_names, doc_starts


def phrase_bounds_from_cuts(C_len: int, cuts: np.ndarray, w: int):
    """Phrase (start, end) pairs in T' coordinates.  ``cuts`` holds the
    stream positions k (0-based in C) after which a phrase ends; char k of
    C sits at T' index k+1."""
    ends = np.empty(cuts.shape[0] + 1, dtype=np.int64)
    ends[:-1] = cuts + 1
    ends[-1] = C_len + w  # the final phrase ends at the last trailing Dollar
    starts = np.empty_like(ends)
    starts[0] = 0
    starts[1:] = ends[:-1] - w + 1
    return starts, ends


def _tprime(C: np.ndarray, w: int) -> np.ndarray:
    return np.concatenate(
        (
            np.array([Dollar], dtype=np.uint8),
            C,
            np.full(w, Dollar, dtype=np.uint8),
        )
    )


_HB1 = np.uint64(0x9E3779B97F4A7C15)
_HB2 = np.uint64(0xC2B2AE3D27D4EB4F)
_HASH_CHUNK_LIMIT = 1 << 26  # 64 MB


def _substring_hashes(T: np.ndarray, starts, lens, base):
    """Polynomial hash of T[s:s+l] per (s, l), mod 2**64, via prefix sums.
    Above _HASH_CHUNK_LIMIT chars the chunked form runs: the one-shot form
    holds three text-length uint64 arrays (24 bytes a char)."""
    n = T.shape[0]
    if n > _HASH_CHUNK_LIMIT:
        return _substring_hashes_chunked(T, starts, lens, base)
    c = T.astype(np.uint64)
    b = np.full(n, base, dtype=np.uint64)
    b[0] = np.uint64(1)
    powers = np.multiply.accumulate(b)
    G = np.zeros(n + 1, dtype=np.uint64)
    G[:n] = (c * powers)[::-1].cumsum(dtype=np.uint64)[::-1]
    inv = np.uint64(pow(int(base), -1, 1 << 64))
    binv = np.full(n, inv, dtype=np.uint64)
    binv[0] = np.uint64(1)
    inv_powers = np.multiply.accumulate(binv)
    s = np.asarray(starts, dtype=np.int64)
    return (G[s] - G[s + np.asarray(lens, dtype=np.int64)]) * inv_powers[s]


def _pow_u64(base: int, exp: np.ndarray) -> np.ndarray:
    """base**exp mod 2**64, by square-and-multiply over the exponent
    array's bits."""
    e = np.asarray(exp, dtype=np.uint64)
    acc = np.ones(e.shape[0], dtype=np.uint64)
    b = int(base) & 0xFFFFFFFFFFFFFFFF
    nbits = int(e.max(initial=0)).bit_length()
    for bit in range(nbits):
        mask = ((e >> np.uint64(bit)) & np.uint64(1)).astype(bool)
        acc = np.where(mask, acc * np.uint64(b), acc)
        b = (b * b) & 0xFFFFFFFFFFFFFFFF
    return acc


def _substring_hashes_chunked(T, starts, lens, base, chunk: int = 1 << 24):
    """The hashes of _substring_hashes with O(chunk + nphrases) memory:
    one backward pass over text chunks carries the suffix accumulator G
    and samples it at the query positions; B^{-s} comes from binary
    exponentiation.  T may be a memmap; each chunk is touched once."""
    n = T.shape[0]
    s = np.asarray(starts, dtype=np.int64)
    e = s + np.asarray(lens, dtype=np.int64)
    q = np.concatenate((s, e))
    Gq = np.zeros(q.shape[0], dtype=np.uint64)
    acc = np.uint64(0)  # G[hi] of the chunk being entered
    first_lo = ((n - 1) // chunk) * chunk if n else 0
    for lo in range(first_lo, -1, -chunk):
        hi = min(lo + chunk, n)
        m = hi - lo
        c = np.asarray(T[lo:hi], dtype=np.uint64)
        pw = np.full(m, base, dtype=np.uint64)
        pw[0] = np.uint64(pow(int(base), lo, 1 << 64))
        np.multiply.accumulate(pw, out=pw)
        Gc = (c * pw)[::-1].cumsum(dtype=np.uint64)[::-1]
        Gc += acc
        sel = (q >= lo) & (q < hi)
        Gq[sel] = Gc[q[sel] - lo]
        acc = Gc[0] if m else acc
    inv = pow(int(base), -1, 1 << 64)
    inv_s = _pow_u64(inv, s)
    nph = s.shape[0]
    return (Gq[:nph] - Gq[nph:]) * inv_s


def _dedup_and_rank(T: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                    device=None, info: dict = None):
    """Phrase dedup + byte-lex ranking: (dict_starts, dict_lens, occs,
    1-based rank of each occurrence), the dictionary a flat (start, len)
    view into T.

    With ``device`` the dedup runs there (parallel/dict_union.
    dedup_rank_device).  Without, it runs on the host: the native
    rank_substrings kernel where it builds, else (len, 128-bit substring
    hash) dedup and an 8-byte-chunk radix word sort in numpy.  The
    chunked parse takes the host: the device dedup holds nphrases x
    max-length bytes.  ``info`` is dedup_rank_device's.
    """
    if device is not None:
        from ..parallel.dict_union import dedup_rank_device

        return dedup_rank_device(T, starts, ends, device, info)
    from .. import native

    lens = (ends - starts + 1).astype(np.int64)
    if native.available():
        starts64 = np.asarray(starts, dtype=np.int64)
        ranks, D = native.rank_substrings_native(T, starts64, lens)
        occs = np.bincount(ranks, minlength=D + 1)[1:].astype(np.uint64)
        _, first = np.unique(ranks, return_index=True)
        return starts64[first], lens[first], occs, ranks.astype(np.uint32)
    h1 = _substring_hashes(T, starts, lens, _HB1)
    h2 = _substring_hashes(T, starts, lens, _HB2)
    order = np.lexsort((h2, h1, lens))
    l_o, h1_o, h2_o = lens[order], h1[order], h2[order]
    new_grp = np.empty(order.shape[0], dtype=bool)
    new_grp[0] = True
    new_grp[1:] = (
        (l_o[1:] != l_o[:-1]) | (h1_o[1:] != h1_o[:-1]) | (h2_o[1:] != h2_o[:-1])
    )
    gid_in_order = np.cumsum(new_grp) - 1
    D = int(gid_in_order[-1]) + 1
    # group id per occurrence; representative (first occurrence) + count
    gid = np.empty(order.shape[0], dtype=np.int64)
    gid[order] = gid_in_order
    rep = order[new_grp]
    counts = np.bincount(gid_in_order, minlength=D)
    rep_starts = starts[rep]
    rep_lens = lens[rep]
    word_order = _lex_order_of_substrings(T, rep_starts, rep_lens)
    rank_of_group = np.empty(D, dtype=np.int64)
    rank_of_group[word_order] = np.arange(1, D + 1)
    parse_ranks = rank_of_group[gid].astype(np.uint32)
    occs = counts[word_order].astype(np.uint64)
    return rep_starts[word_order], rep_lens[word_order], occs, parse_ranks


def _pack8(T: np.ndarray, starts, off: int, lens) -> np.ndarray:
    """Big-endian pack of T[s+off : s+off+8] per phrase, zero-padded past
    the phrase end (zero < any real byte, giving prefix-correct order)."""
    D = starts.shape[0]
    val = np.zeros(D, dtype=np.uint64)
    limit = np.uint64(0)
    tmax = T.shape[0] - 1
    for b in range(8):
        idx = np.minimum(starts + off + b, tmax)
        ch = T[idx].astype(np.uint64)
        valid = (off + b) < lens
        val = (val << np.uint64(8)) | np.where(valid, ch, limit)
    return val


def _lex_order_of_substrings(T: np.ndarray, starts, lens) -> np.ndarray:
    """argsort of the (unique) substrings of T by byte-lex order: 8-byte
    chunk radix refinement, ending once all ranks are distinct (the
    phrases are unique and prefix-free)."""
    D = starts.shape[0]
    if D <= 1:
        return np.arange(D, dtype=np.int64)
    starts = np.asarray(starts, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    maxlen = int(lens.max())
    rank = np.zeros(D, dtype=np.int64)
    for off in range(0, maxlen + 8, 8):
        chunk = _pack8(T, starts, off, lens)
        order = np.lexsort((chunk, rank))
        r_o, c_o = rank[order], chunk[order]
        newg = np.empty(D, dtype=np.int64)
        newg[0] = 0
        newg[1:] = (r_o[1:] != r_o[:-1]) | (c_o[1:] != c_o[:-1])
        nr = np.cumsum(newg)
        rank[order] = nr
        if nr[-1] == D - 1:
            break
    if rank.max() != D - 1:
        raise RuntimeError("duplicate phrases reached the word sort")
    return np.argsort(rank, kind="stable")


def finalize_parse(
    C: np.ndarray,
    starts: np.ndarray,
    ends: np.ndarray,
    params: ParserParams,
    doc_names: Optional[List[str]] = None,
    doc_starts: Optional[List[int]] = None,
    nseqs: int = 0,
    device=None,
    info: dict = None,
) -> ParseResult:
    """Dict dedup + ranking + per-occurrence metadata
    (pfparser.hpp:484-517); the dedup on ``device`` (``info`` as
    dedup_rank_device's), or on the host when it is None or
    PFBWT_DICT_IMPL is ``host`` or ``numpy``."""
    if os.environ.get("PFBWT_DICT_IMPL", "").lower() in ("host", "numpy"):
        device = None
    w = params.w
    T = _tprime(C, w)
    nphrases = starts.shape[0]
    if nphrases == 1:
        die("error: only one dict word total. Re-run with a smaller p modulus")
    check_phrase_count(nphrases)
    dict_starts, dict_lens, occs, parse_ranks = _dedup_and_rank(
        T, starts, ends, device, info)
    return ParseResult(
        params=params,
        text=T,
        dict_starts=dict_starts,
        dict_lens=dict_lens,
        occs=occs,
        parse_ranks=parse_ranks,
        last=T[ends - w],
        sai=ends.astype(np.uint64),
        doc_names=list(doc_names or []),
        doc_starts=list(doc_starts or []),
        pos=C.shape[0] + w,  # == |T'| - 1
        nseqs=nseqs,
    )
