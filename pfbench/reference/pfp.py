"""The prefix-free parse of a FASTA file and the BWT of that parse: the
seven checkpoint files of pfbwt-f's staged build, worked out plainly.

pfbwt-f writes them between its stages (src/pfbwt-f.cpp:209-245;
SURVEY.md §5.1 has the byte layouts). Each rule below cites the
reference's anchor:

- T' is a leading Dollar (0x02, pfparser.hpp:316-318), each record's
  sequence upper-cased and followed by w 'A's (pfparser.hpp:333-337),
  then w Dollars (pfparser.hpp:485-488). n, the ``.n`` file's number in
  ASCII with a newline (pfbwt-f.cpp:241-243), counts the records and
  their pads and no Dollar (pfparser.hpp:529-532).
- The window hash is the k-mer of the last w codes, 2 bits a code, the
  newest code in bits 0-1 (hash.hpp:32), under Thomas Wang's 64-bit
  integer mix (hash.hpp:12-21). A=0, C=1, G=2, T=3; 'N' hashes as A and
  '-' as T (utils.c:139-161); any other byte is refused
  (pfparser.hpp:345-351).
- A phrase ends where the hash of the window ending at a character is 0
  mod p, once more than w characters follow the Dollar
  (pfparser.hpp:347). The phrase ends one character after the window, and
  the next phrase starts w characters before that end, so phrases overlap
  by w (pfparser.hpp:353-360). The last phrase ends at the last Dollar.
- The dictionary is the distinct phrases in byte order (strcmp,
  pfparser.hpp:500-501), each followed by EndOfWord (0x01), then
  EndOfDict (0x00) (``.dict``, pfbwt_io.hpp:71-82); ``.occ`` the counts
  in that order (pfparser.hpp:471-480); ``.parse`` the 1-based ranks in
  text order, uint32 (pfbwt_io.hpp:241, gsacak.h:64).
- Each phrase has ``last``, the character w + 1 from its end
  (pfparser.hpp:599), and ``sai``, its end in T' (pfparser.hpp:600).
- The parse's SA is that of the ranks plus a 0 terminator
  (pfparser.hpp:425). ``.bwlast`` row i holds last of the phrase two
  before suffix SA[i] (taken cyclically), 0 where SA[i] is 0
  (pfparser.hpp:431-451); ``.bwsai`` sai of the phrase before it, 0 where
  SA[i] is 0 (pfparser.hpp:435-448); ``.ilist`` the rows ordered by the
  rank of the phrase before each suffix, the row with SA[i] 0 first and
  ties in row order (the F-array counting sort, pfparser.hpp:452-462).
  Integer files are uint64, the default build's width.

The hash runs in plain PyTorch on the device the reference is given
(int64 holds the uint64 bits); the phrases are Python bytes. The parse's
SA is sorted by the same prefix doubling as ``sa.py``'s, over integer
symbols; ``max_rounds`` stops it early as there (the control).
Departures from the reference: none.
"""

import numpy as np
import torch

DOLLAR, END_OF_WORD, END_OF_DICT = 2, 1, 0
_CODES = np.full(256, 255, dtype=np.uint8)
for _ch, _v in zip(b"ACGTN-", (0, 1, 2, 3, 0, 3)):
    _CODES[_ch] = _v


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """The logical right shift of the 64 bits held in int64 ``x``."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def wang_hash(key: torch.Tensor) -> torch.Tensor:
    """hash.hpp:12-21 on the 64 bits held in int64 ``key``: int64 adds,
    left shifts, xors and negation wrap as uint64's do."""
    key = (~key) + (key << 21)
    key = key ^ _shr(key, 24)
    key = (key + (key << 3)) + (key << 8)
    key = key ^ _shr(key, 14)
    key = (key + (key << 2)) + (key << 4)
    key = key ^ _shr(key, 28)
    return key + (key << 31)


def unsigned_mod(h: torch.Tensor, p: int) -> torch.Tensor:
    """The 64 bits of int64 ``h`` read as unsigned, mod ``p`` (p < 2**62):
    u = 2 q + b with q = u >> 1 and b its low bit, so u mod p is
    (2 (q mod p) + b) mod p."""
    return (2 * (_shr(h, 1) % p) + (h & 1)) % p


def cut_positions(text: np.ndarray, w: int, p: int, device,
                  block: int = 1 << 26) -> np.ndarray:
    """Positions k of ``text`` (the records and their pads) after which a
    phrase ends: k >= w and the hash of the window text[k-w+1 .. k] is 0
    mod p. Worked out on ``device`` in blocks of ``block`` windows."""
    codes = _CODES[text]
    if codes.shape[0] and codes.max() > 3:
        bad = int(text[np.flatnonzero(codes > 3)[0]])
        raise ValueError(f"invalid character {bad} in the input")
    out = []
    for lo in range(w, codes.shape[0], block):
        hi = min(lo + block, codes.shape[0])
        c = torch.from_numpy(codes[lo - w + 1:hi]).to(device, torch.int64)
        kmer = torch.zeros(hi - lo, dtype=torch.int64, device=device)
        for t in range(w):  # the code t steps back sits in bits 2t, 2t+1
            kmer |= c[w - 1 - t:w - 1 - t + hi - lo] << (2 * t)
        hit = unsigned_mod(wang_hash(kmer), p) == 0
        out.append(lo + torch.nonzero(hit).flatten().cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0, dtype=np.int64)


def parse(text: np.ndarray, w: int, p: int, device):
    """(dictionary phrases in byte order, occurrence counts, 1-based ranks
    in text order, last, sai) of ``text``."""
    n = int(text.shape[0])
    tp = np.concatenate((np.array([DOLLAR], dtype=np.uint8), text,
                         np.full(w, DOLLAR, dtype=np.uint8)))
    ends = np.concatenate((cut_positions(text, w, p, device) + 1, [n + w]))
    starts = np.concatenate(([0], ends[:-1] - w + 1))
    data = tp.tobytes()
    phrases = [data[s:e + 1] for s, e in zip(starts.tolist(), ends.tolist())]
    counts = {}
    for ph in phrases:
        counts[ph] = counts.get(ph, 0) + 1
    words = sorted(counts)
    rank = {ph: r for r, ph in enumerate(words, 1)}
    ranks = np.fromiter((rank[ph] for ph in phrases), dtype=np.int64,
                        count=len(phrases))
    occs = np.array([counts[ph] for ph in words], dtype=np.uint64)
    return words, occs, ranks, tp[ends - w], ends.astype(np.uint64)


def int_suffix_array(seq: np.ndarray, device, max_rounds: int = None):
    """(SA of ``seq`` plus a terminator below every symbol, as an int64
    tensor of len + 1 entries on ``device``, rounds): sa.py's doubling
    over non-negative integer symbols."""
    size = int(seq.shape[0]) + 1
    rank = torch.zeros(size, dtype=torch.int64, device=device)
    rank[:-1] = torch.from_numpy(np.asarray(seq, dtype=np.int64)).to(
        device) + 1
    # dense ranks 1.. of the symbols, the terminator 0
    _, rank = torch.unique(rank, return_inverse=True)
    scale = size + 1
    h, rounds = 1, 0
    while True:
        nxt = torch.zeros(size, dtype=torch.int64, device=device)
        if h < size:
            nxt[:size - h] = rank[h:] + 1
        key = rank * scale + nxt
        del nxt
        key, sa = torch.sort(key, stable=max_rounds is not None)
        new = torch.zeros(size, dtype=torch.int64, device=device)
        new[1:] = torch.cumsum(key[1:] != key[:-1], 0)
        del key
        rank[sa] = new
        rounds += 1
        done = int(new[-1]) == size - 1
        del new
        if done or (max_rounds is not None and rounds >= max_rounds):
            return sa, rounds
        h *= 2


def parse_bwt(ranks: np.ndarray, last: np.ndarray, sai: np.ndarray, device,
              max_rounds: int = None):
    """(.bwlast, .ilist, .bwsai) of the parse, as int64 tensors."""
    m = int(ranks.shape[0])
    sa, _ = int_suffix_array(ranks, device, max_rounds)
    r = torch.from_numpy(ranks).to(device)
    la = torch.from_numpy(np.asarray(last, dtype=np.int64)).to(device)
    si = torch.from_numpy(sai.view(np.int64)).to(device)
    zero = sa == 0
    bwlast = torch.where(zero, 0, la[(sa - 2) % m])
    bwsai = torch.where(zero, 0, si[(sa - 1) % m])
    before = torch.where(zero, 0, r[(sa - 1) % m])
    ilist = torch.sort(before, stable=True).indices
    return bwlast, ilist, bwsai


def checkpoint_files(text: np.ndarray, w: int, p: int, device,
                     max_rounds: int = None) -> dict:
    """The seven files' contents, by extension, as tensors on ``device``:
    bytes for .dict and .n, else one entry a number."""
    words, occs, ranks, last, sai = parse(text, w, p, device)
    dict_bytes = b"".join(ph + bytes([END_OF_WORD]) for ph in words)
    dict_bytes += bytes([END_OF_DICT])
    bwlast, ilist, bwsai = parse_bwt(ranks, last, sai, device, max_rounds)

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    return {
        "dict": t(np.frombuffer(dict_bytes, dtype=np.uint8)),
        "occ": t(occs.view(np.int64)),
        "parse": t(ranks),
        "n": t(np.frombuffer(f"{text.shape[0]}\n".encode(), dtype=np.uint8)),
        "bwlast": bwlast, "ilist": ilist, "bwsai": bwsai,
    }
