"""Chunked (bounded-memory) parse: ``pfbwt_f --chunk-mb N``.

The char stream goes through the cut scan (kernel K1 on the card) in
fixed-size chunks with a halo of codes carried from one chunk to the
next, so the device holds one chunk at a time and the cut set is that of
the whole-array scan for any chunk size.  FASTA records stream one at a
time, T' goes to a scratch file read back as a memmap, and the dedup runs
on the host (ops/parse._dedup_and_rank).

The halo is w codes, one more than a k-mer needs: the scan clears
``cut[:w]`` of the buffer it is given (positions i < w of the text never
cut), so with w - 1 codes of halo the first live position of every later
chunk would sit at buffer index w - 1 and lose its cut.  With w codes the
live positions start at index w, and the text's own ``i >= w`` guard is
applied here, on global positions.
"""

import os
import tempfile
import time
from typing import Iterable, List

import numpy as np
import torch

from ..constants import Dollar
from ..utils.device import resolve_device
from ..utils.errors import die
from ..utils.limits import check_phrase_count
from ..utils.tables import NT4_TABLE, UPPER_TABLE, codes_or_die
from .hash import cut_mask
from .parse import ParseResult, _dedup_and_rank, phrase_bounds_from_cuts


def chunked_cut_positions(
    codes_iter: Iterable[np.ndarray], w: int, p: int, chunk: int = 1 << 24,
    device="cuda",
) -> np.ndarray:
    """Global cut positions over a stream of code arrays (values 0..3).

    ``codes_iter`` yields pieces of any size; they are re-blocked into
    ``chunk``-code scans on ``device``, one K1 launch each on a card.
    Each chunk's cuts are compacted exactly (the JAX package compacts into
    a fixed capacity and re-scans a chunk that overflows it, which a
    shape-free compaction does not need), so a run of C codes scans
    ceil(C / chunk) times.  Returns absolute cut positions (int64)."""
    dev = resolve_device(device)
    halo = w
    buf = np.zeros(halo + chunk, dtype=np.uint8)  # codes before 0 read as 0
    fill = 0  # valid codes in buf[halo:]
    offset = 0  # absolute position of buf[halo]
    cuts: List[np.ndarray] = []

    def flush(n_valid):
        nonlocal offset
        ext = torch.from_numpy(buf[: halo + n_valid]).to(dev)
        cut = cut_mask(ext, w, p)[halo:]
        cut[: max(w - offset, 0)] = False  # i >= w on global positions
        cuts.append(torch.nonzero(cut).flatten().cpu().numpy() + offset)
        buf[:halo] = buf[n_valid: n_valid + halo]
        offset += n_valid

    for piece in codes_iter:
        piece = np.asarray(piece, dtype=np.uint8)
        i = 0
        while i < piece.shape[0]:
            take = min(chunk - fill, piece.shape[0] - i)
            buf[halo + fill: halo + fill + take] = piece[i: i + take]
            fill += take
            i += take
            if fill == chunk:
                flush(chunk)
                fill = 0
    if fill:
        flush(fill)
    if not cuts:
        return np.zeros(0, dtype=np.int64)
    return np.concatenate(cuts).astype(np.int64)


def parse_fasta_chunked(fname: str, params, chunk: int = 1 << 24,
                        device="cuda", info: dict = None) -> ParseResult:
    """Bounded-memory parse, the output of engine.parse_fasta for any
    chunk size:

    * FASTA records stream one at a time (io/fasta.iter_fasta_records);
    * T' = Dollar + C + Dollar*w is written to a scratch file in the
      temporary directory as the stream passes, and read back as a
      read-only memmap;
    * the cut scan runs on ``device`` in ``chunk``-code pieces.

    ``info`` receives scan_s (the stream, the T' file and the chunked
    scan), dedup_s (the host dedup) and n_chunks.
    """
    from ..io.fasta import iter_fasta_records

    w = params.w
    fd, tpath = tempfile.mkstemp(suffix=".tprime")
    tf = os.fdopen(fd, "wb")
    doc_names: List[str] = []
    doc_starts: List[int] = []
    state = {"nseqs": 0, "clen": 0}
    padA = np.full(w, ord("A"), dtype=np.uint8)

    def code_pieces():
        tf.write(bytes([Dollar]))
        for name, seq in iter_fasta_records(fname):
            seq = UPPER_TABLE[seq]
            if params.non_acgt_to_a:
                seq = np.where(NT4_TABLE[seq] > 3, np.uint8(ord("A")), seq)
            doc_names.append(name)
            doc_starts.append(state["clen"])
            state["nseqs"] += 1
            state["clen"] += seq.shape[0] + w
            tf.write(seq.tobytes())
            tf.write(padA.tobytes())
            yield codes_or_die(seq)
            yield np.zeros(w, dtype=np.uint8)  # the 'A' pad hashes as 0s
        tf.write(bytes([Dollar]) * w)
        tf.flush()

    info = {} if info is None else info
    try:
        t0 = time.perf_counter()
        cuts = chunked_cut_positions(code_pieces(), w, params.p, chunk, device)
        tf.close()
        t1 = time.perf_counter()
        C_len = state["clen"]
        starts, ends = phrase_bounds_from_cuts(C_len, cuts, w)
        if starts.shape[0] == 1:
            die("error: only one dict word total. Re-run with a smaller p "
                "modulus")
        check_phrase_count(starts.shape[0])
        T = np.memmap(tpath, dtype=np.uint8, mode="r")
        dict_starts, dict_lens, occs, parse_ranks = _dedup_and_rank(
            T, starts, ends)
        info.update(scan_s=t1 - t0, dedup_s=time.perf_counter() - t1,
                    n_chunks=-(-C_len // chunk))
        return ParseResult(
            params=params,
            text=T,
            dict_starts=dict_starts,
            dict_lens=dict_lens,
            occs=occs,
            parse_ranks=parse_ranks,
            last=np.asarray(T[ends - w]),
            sai=ends.astype(np.uint64),
            doc_names=doc_names if params.store_docs else [],
            doc_starts=doc_starts if params.store_docs else [],
            pos=C_len + w,
            nseqs=state["nseqs"],
        )
    finally:
        if not tf.closed:
            tf.close()
        os.unlink(tpath)
