"""Parse merging, the merge_pfp core (pfbwtf_tpu/parallel/merge.py).

The reference merges saved parses by replaying every rhs phrase through the
lhs's freq map with a junction re-hash (PfParser::operator+=,
pfparser.hpp:194-263).  Two exactness facts make the array-native merge
simple:

1. A finalized parse losslessly encodes its text: consecutive phrases
   overlap by exactly w chars, so C = strip_sentinels(join(phrases)).
2. The merged parse equals the parse of the concatenated padded text,
   because every document ends with w pad 'A's, which resets the rolling
   k-mer to the A^w state the junction re-hash reproduces
   (pfparser.hpp:226-245).

So merging = rebuild each shard's text on the host, concatenate, and parse
the whole again: the cut scan (kernel K1 on the card) and the dictionary
dedup run on ``device`` (engine.parse_stream, ops/parse.finalize_parse).
The n-scale index arrays of the text rebuild stay on the host.

Inside an open build (utils/timer.build: merge_pfp's run, the pod parse)
the merge's stages are the spans ``merge.rebuild`` (the texts rebuilt or
read, and joined), ``merge.scan`` (engine.parse_stream) and
``merge.dedup`` (finalize_parse), with the counters ``merge_prefixes``
(prefixes read) and ``rebuilt_bytes`` (characters rebuilt from .dict +
.parse).
"""

import os
from typing import List

import numpy as np

from ..constants import Dollar, EndOfWord
from ..io import formats
from ..io.fasta import read_fasta_bytes
from ..ops.parse import ParseResult, ParserParams, build_stream, finalize_parse
from ..utils.device import peak_allocated
from ..utils.errors import die
from ..utils.timer import count, span


def reconstruct_text(prefix: str, w: int):
    """Rebuild the char stream C of a saved (finalized) parse from its
    .dict + .parse files, plus doc info if present.

    Fully vectorized: word (start, len) views come from the separator
    positions of the flat .dict bytes, and the per-occurrence char gather is
    one repeat + fancy-index — no per-phrase Python objects (the parse has
    tens of millions of occurrences at genome scale)."""
    flat = formats.read_dict_flat(prefix + ".dict")
    ranks = formats.read_parse_ranks(prefix + ".parse")
    if ranks.size == 0:
        die(f"{prefix}: empty parse")
    eow = np.flatnonzero(flat == EndOfWord)
    word_start = np.concatenate(([0], eow[:-1] + 1)).astype(np.int64)
    word_len = eow - word_start
    occ = ranks.astype(np.int64) - 1
    # occurrence j > 0 skips the w-char overlap with its predecessor
    skip = np.zeros(occ.shape[0], dtype=np.int64)
    skip[1:] = w
    src0 = word_start[occ] + skip
    lens = word_len[occ] - skip
    bounds = np.cumsum(lens)
    total = int(bounds[-1])
    idx = np.arange(total, dtype=np.int64)
    which = np.searchsorted(bounds, idx, side="right")
    within = idx - (bounds[which] - lens[which])
    joined = flat[src0[which] + within]
    # strip the leading Dollar and trailing w Dollars
    assert joined[0] == Dollar and joined[-1] == Dollar
    C = joined[1:-w]
    doc_names: List[str] = []
    doc_starts: List[int] = []
    if os.path.exists(prefix + ".docs"):
        doc_names, doc_starts = formats.read_docs(prefix + ".docs")
    return C, doc_names, doc_starts


def load_or_generate_text(prefix: str, params: ParserParams):
    """load_or_generate_parser_w_log semantics (pfbwt_io.hpp:270-285):
    use the saved parse checkpoint when present, else parse the FASTA at
    ``prefix`` directly."""
    if formats.parse_files_exist(prefix):
        C, names, starts = reconstruct_text(prefix, params.w)
        count("rebuilt_bytes", C.shape[0])
        return C, names, starts
    if not os.path.exists(prefix):
        die(f"ERROR: {prefix} not found, cannot add it to parse!")
    records = read_fasta_bytes(prefix)
    C, names, starts = build_stream(records, params)
    if not params.store_docs:
        names, starts = [], []
    return C, names, starts


def merge_parse_prefixes(prefixes: List[str], params: ParserParams,
                         device="cuda", info: dict = None) -> ParseResult:
    """merge_pfp core: fold all prefixes into one finalized parse, the
    rescan and the dedup on ``device`` (the reference's operator+= fold is
    host-serial, merge_pfp.cpp:97-152).  ``info`` receives rebuild_s,
    scan_s and dedup_s (the seconds of the spans ``merge.rebuild``,
    ``merge.scan`` and ``merge.dedup``), finalize_parse's keys and
    peak_merge, the device's peak allocation as the dedup ends (None on
    the CPU)."""
    from .. import engine

    info = {} if info is None else info
    with span("merge.rebuild") as rebuild:
        chunks = []
        doc_names: List[str] = []
        doc_starts: List[int] = []
        off = 0
        for prefix in prefixes:
            C, names, starts = load_or_generate_text(prefix, params)
            count("merge_prefixes")
            chunks.append(C)
            doc_names.extend(names)
            doc_starts.extend(int(s) + off for s in starts)
            off += C.shape[0]
        C = np.concatenate(chunks) if chunks else np.zeros(0, np.uint8)
        del chunks
    with span("merge.scan") as scan:
        starts_arr, ends_arr = engine.parse_stream(C, params, device)
    with span("merge.dedup") as dedup:
        res = finalize_parse(
            C, starts_arr, ends_arr, params,
            doc_names=doc_names if params.store_docs else [],
            doc_starts=doc_starts if params.store_docs else [],
            nseqs=len(doc_names), device=device, info=info,
        )
    info.update(rebuild_s=rebuild.seconds, scan_s=scan.seconds,
                dedup_s=dedup.seconds, peak_merge=peak_allocated(device))
    return res
