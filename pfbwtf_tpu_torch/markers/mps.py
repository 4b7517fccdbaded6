"""Marker-positions (.mps) streams.

File format (marker_array.hpp:100-121): repeated uint64 runs
``start end marker... 0xFFFFFFFFFFFFFFFF`` where [start, end] is an
inclusive text-position range and the markers are bit-packed MarkerT values.

``MarkerPositionsWriter`` reproduces the reference's windowed coalescing
writer (marker_array.hpp:31-132): each marker covers the ``wsize`` text
positions ending at its textpos; adjacent positions with identical marker
lists coalesce into one run.  (Note the reference's own vcf_scan call site
does not compile at this revision — marker_array.hpp:64 vs vcf_scan.cpp:216
— so the behavioral spec here is the committed truth outputs, per
SURVEY.md §7 "hard parts" item 6.)
"""

from typing import List, Tuple

import numpy as np

from .marker import DELIM, create_marker


class MarkerPositionsWriter:
    def __init__(self, wsize: int, fp):
        self.wsize = int(wsize)
        self.fp = fp
        self.seqid = -1
        self.tpos = 0
        self.queue: List[Tuple[int, int, int, int]] = []  # (textpos, refpos, gt, seqid)
        self.pending_markers: List[int] = []
        self.range = [0, 0]

    def update(self, pos: int, recpos: int, gt: int, seqid: int):
        if seqid == -1:
            raise ValueError("seqid==-1 not allowed")
        if self.seqid != -1 and self.seqid != seqid:
            raise RuntimeError("sequence changed without finish_sequence()")
        while self.queue and self.queue[0][0] + self.wsize <= pos:
            self._process_run()
            self.queue.pop(0)
        self.queue.append((pos, recpos, gt, seqid))
        self.seqid = seqid

    def finish_sequence(self):
        if self.queue:
            self._process_run()
        self.queue.clear()
        if self.pending_markers:
            self._emit(self.range[0], self.range[1], self.pending_markers)
        self.pending_markers = []
        self.range = [0, 0]
        self.seqid = -1

    def _process_run(self):
        front = self.queue[0][0]
        if self.tpos + self.wsize <= front:
            self.tpos = front - self.wsize + 1
        for i, m in enumerate(self.queue):
            if not (self.tpos + self.wsize > m[0]):
                end = m[0] - self.wsize
                self._write_markers(self.tpos, end, i)
                self.tpos = end + 1
        self._write_markers(self.tpos, front, len(self.queue))
        self.tpos = front + 1

    def _write_markers(self, start: int, end: int, count: int):
        markers: List[int] = []
        px = None
        for textpos, refpos, gt, seqid in self.queue[:count]:
            x = int(create_marker(refpos, gt, seqid))
            if x != px:
                markers.append(x)
            px = x
        if start == self.range[1] + 1 and markers == self.pending_markers:
            self.range[1] = end
        else:
            if self.pending_markers:
                self._emit(self.range[0], self.range[1], self.pending_markers)
            self.range = [start, end]
            self.pending_markers = markers

    def _emit(self, start: int, end: int, markers: List[int]):
        arr = np.empty(len(markers) + 3, dtype=np.uint64)
        arr[0] = start
        arr[1] = end
        arr[2 : 2 + len(markers)] = markers
        arr[-1] = DELIM
        self.fp.write(arr.tobytes())


def mps_stream_from_markers(
    wsize: int, pos: np.ndarray, vals: np.ndarray
) -> np.ndarray:
    """Whole-sequence .mps byte stream, fully vectorized.

    ``pos`` (nondecreasing textpos) and ``vals`` (bit-packed MarkerT) are
    one sequence's markers in emission order.  Equivalent to pushing them
    through MarkerPositionsWriter + finish_sequence, but O(runs) numpy work
    instead of a per-marker Python loop (the writer is host-serial on the
    marker stream — a wall at panel scale).

    Model of the streaming writer: text position t carries the
    consecutive-deduped list of markers with t <= pos_i <= t + wsize - 1
    (each marker covers the wsize positions ending at its textpos); runs
    are maximal contiguous intervals with identical nonempty lists.  List
    equality across interval boundaries uses (length, first value, two
    independent 64-bit polynomial hashes) — the same
    probabilistically-exact contract as the parse's hash dedup.
    """
    pos = np.asarray(pos, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.uint64)
    N = pos.shape[0]
    if N == 0:
        return np.zeros(0, dtype=np.uint64)
    if N > 1 and (pos[1:] <= pos[:-1]).any():
        raise ValueError("marker positions must be strictly increasing")
    # interval decomposition: active window [lo, hi) changes only at
    # entry (pos - wsize + 1) and exit (pos + 1) boundaries
    B = np.unique(np.concatenate((np.maximum(pos - wsize + 1, 0), pos + 1)))
    istart = B[:-1]
    iend = B[1:] - 1
    lo = np.searchsorted(pos, istart, side="left")
    hi = np.searchsorted(pos, istart + wsize, side="left")
    # finish_sequence truncation (marker_array.hpp:64-76 semantics): the
    # final flush processes up to the FRONT of the still-pending window
    # queue — the first marker with pos + wsize > pos_last — so positions
    # beyond that front are never emitted
    cutoff = pos[np.searchsorted(pos, pos[-1] - wsize, side="right")]
    iend = np.minimum(iend, cutoff)
    keep = (hi > lo) & (istart <= cutoff)
    istart, iend, lo, hi = istart[keep], iend[keep], lo[keep], hi[keep]

    # consecutive dedup of the marker value stream
    d = np.empty(N, dtype=bool)
    d[0] = True
    np.not_equal(vals[1:], vals[:-1], out=d[1:])
    cnt = np.cumsum(d)  # d-marked count in [0, i]
    didx = np.flatnonzero(d)
    # deduped list of window [lo, hi): vals[lo] + vals at d-positions in
    # (lo, hi)
    dlen = 1 + cnt[hi - 1] - cnt[lo]
    a = cnt[lo]  # index into didx of the first interior d-position

    # dual polynomial hashes of the interior subsequence (rank-weighted)
    def interior_hash(base: np.uint64) -> np.ndarray:
        pw = np.full(N, base, dtype=np.uint64)
        pw[0] = np.uint64(1)
        pw = np.multiply.accumulate(pw)  # base^i
        rank = cnt - 1
        terms = np.where(d, vals * pw[rank], np.uint64(0))
        P = np.cumsum(terms, dtype=np.uint64)
        inv = np.uint64(pow(int(base), -1, 1 << 64))
        ipw = np.full(N + 1, inv, dtype=np.uint64)
        ipw[0] = np.uint64(1)
        ipw = np.multiply.accumulate(ipw)
        return (P[hi - 1] - P[lo]) * ipw[cnt[lo]]

    h1 = interior_hash(np.uint64(0x9E3779B97F4A7C15))
    h2 = interior_hash(np.uint64(0xC2B2AE3D27D4EB4F))
    first = vals[lo]

    # coalesce adjacent contiguous intervals with equal lists
    newrun = np.empty(istart.shape[0], dtype=bool)
    newrun[0] = True
    newrun[1:] = (
        (istart[1:] != iend[:-1] + 1)
        | (dlen[1:] != dlen[:-1])
        | (first[1:] != first[:-1])
        | (h1[1:] != h1[:-1])
        | (h2[1:] != h2[:-1])
    )
    heads = np.flatnonzero(newrun)
    run_start = istart[heads]
    run_end = iend[np.concatenate((heads[1:] - 1, [istart.shape[0] - 1]))]
    L = dlen[heads]
    R = heads.shape[0]

    # assemble the output stream: [start end markers... DELIM] per run
    sizes = L + 3
    off = np.zeros(R, dtype=np.int64)
    np.cumsum(sizes[:-1], out=off[1:])
    out = np.empty(int(sizes.sum()), dtype=np.uint64)
    out[off] = run_start.astype(np.uint64)
    out[off + 1] = run_end.astype(np.uint64)
    out[off + sizes - 1] = DELIM
    totL = int(L.sum())
    run_of = np.repeat(np.arange(R), L)
    Lprev = np.zeros(R, dtype=np.int64)
    np.cumsum(L[:-1], out=Lprev[1:])
    within = np.arange(totL, dtype=np.int64) - Lprev[run_of]
    src = np.where(
        within == 0,
        lo[heads][run_of],
        didx[np.minimum(a[heads][run_of] + within - 1, didx.shape[0] - 1)],
    )
    out[off[run_of] + 2 + within] = vals[src]
    return out


class BatchMarkerPositionsWriter:
    """Drop-in MarkerPositionsWriter with O(1) Python work per marker:
    update() appends to buffers; finish_sequence() emits the sequence's
    whole .mps stream via mps_stream_from_markers."""

    def __init__(self, wsize: int, fp):
        self.wsize = int(wsize)
        self.fp = fp
        self.seqid = -1
        self._buf: List[Tuple[int, int, int, int]] = []
        # tpos carries ACROSS finish_sequence in the reference
        # (marker_array.hpp: tpos_ is never reset) — positions are global
        # along the haplotype stream
        self._tpos = 0

    def update(self, pos: int, recpos: int, gt: int, seqid: int):
        if seqid == -1:
            raise ValueError("seqid==-1 not allowed")
        if self.seqid != -1 and self.seqid != seqid:
            raise RuntimeError("sequence changed without finish_sequence()")
        self.seqid = seqid
        self._buf.append((pos, recpos, gt, seqid))

    def finish_sequence(self):
        if self._buf:
            pos = np.array([m[0] for m in self._buf], dtype=np.int64)
            nonmono = pos.shape[0] > 1 and (pos[1:] <= pos[:-1]).any()
            truncated = max(0, int(pos[0]) - self.wsize + 1) < self._tpos
            if nonmono or truncated:
                # duplicate textpos or regression into the carried window:
                # the reference's queue-pop order then emits degenerate
                # (start > end) runs the interval model cannot express —
                # replay through the faithful streaming writer (never hit
                # by the VCF scan: positions are strictly increasing along
                # the haplotype and overlapping variants are skipped,
                # vcf_scan.cpp:210-213)
                w = MarkerPositionsWriter(self.wsize, self.fp)
                w.tpos = self._tpos
                for m in self._buf:
                    w.update(*m)
                w.finish_sequence()
                self._tpos = w.tpos
            else:
                vals = create_marker(
                    np.array([m[1] for m in self._buf], dtype=np.uint64),
                    np.array([m[2] for m in self._buf], dtype=np.uint64),
                    np.array([m[3] for m in self._buf], dtype=np.uint64),
                )
                out = mps_stream_from_markers(self.wsize, pos, vals)
                self.fp.write(out.tobytes())
                last = int(pos[-1])
                cutoff = pos[
                    np.searchsorted(pos, last - self.wsize, side="right")
                ]
                self._tpos = int(cutoff) + 1
        self._buf = []
        self.seqid = -1


def read_mps_runs(path_or_bytes):
    """Parse a .mps/.ma stream into (starts, ends, marker lists)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        raw = bytes(path_or_bytes)
    else:
        raw = open(path_or_bytes, "rb").read()
    vals = np.frombuffer(raw, dtype=np.uint64)
    starts, ends, markers = [], [], []
    i = 0
    delim = int(DELIM)
    n = vals.shape[0]
    delim_pos = np.flatnonzero(vals == delim)
    prev = 0
    for d in delim_pos:
        run = vals[prev:d]
        if run.shape[0] >= 2:
            starts.append(int(run[0]))
            ends.append(int(run[1]))
            markers.append(run[2:].copy())
        prev = d + 1
    return (
        np.array(starts, dtype=np.uint64),
        np.array(ends, dtype=np.uint64),
        markers,
    )


def write_mps_runs(fp, starts, ends, markers):
    for s, e, ms in zip(starts, ends, markers):
        arr = np.empty(len(ms) + 3, dtype=np.uint64)
        arr[0] = s
        arr[1] = e
        arr[2 : 2 + len(ms)] = ms
        arr[-1] = DELIM
        fp.write(arr.tobytes())


def merge_mps(output: str, prefixes: List[str]):
    """merge_mps CLI equivalent (src/merge_mps.cpp:28-84): concatenate
    per-haplotype .mps streams, offsetting run keys by the cumulative text
    length read from each prefix's .n file."""
    from ..io.formats import read_n

    with open(output, "wb") as ofp:
        seq_bias = 0
        for prefix in prefixes:
            starts, ends, markers = read_mps_runs(prefix + ".mps")
            length = read_n(prefix + ".n")
            write_mps_runs(
                ofp,
                (starts.astype(np.int64) + seq_bias).astype(np.uint64),
                (ends.astype(np.int64) + seq_bias).astype(np.uint64),
                markers,
            )
            seq_bias += length
