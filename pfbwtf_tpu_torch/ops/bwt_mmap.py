"""Out-of-core final BWT assembly (the -m mode, file_wrappers.hpp role).

The reference's -m flag backs every n-scale container with mmap
(file_wrappers.hpp:36-124) and spills the dict gSA/gLCP workspace to
.gsa/.glcp files (pfbwt.hpp:208-209).  ``assemble_bwt_stream``, stage 3
of the staged ``pfbwt_f -m`` (pfbwtf_tpu/ops/bwt_mmap.py):

* the checkpoint files arrive as read-only np.memmap views;
* the dict-scale layout is built on the host (ops/bwt.suffix_layout) and
  the gSA (+gLCP where the native kernel runs) spills to <prefix>.gsa /
  <prefix>.glcp with the reference's widths;
* the dict- and parse-scale arrays go to the device once; the n-scale
  work runs there one group-aligned chunk at a time (emissions come in
  suffix order, along which the group id never decreases, so the global
  (group, ilist-pos) sort splits into independent chunk sorts): the
  fan-out, the sort and the char and SA gathers of the streamed fused
  build's J3e (ops/fused_stream._chunk_core).  Each chunk is downloaded
  and written while the next one runs.

Host RAM and device memory stay O(|dict| + |parse| + chunk).
``_ChunkWriter`` is the output side of this path and of the streamed fused
build: it downloads each chunk, writes it, and collects the .ssa/.esa
samples across chunk boundaries (``_RunState``).  Inside an open build
(utils/timer.build) each chunk's wait for its download, its writes and
its run sampling are spans ``j3e.fetch``, ``j3e.write`` and
``j3e.sample``, and its download's bytes count as ``d2h_bytes``.
"""

import time
from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.errors import die
from ..utils.timer import count, span
from .bwt import suffix_layout


class _RunState:
    """Streaming run-length bookkeeping across chunks (.ssa/.esa pairs,
    pfbwt-f.cpp:304-319 semantics)."""

    def __init__(self, sa_dtype):
        self.prev_char = -1  # no previous char yet
        self.prev_sa = np.uint64(0)
        self.nruns = 0
        self.sa_dtype = sa_dtype
        self.ssa_parts = []
        self.esa_parts = []

    def feed(self, base: int, bwtc: np.ndarray, sa_vals: np.ndarray):
        m = bwtc.shape[0]
        if m == 0:
            return
        change = np.empty(m, dtype=bool)
        change[0] = int(bwtc[0]) != self.prev_char
        np.not_equal(bwtc[1:], bwtc[:-1], out=change[1:])
        starts = np.flatnonzero(change)
        self.nruns += int(starts.shape[0])
        if sa_vals is not None:
            gpos = base + starts
            ssa = np.empty(2 * starts.shape[0], dtype=self.sa_dtype)
            ssa[0::2] = gpos.astype(self.sa_dtype)
            ssa[1::2] = sa_vals[starts].astype(self.sa_dtype)
            self.ssa_parts.append(ssa)
            # a run START at global pos g>0 closes the previous run at g-1
            closing = gpos[gpos > 0]
            local = closing - base - 1  # index of g-1 inside this chunk
            esa = np.empty(2 * closing.shape[0], dtype=self.sa_dtype)
            esa[0::2] = (closing - 1).astype(self.sa_dtype)
            prev_vals = np.where(
                local >= 0, sa_vals[np.maximum(local, 0)], self.prev_sa
            )
            esa[1::2] = prev_vals.astype(self.sa_dtype)
            self.esa_parts.append(esa)
            self.prev_sa = sa_vals[-1]
        self.prev_char = int(bwtc[-1])

    def finish(self, total: int):
        if self.prev_char < 0:
            return None, None
        tail = np.empty(2, dtype=self.sa_dtype)
        tail[0] = total - 1
        tail[1] = self.prev_sa
        self.esa_parts.append(tail)
        ssa = (
            np.concatenate(self.ssa_parts)
            if self.ssa_parts
            else np.zeros(0, self.sa_dtype)
        )
        esa = (
            np.concatenate(self.esa_parts)
            if self.esa_parts
            else np.zeros(0, self.sa_dtype)
        )
        return ssa, esa


def _start_fetch(bwt_d, sa_d):
    """Queue the download of one chunk; returns (bwt, sa, event) with host
    tensors that are complete once ``event`` (None on the CPU) is.  The
    bytes count as the build's ``d2h_bytes``, as utils/timer.host_read
    counts them (on the CPU too); the copies are not syncs."""
    count("d2h_bytes", sum(t.numel() * t.element_size()
                           for t in (bwt_d, sa_d) if t is not None))
    if bwt_d.device.type == "cpu":
        return bwt_d, sa_d, None
    bwt_h = torch.empty(bwt_d.shape, dtype=bwt_d.dtype, pin_memory=True)
    bwt_h.copy_(bwt_d, non_blocking=True)
    sa_h = None
    if sa_d is not None:
        sa_h = torch.empty(sa_d.shape, dtype=sa_d.dtype, pin_memory=True)
        sa_h.copy_(sa_d, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return bwt_h, sa_h, event


class _ChunkWriter:
    """The output side of a chunked build.  ``put`` queues the download of
    a chunk (the slots from ``base`` on) and then writes the chunk before
    it, so the card computes the next chunk while the host writes: the
    BWT bytes to ``bwt_fp``, the SA values as ``sa_dtype`` to ``sa_fp``
    (either may be None), the run starts and samples to ``runs``.
    ``flush`` writes the last one."""

    def __init__(self, bwt_fp, sa_fp, sa_dtype, want_rssa: bool):
        self.bwt_fp, self.sa_fp = bwt_fp, sa_fp
        self.sa_dtype = np.dtype(sa_dtype)
        self.want_rssa = want_rssa
        self.need_sa = sa_fp is not None or want_rssa
        self.runs = _RunState(self.sa_dtype)
        self._pending = None

    def put(self, base: int, bwt_d, sa_d):
        fetched = _start_fetch(bwt_d, sa_d if self.need_sa else None)
        self.flush()
        self._pending = (base, fetched)

    def flush(self):
        if self._pending is None:
            return
        base, (bwt_h, sa_h, event) = self._pending
        self._pending = None
        with span("j3e.fetch"):
            if event is not None:
                event.synchronize()
        with span("j3e.write"):
            bwtc = bwt_h.numpy()
            if self.bwt_fp is not None:
                self.bwt_fp.write(bwtc.tobytes())
            sa_vals = None
            if self.need_sa:
                sa_vals = sa_h.numpy().view(np.uint64)
                if self.sa_fp is not None:
                    self.sa_fp.write(sa_vals.astype(self.sa_dtype).tobytes())
        with span("j3e.sample"):
            self.runs.feed(base, bwtc, sa_vals if self.want_rssa else None)


def assemble_bwt_stream(
    dict_flat: np.ndarray,
    w: int,
    occs: np.ndarray,
    bwlast: np.ndarray,
    ilist: np.ndarray,
    bwsai: Optional[np.ndarray],
    n: int,
    bwt_fp,
    sa_fp=None,
    want_rssa: bool = False,
    sa_dtype=np.dtype("<u8"),
    chunk: int = 1 << 22,
    workspace_prefix: Optional[str] = None,
    workspace_dtype=np.dtype("<u8"),
    device="cuda",
    info: dict = None,
):
    """Streamed stage 3 on ``device``: writes the BWT (and SA values as
    sa_dtype) to the given file objects chunk by chunk; returns (nruns,
    ssa, esa).  Chunks hold about ``chunk`` emissions and end at group
    boundaries (a group larger than that is taken whole).

    ``workspace_prefix`` spills the dict gSA (+gLCP) to <prefix>.gsa /
    .glcp (reference extension registry, utils.h:17-31).  ``info``
    receives layout_s (host layout, spill included), chunks_s (upload,
    chunks and writes) and n_chunks."""
    from .fused_stream import _chunk_core

    dev = resolve_device(device)
    sa_dtype = np.dtype(sa_dtype)
    workspace_dtype = np.dtype(workspace_dtype)
    info = {} if info is None else info
    t0 = time.perf_counter()

    def spill(sa_all, lcp):
        if workspace_prefix is None:
            return
        np.asarray(sa_all).astype(workspace_dtype).tofile(
            workspace_prefix + ".gsa"
        )
        if lcp is not None:
            # gLCP is the signed IntType in the reference (gsacak.h:44-58)
            np.asarray(lcp).astype(
                np.dtype("<i4") if workspace_dtype.itemsize == 4
                else np.dtype("<i8")
            ).tofile(workspace_prefix + ".glcp")

    sa_kept, gid, u, suf_len_kept, seg_start, _ = suffix_layout(
        dict_flat, w, occs, workspace=spill,
        small_hint=np.asarray(ilist).shape[0] < 2**31 - 8,
    )
    dict_flat = np.asarray(dict_flat, dtype=np.uint8)
    counts = np.asarray(occs).astype(np.int64)[u]
    S = sa_kept.shape[0]
    emis_end = np.cumsum(counts)  # per-suffix emission prefix (inclusive)
    total = int(emis_end[-1]) if S else 0
    if total != n + 1:
        die(f"emission count {total} != n+1 ({n + 1})")

    # group-aligned chunk boundaries: a chunk may only end where gid
    # changes (the global sort never crosses group boundaries)
    is_boundary = np.empty(S, dtype=bool)
    is_boundary[0] = True
    np.not_equal(gid[1:], gid[:-1], out=is_boundary[1:])
    boundaries = np.flatnonzero(is_boundary)  # suffix indices
    first = emis_end - counts
    spans = []
    s0 = 0
    while s0 < S:
        # furthest suffix whose emissions fit, then back off to a boundary
        s_fit = int(np.searchsorted(emis_end, first[s0] + chunk,
                                    side="right"))
        bpos = int(np.searchsorted(boundaries, s_fit, side="right")) - 1
        s1 = int(boundaries[bpos]) if bpos >= 0 else 0
        if s1 <= s0:
            # oversized group: take it whole (next boundary after s0)
            nb = int(np.searchsorted(boundaries, s0, side="right"))
            s1 = int(boundaries[nb]) if nb < boundaries.shape[0] else S
        spans.append((s0, s1))
        s0 = s1

    # the per-suffix state J3e reads: first slot, group, ilist segment
    # start and BWT-char flags, (whole word) << 8 | the byte before the
    # suffix, 0 at dict position 1 (the leading Dollar stands for the EOS)
    pos = sa_kept.astype(np.int64)
    prev = dict_flat[np.maximum(pos - 1, 0)].astype(np.int64)
    flags = np.where((pos == 0) | (prev <= 1), 256, 0) | np.where(
        pos > 1, prev, 0)
    t1 = time.perf_counter()
    info["layout_s"] = t1 - t0

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(dev)

    bwsai = (np.zeros(np.asarray(ilist).shape[0], np.int64) if bwsai is None
             else np.asarray(bwsai).astype(np.uint64).view(np.int64))
    st = {
        "first": put(first), "gid": put(gid), "seg_u": put(seg_start[u]),
        "flags": put(flags), "ls": put(suf_len_kept),
        "bwlast": torch.from_numpy(np.array(bwlast, dtype=np.uint8)).to(dev),
        "ilist": put(np.asarray(ilist).astype(np.int64)), "bwsai": put(bwsai),
    }
    del pos, prev, flags
    out = _ChunkWriter(bwt_fp, sa_fp, sa_dtype, want_rssa)
    bad_sum = torch.zeros((), dtype=torch.int64, device=dev)
    for s0, s1 in spans:
        base = int(first[s0])
        m = int(emis_end[s1 - 1]) - base
        bwt_d, sa_d, _, bad = _chunk_core(
            **st, s0=s0, s1=s1, base=base, m_true=m, n_text=n, chunk_b=m)
        bad_sum += bad
        out.put(base, bwt_d, sa_d)
    out.flush()
    nbad = int(bad_sum)
    info.update(chunks_s=time.perf_counter() - t1, n_chunks=len(spans))
    if nbad:
        die(f"streamed assembly invariant violation: {nbad} local gids "
            "exceed the chunk-local table")
    ssa, esa = out.runs.finish(total) if want_rssa else (None, None)
    return out.runs.nruns, ssa, esa
