"""Run-length bookkeeping of the streamed build's output (the -m mode,
file_wrappers.hpp role): the BWT and SA leave the device chunk by chunk,
and the .ssa/.esa samples are collected across the chunk boundaries.
Host numpy."""

import numpy as np


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
