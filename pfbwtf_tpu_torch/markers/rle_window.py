"""Sparse RLE interval map: position -> marker list.

The reference's rle_window_arr (rle_window_array.hpp:9-265) answers
``at(i)`` with rank/select over sd_vectors.  The array-native equivalent is
two sorted boundary arrays + ``np.searchsorted`` — same O(log n) per query,
but vectorizable over millions of queries at once, which is what the SA->MA
permute needs (write_marker_array feeds every SA value through ``at``).
"""

import struct
from typing import List

import numpy as np

from .mps import read_mps_runs

_RLWA_MAGIC = b"RLWA1\n"


class RleWindowArray:
    def __init__(self, mps_path_or_bytes):
        starts, ends, markers = read_mps_runs(mps_path_or_bytes)
        if starts.size and (
            np.any(starts[1:] <= starts[:-1]) or np.any(ends[1:] <= ends[:-1])
        ):
            raise ValueError("mps runs must be strictly increasing")
        self.starts = starts.astype(np.int64)
        self.ends = ends.astype(np.int64)
        self.markers = markers

    # -- serialize/load of the BUILT structure (rle_window_array.hpp:174-198
    # round-trips its sd_vectors; this is the array-native equivalent — own
    # compact format, since sdsl's on-disk layout is library-internal) -----

    def serialize(self, path_or_fp) -> int:
        """Write the built structure; returns bytes written."""
        fp = (
            open(path_or_fp, "wb")
            if isinstance(path_or_fp, (str, bytes))
            else path_or_fp
        )
        own = fp is not path_or_fp
        try:
            counts = np.fromiter(
                (len(m) for m in self.markers), dtype=np.int64,
                count=len(self.markers),
            )
            flat = (
                np.concatenate(
                    [np.asarray(m, dtype=np.uint64) for m in self.markers]
                )
                if len(self.markers)
                else np.zeros(0, np.uint64)
            )
            n = 0
            for chunk in (
                _RLWA_MAGIC,
                struct.pack("<q", self.starts.size),
                self.starts.tobytes(),
                self.ends.tobytes(),
                counts.tobytes(),
                struct.pack("<q", flat.size),
                flat.tobytes(),
            ):
                fp.write(chunk)
                n += len(chunk)
            return n
        finally:
            if own:
                fp.close()

    @classmethod
    def load(cls, path_or_fp) -> "RleWindowArray":
        fp = (
            open(path_or_fp, "rb")
            if isinstance(path_or_fp, (str, bytes))
            else path_or_fp
        )
        own = fp is not path_or_fp
        try:
            if fp.read(len(_RLWA_MAGIC)) != _RLWA_MAGIC:
                raise ValueError("not a serialized RleWindowArray")
            (nruns,) = struct.unpack("<q", fp.read(8))
            starts = np.frombuffer(fp.read(8 * nruns), dtype=np.int64)
            ends = np.frombuffer(fp.read(8 * nruns), dtype=np.int64)
            counts = np.frombuffer(fp.read(8 * nruns), dtype=np.int64)
            (nflat,) = struct.unpack("<q", fp.read(8))
            flat = np.frombuffer(fp.read(8 * nflat), dtype=np.uint64)
            obj = cls.__new__(cls)
            obj.starts = starts.copy()
            obj.ends = ends.copy()
            bounds = np.concatenate(([0], np.cumsum(counts)))
            obj.markers = [
                flat[bounds[i] : bounds[i + 1]].copy() for i in range(nruns)
            ]
            return obj
        finally:
            if own:
                fp.close()

    def run_index(self, pos) -> np.ndarray:
        """Vectorized: run id covering each position, or -1."""
        pos = np.asarray(pos, dtype=np.int64)
        idx = np.searchsorted(self.starts, pos, side="right") - 1
        safe = np.clip(idx, 0, max(len(self.starts) - 1, 0))
        ok = (idx >= 0) & (self.starts.size > 0)
        if self.starts.size:
            ok &= pos <= self.ends[safe]
        return np.where(ok, safe, -1)

    def at(self, pos) -> np.ndarray:
        """Marker list at a single position (rle_window_array.hpp:114-125)."""
        r = int(self.run_index(np.array([pos]))[0])
        if r < 0:
            return np.zeros(0, dtype=np.uint64)
        return np.asarray(self.markers[r], dtype=np.uint64)

    def at_range(self, s, e) -> np.ndarray:
        """All markers in runs overlapping [s, e]
        (rle_window_array.hpp:130-154)."""
        if not self.starts.size:
            return np.zeros(0, dtype=np.uint64)
        lo = np.searchsorted(self.ends, s, side="left")
        hi = np.searchsorted(self.starts, e, side="right")
        out: List[np.ndarray] = [
            np.asarray(self.markers[i], dtype=np.uint64) for i in range(lo, hi)
        ]
        if not out:
            return np.zeros(0, dtype=np.uint64)
        return np.concatenate(out)

    def content_ids(self) -> np.ndarray:
        """Dense id per run such that runs with identical marker lists share
        an id (used to coalesce across distinct runs in the SA->MA pass,
        mirroring write_marker_array's vec_eq, marker_array.hpp:149)."""
        seen = {}
        ids = np.empty(len(self.markers), dtype=np.int64)
        for i, m in enumerate(self.markers):
            key = np.asarray(m, dtype=np.uint64).tobytes()
            ids[i] = seen.setdefault(key, len(seen))
        return ids
