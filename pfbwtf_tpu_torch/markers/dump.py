"""Human-readable dumps of binary outputs (scripts/readable_markers.py,
scripts/readable_sa.py, src/dump_markers.cpp equivalents) — used by the
diff-based e2e tests."""

from typing import Iterable

import numpy as np

from .marker import get_allele, get_pos, get_seq
from .mps import read_mps_runs


def readable_sa_lines(sa_path: str) -> Iterable[str]:
    vals = np.frombuffer(open(sa_path, "rb").read(), dtype=np.uint64)
    for v in vals:
        yield str(int(v))


def readable_markers_lines(ma_path: str) -> Iterable[str]:
    """Matches scripts/readable_markers.py: for each run [start, end] the
    LAST marker of the run is printed for every position (the script's loop
    overwrites `marker` per value — quirk preserved)."""
    starts, ends, markers = read_mps_runs(ma_path)
    for s, e, ms in zip(starts, ends, markers):
        if len(ms):
            m = ms[-1]
            seq, pos, ale = int(get_seq(m)), int(get_pos(m)), int(get_allele(m))
        else:
            seq = pos = ale = None
        for j in range(int(s), int(e) + 1):
            yield f"{j} {seq} {pos} {ale}"


def dump_markers_lines(path: str) -> Iterable[str]:
    """dump_markers CLI equivalent (src/dump_markers.cpp:18-30): one line
    per run with the decoded marker triples."""
    starts, ends, markers = read_mps_runs(path)
    for s, e, ms in zip(starts, ends, markers):
        decoded = " ".join(
            f"({int(get_seq(m))},{int(get_pos(m))},{int(get_allele(m))})"
            for m in ms
        )
        yield f"{int(s)} {int(e)}: {decoded}"
