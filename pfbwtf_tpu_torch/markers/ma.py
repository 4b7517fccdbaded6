"""SA -> marker array (.ma) permute.

write_marker_array (marker_array.hpp:138-174) streams SA values one at a
time through rle_window_arr::at and RLE-writes runs of SA positions sharing
an identical (non-empty) marker list.  Vectorized: one searchsorted over
all SA values, content-id comparison for run boundaries, then a single pass
over the (few) emitted runs.  ``marker_array_from_sa`` is the host numpy
form; ``write_marker_array`` (mps_to_ma's core) and vcf_to_bwt run the
same permute on a device (markers/ma_dev.py) unless PFBWT_MA_BACKEND,
read at each call (``permute_sa``), is ``numpy``: only that value moves it
to the host, where pfbwtf_tpu's unset default is the host.
"""

import os

import numpy as np

from .mps import write_mps_runs
from .rle_window import RleWindowArray


def marker_array_from_sa(sa_values: np.ndarray, mai: RleWindowArray):
    """Returns (starts, ends, marker lists) over SA-index space.  An
    .mps with no runs gives no runs (pfbwtf_tpu's host permute raises an
    IndexError there; its device permute gives none)."""
    sa_values = np.asarray(sa_values, dtype=np.int64)
    if sa_values.shape[0] == 0 or not mai.starts.size:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64), []
    run_idx = mai.run_index(sa_values)
    content = mai.content_ids()
    # per-SA-position content id (-1 = empty list)
    cid = np.where(run_idx >= 0, content[np.clip(run_idx, 0, None)], -1)
    boundary = np.empty(cid.shape[0], dtype=bool)
    boundary[0] = True
    boundary[1:] = cid[1:] != cid[:-1]
    run_starts = np.flatnonzero(boundary)
    run_ends = np.concatenate((run_starts[1:] - 1, [cid.shape[0] - 1]))
    keep = cid[run_starts] >= 0
    starts = run_starts[keep].astype(np.uint64)
    ends = run_ends[keep].astype(np.uint64)
    # representative source run per output run (marker content equal by
    # construction of content ids)
    reps = run_idx[run_starts[keep]]
    markers = [np.asarray(mai.markers[int(r)], dtype=np.uint64) for r in reps]
    return starts, ends, markers


def permute_sa(sa_values, mai: RleWindowArray, device="cuda"):
    """The SA->MA permute on ``device``, or on the host when
    PFBWT_MA_BACKEND is ``numpy``: (starts, ends, marker lists)."""
    if os.environ.get("PFBWT_MA_BACKEND", "").lower() == "numpy":
        return marker_array_from_sa(sa_values, mai)
    from .ma_dev import marker_array_from_sa_dev

    return marker_array_from_sa_dev(sa_values, mai, device=device)


def write_marker_array(mps_fname: str, sa_source, output: str,
                       device="cuda"):
    """mps_to_ma CLI core: ``sa_source`` is a path to a .sa file (uint64),
    '-' for stdin, or a numpy array of SA values.  The permute's
    searchsorted and run coalescing run on ``device`` (``permute_sa``)."""
    import sys

    if isinstance(sa_source, str):
        if sa_source == "-":
            raw = sys.stdin.buffer.read()
        else:
            with open(sa_source, "rb") as f:
                raw = f.read()
        sa_values = np.frombuffer(raw, dtype=np.uint64)
    else:
        sa_values = np.asarray(sa_source, dtype=np.uint64)
    mai = RleWindowArray(mps_fname)
    starts, ends, markers = permute_sa(sa_values, mai, device=device)
    with open(output, "wb") as f:
        write_mps_runs(f, starts, ends, markers)
