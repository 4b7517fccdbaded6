"""The final BWT result as the host receives it, and the run-length
sampling that completes it on the host."""

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class BWTResult:
    bwt: np.ndarray  # uint8, n+1
    sa: Optional[np.ndarray]  # uint64, n+1 (first entry already = n)
    nruns: int
    ssa: Optional[np.ndarray] = None  # (pos, sample) pairs flattened
    esa: Optional[np.ndarray] = None


def bwt_result(bwtc: np.ndarray, sa: Optional[np.ndarray], want_sa: bool,
               want_rssa: bool, sa_dtype) -> BWTResult:
    """The host tail of a device assembly: the run count of ``bwtc`` and,
    from ``sa`` (uint64, first entry already n), the full SA and/or the
    (position, sample) pairs at run starts (.ssa) and run ends (.esa)."""
    total = bwtc.shape[0]
    run_start = np.empty(total, dtype=bool)
    run_start[0] = True
    np.not_equal(bwtc[1:], bwtc[:-1], out=run_start[1:])
    nruns = int(np.count_nonzero(run_start))
    ssa = esa = None
    if want_rssa:
        rs = np.flatnonzero(run_start)
        re = np.concatenate((rs[1:] - 1, [total - 1]))
        ssa = np.empty(2 * rs.shape[0], dtype=sa_dtype)
        ssa[0::2] = rs.astype(sa_dtype)
        ssa[1::2] = sa[rs].astype(sa_dtype)
        esa = np.empty(2 * re.shape[0], dtype=sa_dtype)
        esa[0::2] = re.astype(sa_dtype)
        esa[1::2] = sa[re].astype(sa_dtype)
    return BWTResult(bwt=bwtc, sa=sa if want_sa else None, nruns=nruns,
                     ssa=ssa, esa=esa)
