"""MarkerT: a uint64 bit-packed (allele, seqid, refpos) triple.

Layout contract (marker.hpp:9-13): allele occupies 4 bits at 60, seqid 16
bits at 46, refpos 44 bits at 0.  Limits: <16 alleles, <65536 sequences,
pos < 2**44; out-of-range inputs truncate (masked), matching the reference's
set_* helpers (marker.hpp:15-37) — the unit tests pin that behavior.

All helpers are numpy-vectorized (work on scalars and arrays).
"""

import numpy as np

ALE_MASK = np.uint64(0xF000000000000000)
SEQ_MASK = np.uint64(0x0FFFF00000000000)
POS_MASK = np.uint64(0x00000FFFFFFFFFFF)
SEQ_SHIFT = np.uint64(46)
ALE_SHIFT = np.uint64(60)

DELIM = np.uint64(0xFFFFFFFFFFFFFFFF)


def _u64(x):
    return np.asarray(x).astype(np.uint64)


def set_pos(x, i):
    return (_u64(x) & ~POS_MASK) | (_u64(i) & POS_MASK)


def get_pos(x):
    return _u64(x) & POS_MASK


def set_seq(x, i):
    return ((_u64(i) & np.uint64(0xFFFF)) << SEQ_SHIFT) | (_u64(x) & ~SEQ_MASK)


def get_seq(x):
    return (_u64(x) & SEQ_MASK) >> SEQ_SHIFT


def set_allele(x, i):
    return ((_u64(i) & np.uint64(0xF)) << ALE_SHIFT) | (_u64(x) & ~ALE_MASK)


def get_allele(x):
    return (_u64(x) & ALE_MASK) >> ALE_SHIFT


def create_marker(pos, allele, seqid=0):
    """create_marker_t equivalent (marker.hpp:39-52)."""
    x = np.uint64(0)
    x = set_pos(x, pos)
    x = set_seq(x, seqid)
    x = set_allele(x, allele)
    return x
